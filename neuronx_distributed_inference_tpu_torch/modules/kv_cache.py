"""Contiguous KV cache and KV quantisation (counterpart:
``neuronx_distributed_inference_tpu/modules/kv_cache.py`` — ``KVCacheSpec``
:46, ``cache_len_of`` :85, ``init_cache`` :109, ``init_mixed_cache`` :122,
``mixed_layer_map`` :142, ``fold_rolling_prefill`` :156, ``quantize_kv`` /
``dequantize_kv`` :183-197, ``write_tokens_at_layer`` :230,
``commit_chunk`` :284, ``write_prefill_at_layer`` :321, ``read_layer_hl``
:349, ``read_layer`` :357, ``gather_cache_rows`` :366, ``KVCacheManager``
:372).

The cache is a dict of two stacked tensors in the JAX package's layouts:
K TRANSPOSED ``(L, B, Hkv, D, S)`` and V ``(L, B, Hkv, S, Dv)``, where Dv
is ``KVCacheSpec.v_head_dim`` (MLA: 128 beside K's 192) and else D. Every
helper takes its widths from the tensors it is given. The JAX
functions return an updated cache (their buffers were donated); these
write IN PLACE and return the tensor they wrote, with the same drop
semantics:

  * a single-token write of at most 16 rows (the decode step) drops every
    position outside ``[0, S)``;
  * any other token write wraps a position in ``[-S, 0)`` onto ``S + p``
    (the scatter's index normalisation) and drops the rest;
  * ``commit_chunk`` keeps a row's old values for a whole chunk that would
    straddle the end.

Dropped positions are written as no-ops (a slot's own value, or the value
a live token of the same row writes there), so no write waits on the host
to filter them. The rows of one call are written at once: rows that share
a ``seq_id`` must carry the same values (the repad shim's copies of row 0
do).

Two layouts keep fewer slots than ``seq_len``:

  * the ROLLING cache (``KVCacheSpec.window`` > 0): ``window`` slots, a
    token at position p written at slot ``p % window``
    (``write_tokens_at_layer(window=)``); slot j then holds the latest
    position congruent to j (``ops.attention.rolling_decode_mask``);
  * the MIXED per-layer cache (:func:`init_mixed_cache`, alternating
    local / global stacks): ``{"k", "v"}`` hold the global layers' full
    rows, ``{"k_l", "v_l"}`` the local layers' rolling rows of
    ``window`` slots; :func:`mixed_layer_map` gives each layer its index
    within its own stack, and :func:`fold_rolling_prefill` turns a
    full-length prefill scratch into rolling rows."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class KVCacheSpec:
    num_layers: int
    batch_size: int
    max_seq_len: int
    num_kv_heads: int
    head_dim: int         # K head width (MLA: qk_nope + qk_rope)
    dtype: torch.dtype = torch.bfloat16
    window: int = 0       # > 0: a rolling cache of this many slots
    v_head_dim: Optional[int] = None   # MLA: V narrower than K (DeepSeek)

    @property
    def cache_len(self) -> int:
        return (min(self.max_seq_len, self.window) if self.window > 0
                else self.max_seq_len)

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.v_head_dim is not None else self.head_dim

    @property
    def k_shape(self) -> Tuple[int, ...]:
        # K stored transposed (L, B, H, D, S): adjacent keys are adjacent
        # in memory, so a warp reading one D-row over 32 keys is coalesced
        return (self.num_layers, self.batch_size, self.num_kv_heads,
                self.head_dim, self.cache_len)

    @property
    def v_shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.batch_size, self.num_kv_heads,
                self.cache_len, self.v_dim)


def cache_len_of(cache: Dict[str, torch.Tensor]) -> int:
    """Cache sequence capacity (V layout (L, B, H, S, D)); of the global
    stack in a mixed cache."""
    return cache["v"].shape[3]


def init_cache(spec: KVCacheSpec,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero-initialised {'k', 'v'} cache on ``device``."""
    return {"k": torch.zeros(spec.k_shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(spec.v_shape, dtype=spec.dtype, device=device)}


def init_mixed_cache(spec: KVCacheSpec, layer_pattern, window: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """The mixed per-layer cache: the global layers (``layer_pattern[i]``
    False) keep full rows in ``{"k", "v"}``, the local ones rolling rows
    of ``window`` slots in ``{"k_l", "v_l"}`` (each stack at least one
    layer deep, as the reference's)."""
    n_local = sum(bool(x) for x in layer_pattern)
    n_global = spec.num_layers - n_local
    cache = init_cache(dataclasses.replace(
        spec, num_layers=max(n_global, 1), window=0), device)
    local = init_cache(dataclasses.replace(
        spec, num_layers=max(n_local, 1), window=window), device)
    cache["k_l"], cache["v_l"] = local["k"], local["v"]
    return cache


def mixed_layer_map(layer_pattern) -> List[int]:
    """Absolute layer index -> index within its own (local / global)
    stack."""
    idx, n_l, n_g = [], 0, 0
    for is_local in layer_pattern:
        if is_local:
            idx.append(n_l)
            n_l += 1
        else:
            idx.append(n_g)
            n_g += 1
    return idx


def fold_rolling_prefill(scratch: torch.Tensor, seq_lens: torch.Tensor,
                         window: int,
                         k_transposed: bool = False) -> torch.Tensor:
    """A full-length prefill scratch (L', B, H, D, S) transposed-K or
    (L', B, H, S, D) in the rolling layout of ``window`` slots: slot j
    holds the latest position p <= seq_len - 1 with p % window == j;
    slots no position reaches are zero. Returns a new tensor."""
    s_axis = 4 if k_transposed else 3
    last = seq_lens.long() - 1                                   # (B,)
    j = torch.arange(window, device=scratch.device)
    q = last[:, None] - torch.remainder(last[:, None] - j[None, :],
                                        window)                  # (B, W)
    valid = q >= 0
    qc = q.clamp(0, scratch.shape[s_axis] - 1)
    if k_transposed:
        shape = scratch.shape[:4] + (window,)
        idx = qc[None, :, None, None, :].expand(shape)
        keep = valid[None, :, None, None, :]
    else:
        shape = scratch.shape[:3] + (window, scratch.shape[4])
        idx = qc[None, :, None, :, None].expand(shape)
        keep = valid[None, :, None, :, None]
    gathered = torch.gather(scratch, s_axis, idx)
    return torch.where(keep, gathered, torch.zeros_like(gathered))


def quantize_kv(x: torch.Tensor, dtype: torch.dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """KV quantisation on write: direct cast (scale None or 1.0) or scaled
    mode — store x / scale (in fp32) so the fp8 range covers the values."""
    if scale is not None and scale != 1.0:
        x = x.float() / scale
    return x.to(dtype)


def dequantize_kv(x: torch.Tensor, dtype: torch.dtype,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` on read."""
    if scale is not None and scale != 1.0:
        return (x.float() * scale).to(dtype)
    return x.to(dtype)


def _put_tokens(layer_view: torch.Tensor, new: torch.Tensor,
                rows: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor,
                k_transposed: bool):
    """layer_view (B, H, D, S) or (B, H, S, D); new (b, H, t, D); rows
    (b,), pos / valid (b, t). Writes ``new`` where valid. A dropped token
    of a row that writes some token is aimed at that row's first written
    slot with that token's value, so it can never overwrite a live write
    of the same call; in a row that writes nothing it rewrites the old
    value of a clamped slot."""
    s_max = layer_view.shape[3] if k_transposed else layer_view.shape[2]
    b, h = new.shape[:2]
    first = valid.int().argmax(dim=1, keepdim=True)             # (b, 1)
    has = valid.any(dim=1, keepdim=True)
    tgt = torch.where(valid, pos,
                      torch.where(has, pos.gather(1, first),
                                  pos.clamp(0, s_max - 1)))
    hidx = torch.arange(h, device=new.device)[None, :, None]
    r = rows.long()[:, None, None]
    p = tgt[:, None, :]
    if k_transposed:
        idx = (r, hidx, slice(None), p)        # advanced block -> (b,H,t,D)
    else:
        idx = (r, hidx, p)
    first_val = new[torch.arange(b, device=new.device), :, first[:, 0]]
    fill = torch.where(has[:, None, :, None], first_val[:, :, None, :],
                       layer_view[idx])
    layer_view[idx] = torch.where(valid[:, None, :, None], new, fill)


def write_tokens_at_layer(cache: torch.Tensor, new: torch.Tensor, layer: int,
                          seq_ids: torch.Tensor, positions: torch.Tensor,
                          window: int = 0,
                          k_transposed: bool = False) -> torch.Tensor:
    """In-place token write into the stacked cache at ``layer``. new
    (b, t, H, D) in the projection layout; seq_ids (b,); positions (b, t).
    ``window`` > 0: the rolling write at ``positions % window`` (taken on
    the device, the modulo of the reference: a negative position wraps
    too). Drop semantics as the module docstring says."""
    b, t = new.shape[:2]
    s_max = cache.shape[4] if k_transposed else cache.shape[3]
    pos = positions.long()
    if window > 0:
        pos = torch.remainder(pos, window)
    if not (t == 1 and b <= 16):
        pos = torch.where(pos < 0, pos + s_max, pos)
    valid = (pos >= 0) & (pos < s_max)
    _put_tokens(cache[layer], new.to(cache.dtype).transpose(1, 2), seq_ids,
                pos, valid, k_transposed)
    return cache


def commit_chunk(cache: torch.Tensor, side: torch.Tensor,
                 seq_ids: torch.Tensor, start_positions: torch.Tensor,
                 k_transposed: bool = False) -> torch.Tensor:
    """Commit a decode chunk's side buffer into the big cache in place.
    cache (L, B, H, D, S) transposed-K or (L, B, H, S, D); side (L, b, H,
    D, C) / (L, b, H, C, D); start_positions (b,): row i's chunk covers
    [start, start + C). A row whose chunk would straddle the end keeps its
    OLD values for the whole chunk."""
    c = side.shape[4] if k_transposed else side.shape[3]
    s_max = cache.shape[4] if k_transposed else cache.shape[3]
    start = start_positions.long()
    valid = (start >= 0) & (start <= s_max - c)
    pos = start.clamp(0, s_max - c)[:, None] + torch.arange(
        c, device=start.device)[None, :]                      # (b, C)
    rows = seq_ids.long()[:, None]
    if k_transposed:
        idx = (slice(None), rows, slice(None), slice(None), pos)
        upd = side.permute(1, 4, 0, 2, 3)                      # (b,C,L,H,D)
    else:
        idx = (slice(None), rows, slice(None), pos)
        upd = side.permute(1, 3, 0, 2, 4)
    old = cache[idx]                                           # (b,C,L,H,D)
    cache[idx] = torch.where(valid[:, None, None, None, None],
                             upd.to(cache.dtype), old)
    return cache


def write_prefill_at_layer(cache: torch.Tensor, new: torch.Tensor,
                           layer: int, seq_ids: torch.Tensor,
                           identity_seq_ids: bool = False,
                           k_transposed: bool = False) -> torch.Tensor:
    """Stacked-cache prefill write of a window at slots [0, s) of rows
    ``seq_ids``. identity_seq_ids=True (seq_ids == arange over the whole
    cache batch) takes the block-copy fast path instead of the per-token
    scatter."""
    b, s = new.shape[:2]
    if identity_seq_ids and b == cache.shape[1]:
        if k_transposed:
            cache[layer, :, :, :, :s] = new.permute(0, 2, 3, 1)
        else:
            cache[layer, :, :, :s] = new.transpose(1, 2)
        return cache
    pos = torch.arange(s, device=new.device)[None, :].expand(b, s)
    return write_tokens_at_layer(cache, new, layer, seq_ids, pos,
                                 k_transposed=k_transposed)


def read_layer_hl(cache: torch.Tensor, layer: int) -> torch.Tensor:
    """One layer of the stacked cache in its native head-leading layout
    (a view)."""
    return cache[layer]


def read_layer(cache: torch.Tensor, layer: int) -> torch.Tensor:
    """One V-layout layer as (B, S, H, D) (a view)."""
    return cache[layer].transpose(1, 2)


def gather_cache_rows(cache_layer: torch.Tensor,
                      seq_ids: torch.Tensor) -> torch.Tensor:
    """The batch rows of the running requests (continuous batching)."""
    return cache_layer[seq_ids.long()]


class KVCacheManager:
    """Host-side owner of one contiguous cache."""

    def __init__(self, spec: KVCacheSpec, device: torch.device):
        self.spec = spec
        self.cache = init_cache(spec, device)

    def reset(self):
        for x in self.cache.values():
            x.zero_()

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.cache.values())
