"""Ragged paged decode attention (counterpart:
``neuronx_distributed_inference_tpu/ops/decode_attention.py`` — the Pallas
kernel ``_paged_kernel`` and its wrapper ``paged_decode_attention``
:336-518, ``supports`` :588, ``quantized_cache_ok`` :599).

One query token per row: each KV head's GQA group attends over the row's
prior tokens ``[0, lens[b])``, read from the stacked page cache
``(L, N, Bs, Hkv, D)`` through ``block_table[b, j]``, plus the active token
(``new_k``/``new_v``, never read from the cache — the caller has already
written it there, and the strict ``kpos < lens`` mask keeps it out).
Options: a dynamic sliding ``window`` (0 = none), tanh ``soft_cap``, a
per-head ``sink`` entering the softmax denominator only, and ``kv_scale``
dequantisation of the pages on load.

On a CUDA tensor :func:`paged_decode_attention` launches the hand-written
Hopper kernel ``csrc/paged_decode_attention.cu`` (its header says what
bounds it on the H100 and what the design does about that); on a CPU
tensor it runs :func:`paged_decode_attention_plain`, the plain-PyTorch
twin of the same math. There is no fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

NEG_INF = -2.3819763e38      # finite: the online softmax never sees inf-inf

KERNEL_NAME = "paged_decode_attention"
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_ACT_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
MAX_GROUP = 16               # query heads per KV head the kernel takes
_TARGET_BLOCKS = 8 * 132     # split-K blocks: eight per H100 SM
_MAX_SPLITS = 64             # the combine kernel's shared-memory bound


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, new_k: torch.Tensor,
                                 new_v: torch.Tensor, layer: int,
                                 lens: torch.Tensor,
                                 block_table: torch.Tensor, *, scale: float,
                                 window: int = 0,
                                 soft_cap: Optional[float] = None,
                                 sink: Optional[torch.Tensor] = None,
                                 kv_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain-PyTorch twin: gather the row's pages, mask ``kpos < lens[b]``
    (and ``lens[b] - kpos < window`` when ``window > 0``), fold in the
    active token, soft-cap and sink, softmax in fp32."""
    b, hq, d = q.shape
    _, _, bs, hkv, _ = k_pages.shape
    mb = block_table.shape[1]
    g = hq // hkv
    tbl = block_table.long()
    k = k_pages[layer][tbl].reshape(b, mb * bs, hkv, d).float()
    v = v_pages[layer][tbl].reshape(b, mb * bs, hkv, d).float()
    if kv_scale is not None:
        k = k * kv_scale
        v = v * kv_scale
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k) * scale
    sa = torch.einsum("bhgd,bhd->bhg", qf, new_k.float())[..., None] * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
        sa = soft_cap * torch.tanh(sa / soft_cap)
    kpos = torch.arange(mb * bs, device=q.device)[None, :]
    pos = lens.long()[:, None]
    valid = kpos < pos
    if window > 0:
        valid &= (pos - kpos) < window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    cols = [s, sa]
    if sink is not None:
        cols.append(sink.float().reshape(1, hkv, g, 1).expand(b, hkv, g, 1))
    scores = torch.cat(cols, dim=-1)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    n = mb * bs
    out = torch.einsum("bhgs,bshd->bhgd", p[..., :n], v)
    out = out + p[..., n:n + 1] * new_v.float()[:, :, None, :]
    return out.reshape(b, hq, d).to(q.dtype)


def _check_inputs(q, k_pages, v_pages, new_k, new_v, layer, lens,
                  block_table, sink):
    """Raise on anything the kernel (and so the twin's contract) does not
    take: wrong rank, dtype, shape, device or layout."""
    if q.dim() != 3 or k_pages.dim() != 5:
        raise ValueError("q must be (B, Hq, D) and pages (L, N, Bs, Hkv, D)")
    b, hq, d = q.shape
    L, _, _, hkv, dp = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if dp != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS} and match "
                         f"the pages (q {d}, pages {dp})")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv} with at "
                         f"most {MAX_GROUP} query heads per KV head")
    if q.dtype not in _ACT_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {_ACT_DTYPES}")
    if k_pages.dtype not in _PAGE_DTYPES:
        raise ValueError(f"page dtype {k_pages.dtype} not in "
                         f"{tuple(_PAGE_DTYPES)}")
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        if t.shape != (b, hkv, d) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be (B, Hkv, D) = {(b, hkv, d)} "
                             f"in q's dtype {q.dtype}")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError("lens must be (B,) int32")
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.dtype != torch.int32):
        raise ValueError("block_table must be (B, max_blocks) int32")
    if sink is not None and (sink.shape != (hq,)
                             or sink.dtype != torch.float32):
        raise ValueError("sink must be (Hq,) float32")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside the {L} cached layers")
    tensors = [q, k_pages, v_pages, new_k, new_v, lens, block_table]
    if sink is not None:
        tensors.append(sink)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _kernel_fn():
    fn = _build.load(KERNEL_NAME).nxdi_paged_decode_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 11 + [i] * 10 + [f] * 3 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def num_splits(batch: int, hkv: int, max_blocks: int, block_size: int,
               head_dim: int) -> int:
    """Blocks per (row, KV head) of the split-K kernel: enough for about
    eight blocks on each of the H100's 132 SMs (a long row then gives each
    block about one tile), and no more than the table has key tiles
    (4096 / head_dim keys each), nor than 64. From shapes only, so the
    wrapper never waits on the device for ``lens``."""
    tiles = -(-max_blocks * block_size // (4096 // head_dim))
    want = -(-_TARGET_BLOCKS // (batch * hkv))
    return max(1, min(want, tiles, _MAX_SPLITS))


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, layer: int,
                           lens: torch.Tensor, block_table: torch.Tensor, *,
                           scale: float, window: int = 0,
                           soft_cap: Optional[float] = None,
                           sink: Optional[torch.Tensor] = None,
                           kv_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k_pages/v_pages (L, N, Bs, Hkv, D); new_k/new_v
    (B, Hkv, D); ``layer`` python int; lens (B,) int32 prior lengths;
    block_table (B, max_blocks) int32 (entry 0 = null page). Returns
    (B, Hq, D) in q's dtype.

    CUDA tensors launch the Hopper kernel on the current stream and add one
    to ``paged_decode_attention.launches``; CPU tensors run the plain twin.
    The caller keeps ``lens[b]`` within the row's table (the kernel indexes
    ``block_table[b, kpos // Bs]`` for every live ``kpos``)."""
    _check_inputs(q, k_pages, v_pages, new_k, new_v, layer, lens,
                  block_table, sink)
    kw = dict(scale=scale, window=int(window), soft_cap=soft_cap, sink=sink,
              kv_scale=kv_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, new_k,
                                            new_v, int(layer), lens,
                                            block_table, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the kernel reads pages in 16-byte vectors: "
                         "k_pages/v_pages must be 16-byte aligned")
    b, hq, d = q.shape
    _, n_pages, bs, hkv, _ = k_pages.shape
    g, mb = hq // hkv, block_table.shape[1]
    splits = num_splits(b, hkv, mb, bs, d)
    out = torch.empty_like(q)
    # split-K scratch: acc (B, Hkv, splits, G, D), then (m, l) per head
    n_acc = b * hkv * splits * g * d
    scratch = torch.empty(n_acc + 2 * n_acc // d, dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            new_k.data_ptr(), new_v.data_ptr(), lens.data_ptr(),
            block_table.data_ptr(),
            sink.data_ptr() if sink is not None else None,
            scratch.data_ptr(), scratch.data_ptr() + 4 * n_acc,
            out.data_ptr(),
            b, int(layer), n_pages, bs, hkv, g, d, mb, splits, int(window),
            float(scale), float(soft_cap) if soft_cap is not None else 0.0,
            float(kv_scale) if kv_scale is not None else 1.0,
            _PAGE_DTYPES[k_pages.dtype], int(q.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(cudaError {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def supports(spec, phase_t: int) -> bool:
    """Kernel admission (counterpart: decode_attention.py:588): a single
    active token, head_dim 64 or 128, and at most ``MAX_GROUP`` query heads
    per KV head (the kernel keeps a group's accumulators in registers)."""
    return (phase_t == 1 and spec.head_dim in _HEAD_DIMS
            and spec.gqa.q_per_kv <= MAX_GROUP)


def quantized_cache_ok(cache_dtype: torch.dtype) -> bool:
    """Page dtypes the kernel streams (counterpart: the Mosaic probe at
    decode_attention.py:599; on sm_90 it is a plain dtype check)."""
    return cache_dtype in _PAGE_DTYPES
