"""Dense decoder over the contiguous and the paged KV cache (counterpart:
``neuronx_distributed_inference_tpu/models/model_base.py`` — ``DecoderSpec``
:98, ``pad_vocab`` :350, the parameter specs :360-590, ``fuse_qkv_host``
:618, ``attn_inputs`` :720, ``_layer_body`` :753, the dense ``_mlp_block``
:889, ``_attn_block`` :943-1280 (paged :1058-1103, prefill :1104-1156,
decode :1157-1272), ``run_layers`` :1296 / ``run_layer_slice`` :1414,
``_embed`` :1656, ``_lm_head`` :1671, ``context_encoding_step`` :1686,
``token_generation_step`` :1789, ``paged_forward_step`` :1883,
``decode_loop`` :1939, ``paged_decode_loop`` :2058, ``paged_ragged_step``
:2222, ``spec_from_config`` :2346).

The model is a set of plain functions over a dict of parameter tensors
laid out as the JAX package's tree (stacked ``(L, …)`` layer leaves, fused
``qkv_proj``, vocabulary padded to a multiple of 128), so a JAX parameter
tree converts by renaming (``utils/jax_params.py``). The JAX ``lax.scan``
loops (over layers, over decode steps) are Python loops; the KV cache is
written IN PLACE (the JAX graphs donated it).

Attention, by phase:

  * ``prefill`` (contiguous): the causal flash kernel when the spec asks
    for it (``attn_kernel_enabled``) and :func:`ops.flash_attention.supports`
    admits the bucket, else the masked ``mha``; then the window is written
    into the cache;
  * ``decode`` (contiguous): the step's K/V are written first; the
    contiguous decode kernel runs under the rule of model_base.py:1175-1197
    (static batch over the whole cache, no side buffer, on by default only
    for sliding-window models), else the layer is read in its native
    layout (``read_layer_hl``, cut to ``kv_view``; rows gathered under
    continuous batching) into ``mha_hl``, or ``mha_decode_merged`` with the
    chunked side buffer of :func:`decode_loop`;
  * ``paged``: the step's K/V are written at ``slot_mapping``; a
    single-token step runs the paged decode kernel (the rule of
    model_base.py:1071-1077), every other step gathers the block table
    into contiguous K/V for the masked ``mha``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import InferenceConfig, TpuConfig
from ..modules import block_kv_cache as bkv
from ..modules import kv_cache as kv
from ..ops import attention as attn_ops
from ..ops import decode_attention, flash_attention
from ..ops import sampling as sampling_ops
from ..ops.normalization import rms_norm
from ..ops.rope import (SUPPORTED_SCALING, RopeConfig, apply_rope,
                        compute_inv_freq, rope_cos_sin)
from ..parallel.layers import GQASharding, ParamSpec, resolve_gqa_sharding
from ..resilience.errors import ConfigurationError


@dataclass(frozen=True)
class DecoderSpec:
    """Static architecture of the dense Llama-shaped decoder, resolved
    from an InferenceConfig (the fields of the counterpart that this path
    reads)."""

    num_layers: int
    hidden_size: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int
    padded_vocab: int
    rms_eps: float
    rope: RopeConfig
    gqa: GQASharding
    tie_word_embeddings: bool = False
    sliding_window: int = 0              # 0 = full attention
    attn_scale: Optional[float] = None   # None => head_dim ** -0.5
    # flash prefill kernel: True = on where flash_attention.supports() holds
    flash_prefill: bool = False
    # decode kernels: None = default admission, True = always where
    # supports() holds, False = never
    decode_kernel: Optional[bool] = None
    dtype: torch.dtype = torch.bfloat16
    kv_dtype: torch.dtype = torch.bfloat16
    # scaled KV quantisation: values stored as x / kv_scale
    kv_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return (self.attn_scale if self.attn_scale is not None
                else self.head_dim ** -0.5)

    @property
    def q_size(self) -> int:
        return self.gqa.num_q_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.gqa.num_kv_heads * self.head_dim


def pad_vocab(vocab: int, tp: int = 1, multiple: int = 128) -> int:
    m = max(tp, 1) * multiple
    return -(-vocab // m) * m


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def decoder_param_specs(spec: DecoderSpec) -> Dict[str, Any]:
    """Shapes of the parameter tree: the counterpart's tree for a dense
    model with fused qkv."""
    L, H, I = spec.num_layers, spec.hidden_size, spec.intermediate_size
    dt = spec.dtype
    out: Dict[str, Any] = {
        "embed": ParamSpec((spec.padded_vocab, H), dt),
        "final_norm": ParamSpec((H,), dt, "ones"),
        "layers": {
            "input_norm": ParamSpec((L, H), dt, "ones"),
            "post_norm": ParamSpec((L, H), dt, "ones"),
            "qkv_proj": ParamSpec((L, H, spec.q_size + 2 * spec.kv_size),
                                  dt),
            "o_proj": ParamSpec((L, spec.q_size, H), dt),
            "gate_proj": ParamSpec((L, H, I), dt),
            "up_proj": ParamSpec((L, H, I), dt),
            "down_proj": ParamSpec((L, I, H), dt),
        },
    }
    if not spec.tie_word_embeddings:
        out["lm_head"] = ParamSpec((H, spec.padded_vocab), dt)
    return out


def init_params(spec: DecoderSpec, seed: int,
                device: torch.device) -> Dict[str, Any]:
    """Random weights made on ``device`` from one ``torch.Generator``
    seeded with ``seed`` (normal(0, 0.02) matrices, unit norms). They are
    not the JAX package's values for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(node):
        if isinstance(node, ParamSpec):
            return node.initializer(gen, device)
        return {k: build(v) for k, v in sorted(node.items())}
    return build(decoder_param_specs(spec))


def fuse_qkv_host(host: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse per-projection q/k/v host weights (as the family converter
    emits them, matching the checkpoint) into the stacked ``qkv_proj``."""
    d = host.get("layers")
    if isinstance(d, dict) and {"q_proj", "k_proj", "v_proj"} <= set(d):
        d["qkv_proj"] = np.concatenate(
            [np.asarray(d.pop("q_proj")), np.asarray(d.pop("k_proj")),
             np.asarray(d.pop("v_proj"))], axis=-1)
    return host


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def attn_inputs(spec: DecoderSpec, position_ids: torch.Tensor,
                inv_freq: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """RoPE cos/sin for the step; each phase adds its mask or kernel
    inputs."""
    cos, sin = rope_cos_sin(position_ids, spec.rope, inv_freq)
    return {"cos": cos, "sin": sin}


def _qkv(spec: DecoderSpec, h, layer_w, ai):
    """Fused projection, head split and RoPE: q (B,T,Hq,D), k/v
    (B,T,Hkv,D) (v a view into the projection output)."""
    b, t, _ = h.shape
    g = spec.gqa
    qkv = h @ layer_w["qkv_proj"]
    q, k, v = torch.split(qkv, [spec.q_size, spec.kv_size, spec.kv_size],
                          dim=-1)
    q = apply_rope(q.reshape(b, t, g.num_q_heads, spec.head_dim),
                   ai["cos"], ai["sin"])
    k = apply_rope(k.reshape(b, t, g.num_kv_heads, spec.head_dim),
                   ai["cos"], ai["sin"])
    return q, k, v.reshape(b, t, g.num_kv_heads, spec.head_dim)


def _paged_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai):
    """Paged branch (model_base.py:1058-1103): write at ``slot_mapping``,
    then the paged kernel or the block-table gather + ``mha``."""
    kc, vc = cache["k"], cache["v"]
    bkv.write_slots_at_layer(kc, kv.quantize_kv(k, kc.dtype, spec.kv_scale),
                             li, ai["slot_mapping"])
    bkv.write_slots_at_layer(vc, kv.quantize_kv(v, vc.dtype, spec.kv_scale),
                             li, ai["slot_mapping"])
    if ai["use_kernel"]:
        # the step's own token was just written, but the kernel masks
        # kpos < lens strictly and folds the token in from new_k/new_v
        return decode_attention.paged_decode_attention(
            q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
            v[:, 0].contiguous(), li, ai["lens"], ai["block_table"],
            scale=spec.scale, window=spec.sliding_window,
            kv_scale=spec.kv_scale)[:, None]
    bt = ai["block_table"]
    k_all = kv.dequantize_kv(bkv.gather_block_kv(bkv.read_layer(kc, li), bt),
                             q.dtype, spec.kv_scale)
    v_all = kv.dequantize_kv(bkv.gather_block_kv(bkv.read_layer(vc, li), bt),
                             q.dtype, spec.kv_scale)
    return attn_ops.mha(q, k_all, v_all, ai["mask"], spec.scale)


def _prefill_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai):
    """Contiguous prefill branch (model_base.py:1104-1156): attend within
    the window (flash kernel or masked ``mha``), then write the window
    into the cache rows ``seq_ids``."""
    if ai["flash"]:
        out = flash_attention.flash_attention(q, k, v, scale=spec.scale,
                                              window=spec.sliding_window)
    else:
        out = attn_ops.mha(q, k, v, ai["mask"], spec.scale)
    for name, x, kt in (("k", k, True), ("v", v, False)):
        c = cache[name]
        kv.write_prefill_at_layer(
            c, kv.quantize_kv(x, c.dtype, spec.kv_scale), li, ai["seq_ids"],
            identity_seq_ids=ai["identity"], k_transposed=kt)
    return out


def _decode_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai):
    """Contiguous decode branch (model_base.py:1157-1272). Returns the
    attention output and, under the chunked side buffer, the step's
    (k, v) for the end-of-step side write."""
    kc, vc = cache["k"], cache["v"]
    side = ai.get("side")
    if side is None:
        kv.write_tokens_at_layer(kc, kv.quantize_kv(k, kc.dtype,
                                                    spec.kv_scale),
                                 li, ai["seq_ids"], ai["positions"],
                                 k_transposed=True)
        kv.write_tokens_at_layer(vc, kv.quantize_kv(v, vc.dtype,
                                                    spec.kv_scale),
                                 li, ai["seq_ids"], ai["positions"])
    if ai["use_kernel"]:
        # the cache row just written is masked out (kpos < pos); the
        # active token is folded in from registers
        out = decode_attention.decode_attention_stacked(
            q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
            v[:, 0].contiguous(), li, ai["lens"], scale=spec.scale,
            window=spec.sliding_window, kv_scale=spec.kv_scale)[:, None]
        return out, None
    view = ai.get("kv_view")
    k_layer = kv.read_layer_hl(kc, li)                 # (B, H, D, S)
    v_layer = kv.read_layer_hl(vc, li)                 # (B, H, S, D)
    if view is not None and view < vc.shape[3]:
        k_layer = k_layer[..., :view]
        v_layer = v_layer[:, :, :view]
    if not (ai["identity"] and q.shape[0] == kc.shape[1]):
        k_layer = kv.gather_cache_rows(k_layer, ai["seq_ids"])
        v_layer = kv.gather_cache_rows(v_layer, ai["seq_ids"])
    k_all = kv.dequantize_kv(k_layer, q.dtype, spec.kv_scale)
    v_all = kv.dequantize_kv(v_layer, q.dtype, spec.kv_scale)
    if side is not None:
        out = attn_ops.mha_decode_merged(
            q, k_all, v_all, ai["mask"], side[0][li], side[1][li],
            ai["mask_side"], k.to(q.dtype), v.to(q.dtype), spec.scale)
        return out, (k, v)
    return attn_ops.mha_hl(q, k_all, v_all, ai["mask"], spec.scale), None


def _mlp_block(x, layer_w):
    """Dense GLU MLP: silu(x @ gate) * (x @ up) @ down."""
    inter = F.silu(x @ layer_w["gate_proj"]) * (x @ layer_w["up_proj"])
    return inter @ layer_w["down_proj"]


def _layer_body(spec: DecoderSpec, hidden, layer_w, cache, li: int, ai,
                phase: str):
    """One pre-norm transformer layer; returns (hidden, pending side
    write or None)."""
    h = rms_norm(hidden, layer_w["input_norm"], spec.rms_eps)
    q, k, v = _qkv(spec, h, layer_w, ai)
    pending = None
    if phase == "decode":
        attn, pending = _decode_attn(spec, q, k, v, cache, li, ai)
    elif phase == "prefill":
        attn = _prefill_attn(spec, q, k, v, cache, li, ai)
    else:
        attn = _paged_attn(spec, q, k, v, cache, li, ai)
    b, t = h.shape[:2]
    hidden = hidden + attn.reshape(b, t, -1) @ layer_w["o_proj"]
    h = rms_norm(hidden, layer_w["post_norm"], spec.rms_eps)
    return hidden + _mlp_block(h, layer_w), pending


def run_layers(spec: DecoderSpec, params, cache, hidden, ai, phase: str):
    """The layer loop (the counterpart scans stacked weights with
    ``lax.scan``; here each layer's weights are views into the stacks).
    Under the chunked side buffer (``ai["side"]``), every layer's step
    K/V land in the side buffers at ``ai["chunk_idx"]`` once the whole
    step has read them (model_base.py:1459-1472)."""
    stacks = params["layers"]
    pend = []
    for i in range(spec.num_layers):
        layer_w = {k: w[i] for k, w in stacks.items()}
        hidden, pending = _layer_body(spec, hidden, layer_w, cache, i, ai,
                                      phase)
        pend.append(pending)
    side = ai.get("side")
    if side is not None:
        idx = ai["chunk_idx"]
        sk, sv = side
        sk[..., idx] = torch.stack([p[0][:, 0] for p in pend]).to(sk.dtype)
        sv[:, :, :, idx] = torch.stack([p[1][:, 0] for p in pend]).to(
            sv.dtype)
    return hidden


def _embed(params, input_ids):
    return params["embed"][input_ids.long()]


def _lm_head(spec: DecoderSpec, params, hidden):
    h = rms_norm(hidden, params["final_norm"], spec.rms_eps)
    w = (params["embed"].t() if spec.tie_word_embeddings
         else params["lm_head"])
    logits = (h @ w).float()
    return sampling_ops.mask_padded_logits(
        logits, spec.padded_vocab - spec.vocab_size)


def _cache_ok(spec: DecoderSpec, cache_dtype: torch.dtype) -> bool:
    return (cache_dtype == spec.dtype
            or decode_attention.quantized_cache_ok(cache_dtype))


# ---------------------------------------------------------------------------
# Contiguous steps
# ---------------------------------------------------------------------------

def use_flash_prefill(spec: DecoderSpec, bucket: int) -> bool:
    """The prefill branch's kernel gate (model_base.py:1111-1118; the
    layer-pattern, sink, alibi, MLA, CP and SP conditions are refused at
    spec time, and the contiguous prefill always feeds arange
    positions)."""
    return spec.flash_prefill and flash_attention.supports(
        bucket, spec.head_dim, has_sink=False, chunk=0)


def use_contiguous_decode_kernel(spec: DecoderSpec, phase_t: int,
                                 batch: int, cache,
                                 identity_seq_ids: bool,
                                 side: bool = False) -> bool:
    """The decode branch's kernel admission, model_base.py:1175-1197: no
    side buffer, not disabled, supported geometry, static batch over the
    whole cache, a cache dtype the kernel streams; by default on only for
    sliding-window models (the port runs no sink or layer pattern)."""
    use = (not side and spec.decode_kernel is not False
           and decode_attention.supports(spec, phase_t)
           and identity_seq_ids and batch == cache["k"].shape[1]
           and _cache_ok(spec, cache["k"].dtype))
    if use and spec.decode_kernel is None:
        use = spec.sliding_window > 0
    return use


def _sample_out(spec: DecoderSpec, tpu_cfg: TpuConfig, params, hidden,
                last_h, sampling_params, generator):
    out = {}
    if tpu_cfg.output_logits:
        out["logits"] = _lm_head(spec, params, hidden)[..., :spec.vocab_size]
    logits = _lm_head(spec, params, last_h)[:, 0, :]
    out["tokens"] = sampling_ops.sample(
        logits, tpu_cfg.on_device_sampling_config, sampling_params,
        generator)
    return out


def context_encoding_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                          cache, input_ids, position_ids, seq_ids, seq_lens,
                          sampling_params=None, generator=None,
                          inv_freq: Optional[torch.Tensor] = None):
    """Prefill (model_base.py:1686). input_ids/position_ids (B, S_bucket)
    right-padded with arange positions; seq_ids (B,) cache rows; seq_lens
    (B,) true lengths. Writes the cache in place; returns {"tokens": (B,)}
    plus {"logits": (B, S_bucket, vocab)} when ``output_logits``."""
    s = input_ids.shape[1]
    ai = attn_inputs(spec, position_ids, inv_freq)
    ai["flash"] = use_flash_prefill(spec, s)
    if not ai["flash"]:
        # padded positions attend causally to themselves: harmless, their
        # outputs are discarded
        ai["mask"] = attn_ops.prefill_causal_mask(position_ids,
                                                  spec.sliding_window)
    ai["seq_ids"] = seq_ids
    ai["identity"] = not tpu_cfg.is_continuous_batching
    hidden = run_layers(spec, params, cache, _embed(params, input_ids), ai,
                        "prefill")
    idx = (seq_lens.long() - 1).clamp(min=0)[:, None, None].expand(
        -1, 1, hidden.shape[-1])
    return _sample_out(spec, tpu_cfg, params, hidden,
                       torch.gather(hidden, 1, idx), sampling_params,
                       generator)


def _decode_inputs(spec: DecoderSpec, tpu_cfg: TpuConfig, cache,
                   position_ids, seq_ids, kv_view, inv_freq, side=None):
    identity = not tpu_cfg.is_continuous_batching
    ai = attn_inputs(spec, position_ids, inv_freq)
    ai.update(seq_ids=seq_ids, positions=position_ids, identity=identity,
              kv_view=kv_view, side=side)
    ai["use_kernel"] = use_contiguous_decode_kernel(
        spec, position_ids.shape[1], position_ids.shape[0], cache, identity,
        side is not None)
    if ai["use_kernel"]:
        ai["lens"] = position_ids[:, 0].to(torch.int32).contiguous()
    else:
        ai["mask"] = attn_ops.decode_mask(
            position_ids, kv_view or kv.cache_len_of(cache),
            spec.sliding_window)
    return ai


def token_generation_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                          cache, input_ids, position_ids, seq_ids,
                          sampling_params=None, generator=None,
                          kv_view: Optional[int] = None,
                          inv_freq: Optional[torch.Tensor] = None):
    """Decode (model_base.py:1789). input_ids/position_ids (B, T); seq_ids
    (B,) cache rows. ``kv_view``: the gather path reads only cache slots
    [0, kv_view); writes address the whole cache. Writes the cache in
    place; returns {"tokens": (B,)} plus {"logits": (B, T, vocab)}."""
    ai = _decode_inputs(spec, tpu_cfg, cache, position_ids, seq_ids,
                        kv_view, inv_freq)
    hidden = run_layers(spec, params, cache, _embed(params, input_ids), ai,
                        "decode")
    return _sample_out(spec, tpu_cfg, params, hidden, hidden[:, -1:],
                       sampling_params, generator)


def decode_loop(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                first_tokens, position_ids, seq_ids, sampling_params=None,
                generator=None, num_steps: int = 1,
                kv_view: Optional[int] = None,
                inv_freq: Optional[torch.Tensor] = None):
    """``num_steps`` decode steps with the tokens kept on the device
    (model_base.py:1939). first_tokens/position_ids (B,). Returns
    {"tokens": (B, num_steps)}.

    Full-attention models under a static batch over the whole cache take
    the chunked side-buffer branch (:1964-2038): the big cache is only
    read during the chunk; each step's K/V go to small side buffers,
    committed with ``commit_chunk`` once at the end. Everything else steps
    through :func:`token_generation_step`."""
    b = first_tokens.shape[0]
    no_logits = dataclasses.replace(tpu_cfg, output_logits=False)
    chunkable = (num_steps > 1 and not tpu_cfg.is_continuous_batching
                 and b == cache["k"].shape[1]
                 and spec.decode_kernel is not True
                 and not spec.sliding_window > 0)
    tok, pos = first_tokens, position_ids.long()
    toks = []
    if not chunkable:
        for _ in range(num_steps):
            tok = token_generation_step(
                spec, no_logits, params, cache, tok[:, None], pos[:, None],
                seq_ids, sampling_params, generator, kv_view,
                inv_freq)["tokens"]
            toks.append(tok)
            pos = pos + 1
        return {"tokens": torch.stack(toks, dim=1)}

    c = num_steps
    g = spec.gqa
    dev = first_tokens.device
    sk = torch.zeros((spec.num_layers, b, g.num_kv_heads, spec.head_dim, c),
                     dtype=spec.dtype, device=dev)
    sv = torch.zeros((spec.num_layers, b, g.num_kv_heads, c, spec.head_dim),
                     dtype=spec.dtype, device=dev)
    start = pos
    cache_len = kv_view or kv.cache_len_of(cache)
    slots = torch.arange(cache_len, device=dev)[None, None, :]
    side_pos = start[:, None] + torch.arange(c, device=dev)[None, :]
    cols = torch.arange(c, device=dev)[None, None, :]
    for idx in range(c):
        pos2 = pos[:, None]
        ai = _decode_inputs(spec, tpu_cfg, cache, pos2, seq_ids, kv_view,
                            inv_freq, side=(sk, sv))
        ai["mask"] = ai["mask"] & (slots < start[:, None, None])
        # the active token (side slot idx) is folded in from registers;
        # its side write lands at the end of the step
        ai["mask_side"] = (attn_ops.causal_mask(pos2, side_pos,
                                                spec.sliding_window)
                           & (cols != idx))
        ai["chunk_idx"] = idx
        hidden = run_layers(spec, params, cache, _embed(params, tok[:, None]),
                            ai, "decode")
        tok = _sample_out(spec, no_logits, params, hidden, hidden,
                          sampling_params, generator)["tokens"]
        toks.append(tok)
        pos = pos + 1
    kv.commit_chunk(cache["k"], kv.quantize_kv(sk, cache["k"].dtype,
                                               spec.kv_scale),
                    seq_ids, start, k_transposed=True)
    kv.commit_chunk(cache["v"], kv.quantize_kv(sv, cache["v"].dtype,
                                               spec.kv_scale),
                    seq_ids, start)
    return {"tokens": torch.stack(toks, dim=1)}


# ---------------------------------------------------------------------------
# Paged steps
# ---------------------------------------------------------------------------

def use_decode_kernel(spec: DecoderSpec, phase_t: int,
                      cache_dtype: torch.dtype) -> bool:
    """The paged branch's kernel admission (model_base.py:1071-1077)."""
    return (phase_t == 1 and spec.decode_kernel is not False
            and decode_attention.supports(spec, 1)
            and _cache_ok(spec, cache_dtype))


def _paged_hidden(spec: DecoderSpec, params, cache, input_ids, position_ids,
                  slot_mapping, block_table, inv_freq):
    """The layer stack over the paged cache: the step's K/V land at
    ``slot_mapping``; a T = 1 step runs the paged kernel, a wider one the
    block-table gather + ``mha`` (model_base.py:1071-1077)."""
    t = input_ids.shape[1]
    ai = attn_inputs(spec, position_ids, inv_freq)
    ai["use_kernel"] = use_decode_kernel(spec, t, cache["k"].dtype)
    ai["slot_mapping"] = slot_mapping
    ai["block_table"] = block_table
    if ai["use_kernel"]:
        ai["lens"] = position_ids[:, 0].to(torch.int32).contiguous()
        ai["block_table"] = block_table.to(torch.int32).contiguous()
    else:
        kv_len = block_table.shape[1] * cache["k"].shape[2]
        ai["mask"] = attn_ops.decode_mask(position_ids, kv_len,
                                          spec.sliding_window)
    return run_layers(spec, params, cache, _embed(params, input_ids), ai,
                      "paged")


def _gather_cols(hidden, cols):
    """hidden (B, T, H), cols (B,) -> (B, 1, H) at each row's column."""
    idx = cols.long()[:, None, None].expand(-1, 1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx)


def paged_forward_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                       input_ids, position_ids, slot_mapping, block_table,
                       last_idx, sampling_params=None, generator=None,
                       inv_freq: Optional[torch.Tensor] = None):
    """One paged step: paged prefill, prefix-cached or chunked prefill
    (T = window at arbitrary positions) and paged decode (T = 1).

    input_ids, position_ids, slot_mapping (B, T) (negative slot = no
    write); block_table (B, max_blocks); last_idx (B,) index into T of the
    token whose logits are sampled — all tensors on the cache's device.
    Writes the cache in place; returns {"tokens": (B,) int32} plus
    {"logits": (B, T, vocab)} when ``tpu_cfg.output_logits``."""
    hidden = _paged_hidden(spec, params, cache, input_ids, position_ids,
                           slot_mapping, block_table, inv_freq)
    return _sample_out(spec, tpu_cfg, params, hidden,
                       _gather_cols(hidden, last_idx), sampling_params,
                       generator)


EMIT_NONE, EMIT_LAST, EMIT_VERIFY = 0, 1, 2


def paged_ragged_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                      input_ids, position_ids, slot_mapping, block_table,
                      widths, emit_modes, sampling_params=None,
                      generator=None, inv_freq: Optional[torch.Tensor] = None,
                      verify: bool = False):
    """The ragged unified step (model_base.py:2222-2328): one paged
    forward whose rows mix decode steps (width 1), prefill chunks (width
    n at the row's own offset) and verify windows (width k+1).

    input_ids, position_ids, slot_mapping (B, W) (columns at or past a
    row's width carry slot -1: no write; their positions still feed RoPE
    and the mask, as in the reference); block_table (B, max_blocks);
    widths, emit_modes (B,) — all tensors on the cache's device. Per row,
    ``emit_modes`` selects what is emitted:

      * 0 — nothing (an intermediate prefill chunk, a frozen row);
      * 1 — the sample at column ``widths - 1``, through the sampling
        call :func:`paged_forward_step` makes;
      * 2 — greedy exact-match acceptance over the window: draft j
        (column j + 1) is accepted while it equals the argmax at column
        j, columns past the width are forced mismatches, and ``n_acc + 1``
        tokens (the accepted drafts and the bonus) are emitted.

    ``verify`` must be True when any row has mode 2: the caller decides it
    on the host from its numpy ``emit_modes``. Only then are the logits
    of every column computed (at W = 512 and a 128K vocabulary they are
    ~1 GB of fp32 that the other modes do not need). Writes the cache in
    place; returns {"tokens": (B, W) int32 (0 past ``num_emitted``),
    "num_emitted": (B,) int32}."""
    b, w = input_ids.shape
    hidden = _paged_hidden(spec, params, cache, input_ids, position_ids,
                           slot_mapping, block_table, inv_freq)
    emit = emit_modes.to(torch.int32)
    last = (widths.long() - 1).clamp(min=0)
    sampled = sampling_ops.sample(
        _lm_head(spec, params, _gather_cols(hidden, last))[:, 0, :],
        tpu_cfg.on_device_sampling_config, sampling_params, generator)
    zero = torch.zeros((), dtype=torch.int32, device=hidden.device)
    col = torch.arange(w, device=hidden.device)[None, :]
    tokens = torch.where((col == 0) & (emit == EMIT_LAST)[:, None],
                         sampled[:, None], zero)
    n_emit = (emit == EMIT_LAST).to(torch.int32)
    if verify:
        target = sampling_ops.greedy_sample(_lm_head(spec, params, hidden))
        if w > 1:
            mismatch = ((input_ids[:, 1:] != target[:, :-1])
                        | (col[:, 1:] >= widths[:, None])).to(torch.int32)
            n_acc = (torch.cumsum(mismatch, dim=1) == 0).sum(dim=1)
        else:
            n_acc = torch.zeros((b,), dtype=torch.long, device=hidden.device)
        rows = (emit == EMIT_VERIFY)
        tokens = torch.where(rows[:, None],
                             torch.where(col <= n_acc[:, None], target, zero),
                             tokens)
        n_emit = torch.where(rows, (n_acc + 1).to(torch.int32), n_emit)
    return {"tokens": tokens, "num_emitted": n_emit}


def paged_decode_loop(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                      first_tokens, position_ids, block_table,
                      sampling_params=None, generator=None,
                      num_steps: int = 1,
                      inv_freq: Optional[torch.Tensor] = None):
    """``num_steps`` paged decode steps with no host round trip between
    them: each step's slot comes from the (pre-extended) block table on the
    device, and each sampled token feeds the next step on the device. The
    host must pre-allocate blocks covering [p, p + num_steps).

    first_tokens (B,); position_ids (B,); block_table (B, max_blocks).
    Returns {"tokens": (B, num_steps) int32}."""
    bs = cache["k"].shape[2]
    b = first_tokens.shape[0]
    rows = torch.arange(b, device=first_tokens.device)
    # the loop returns tokens only (the counterpart's replace_output_logits)
    no_logits = dataclasses.replace(tpu_cfg, output_logits=False)
    last = torch.zeros((b,), dtype=torch.int32, device=first_tokens.device)
    tok, pos = first_tokens, position_ids.long()
    toks = []
    for _ in range(num_steps):
        slot = block_table.long()[rows, pos // bs] * bs + pos % bs
        out = paged_forward_step(
            spec, no_logits, params, cache, tok[:, None], pos[:, None],
            slot[:, None], block_table, last, sampling_params, generator,
            inv_freq)
        tok = out["tokens"]
        toks.append(tok)
        pos = pos + 1
    return {"tokens": torch.stack(toks, dim=1)}


# ---------------------------------------------------------------------------
# Spec resolution from InferenceConfig
# ---------------------------------------------------------------------------

def _unported_knobs(tcfg: TpuConfig, config: InferenceConfig):
    sc = tcfg.speculation_config
    checks = [
        (tcfg.tp_degree > 1 or tcfg.cp_degree > 1 or tcfg.ep_degree > 1
         or tcfg.attention_dp_degree > 1, "parallelism degrees > 1"),
        (tcfg.sequence_parallel_enabled, "sequence parallelism"),
        (tcfg.flash_decoding_enabled, "flash decoding"),
        (bool(tcfg.windowed_context_encoding),
         "windowed context encoding"),
        (tcfg.quantized, "quantized weights"),
        (tcfg.mlp_low_rank is not None, "low-rank MLP"),
        (tcfg.lora_config is not None, "LoRA"),
        (tcfg.moe_config is not None, "MoE"),
        (bool(sc and (sc.speculation_length
                      or sc.medusa_speculation_length)), "speculation"),
        (tcfg.collective_config is not None
         and tcfg.collective_config.dtype is not None,
         "quantized collectives"),
        (tcfg.tensor_capture_config is not None
         or tcfg.tensor_replacement_config is not None,
         "tensor capture/replacement"),
        (tcfg.on_device_sampling_config is not None
         and tcfg.on_device_sampling_config.stream_seed is not None,
         "coupled sampling streams (stream_seed)"),
        (getattr(config, "hidden_act", "silu") != "silu",
         f"hidden_act {getattr(config, 'hidden_act', None)!r}"),
    ]
    return [name for bad, name in checks if bad]


def _rolling_refusal(tcfg: TpuConfig, window: int) -> Optional[str]:
    """The rolling-cache decision of model_base.py:2513-2538: the reason
    the port refuses a config for which the JAX package would keep only
    ``window`` cache slots, else None."""
    if tcfg.rolling_kv_cache:
        return "rolling_kv_cache=True"
    blocked = (window <= 0 or tcfg.is_block_kv_layout
               or tcfg.flash_decoding_enabled)
    if tcfg.rolling_kv_cache is None and not blocked \
            and tcfg.seq_len > window:
        return (f"sliding_window {window} < seq_len {tcfg.seq_len} "
                "(set rolling_kv_cache=False to keep the full cache)")
    return None


def spec_from_config(config: InferenceConfig,
                     tp_degree: Optional[int] = None,
                     sliding_window: int = 0,
                     layer_pattern=None, attn_chunk: int = 0
                     ) -> DecoderSpec:
    """DecoderSpec from the HF-style attributes of an InferenceConfig
    (families pass ``sliding_window`` / ``layer_pattern`` / ``attn_chunk``
    as the counterpart's overrides). Raises :class:`ConfigurationError`
    for what the port does not run yet, including every config for which
    the JAX package would pick the rolling or mixed cache."""
    tcfg = config.tpu_config
    tp = tp_degree if tp_degree is not None else tcfg.tp_degree
    bad = _unported_knobs(tcfg, config)
    if tp != 1:
        bad.append(f"tp_degree={tp}")
    if layer_pattern is not None:
        bad.append("a per-layer attention pattern (layer_types)")
    if attn_chunk:
        bad.append("chunked attention")
    roll = _rolling_refusal(tcfg, sliding_window)
    if roll:
        bad.append("the rolling KV cache: " + roll)
    if bad:
        raise ConfigurationError(
            "the PyTorch port does not run these yet: " + ", ".join(bad))
    n_q = config.num_attention_heads
    n_kv = getattr(config, "num_key_value_heads", None) or n_q
    hidden = config.hidden_size
    head_dim = getattr(config, "head_dim", None) or hidden // n_q
    rope_scaling = getattr(config, "rope_scaling", None) or {}
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rope_type == "default":
        rope_type = None
    if rope_type not in SUPPORTED_SCALING:
        raise ConfigurationError(
            f"rope scaling {rope_type!r} is not ported yet "
            f"(supported: {SUPPORTED_SCALING})")
    rope = RopeConfig(
        head_dim=head_dim,
        rope_theta=float(getattr(config, "rope_theta", 10000.0)),
        rotary_dim=getattr(config, "rotary_dim", None),
        scaling_type=rope_type,
        scaling_factor=float(rope_scaling.get("factor", 1.0)),
        low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
        high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
        original_max_position=int(
            rope_scaling.get("original_max_position_embeddings")
            or getattr(config, "original_max_position_embeddings", None)
            or getattr(config, "max_position_embeddings", 8192)),
    )
    vocab = config.vocab_size
    return DecoderSpec(
        num_layers=config.num_hidden_layers,
        hidden_size=hidden,
        num_q_heads=n_q,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate_size=config.intermediate_size,
        vocab_size=vocab,
        padded_vocab=pad_vocab(vocab, tp),
        rms_eps=float(getattr(config, "rms_norm_eps", 1e-6)),
        rope=rope,
        gqa=resolve_gqa_sharding(n_q, n_kv, tp),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                         False)),
        sliding_window=int(sliding_window),
        flash_prefill=bool(tcfg.attn_kernel_enabled),
        decode_kernel=tcfg.attn_block_tkg_kernel_enabled,
        dtype=tcfg.torch_dtype,
        kv_dtype=tcfg.torch_kv_dtype,
        kv_scale=(tcfg.kv_cache_scale if tcfg.kv_cache_quant else None),
    )


def rope_inv_freq(spec: DecoderSpec, device: torch.device) -> torch.Tensor:
    """The step-invariant inverse-frequency table, moved to ``device`` once
    by the application."""
    return compute_inv_freq(spec.rope).to(device)
