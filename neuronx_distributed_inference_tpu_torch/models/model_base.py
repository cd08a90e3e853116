"""Dense decoder over the paged KV cache (counterpart:
``neuronx_distributed_inference_tpu/models/model_base.py`` — ``DecoderSpec``
:98, ``pad_vocab`` :350, the parameter specs :360-590, ``fuse_qkv_host``
:618, ``attn_inputs`` :720, ``_layer_body`` :753, the dense ``_mlp_block``
:889, the paged branch of ``_attn_block`` :943-1103, ``run_layers`` :1296,
``_embed`` :1656, ``_lm_head`` :1671, ``paged_forward_step`` :1883,
``paged_decode_loop`` :2058, ``spec_from_config`` :2346).

The model is a set of plain functions over a dict of parameter tensors
laid out as the JAX package's tree (stacked ``(L, …)`` layer leaves, fused
``qkv_proj``, vocabulary padded to a multiple of 128), so a JAX parameter
tree converts by renaming (``utils/jax_params.py``). The JAX ``lax.scan``
over layers is a Python loop; the KV cache is written IN PLACE (the JAX
graphs donated it).

Attention in the paged phase: every layer first writes the step's K/V
into the cache at ``slot_mapping``; then a single-token step (T == 1)
whose geometry :func:`ops.decode_attention.supports` admits runs the
hand-written paged decode kernel over each row's live pages (unless the
config sets ``attn_block_tkg_kernel_enabled=False``), and every other step
gathers the block table into contiguous K/V and runs the masked ``mha`` —
the rule of model_base.py:1071-1077.
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
from ..ops import decode_attention
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
    attn_scale: Optional[float] = None   # None => head_dim ** -0.5
    # paged decode kernel: None/True = on where supports() holds
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
    """RoPE cos/sin for the step; the gather path adds its mask."""
    cos, sin = rope_cos_sin(position_ids, spec.rope, inv_freq)
    return {"cos": cos, "sin": sin}


def _attn_block(spec: DecoderSpec, h, layer_w, cache, li: int, ai,
                slot_mapping, block_table, use_kernel: bool):
    """q/k/v projections, the in-place cache write, paged attention (the
    kernel or the gather path) and the output projection. ``h`` is the
    normed block input (B, T, H)."""
    b, t, _ = h.shape
    g = spec.gqa
    qkv = h @ layer_w["qkv_proj"]
    q, k, v = torch.split(qkv, [spec.q_size, spec.kv_size, spec.kv_size],
                          dim=-1)
    q = apply_rope(q.reshape(b, t, g.num_q_heads, spec.head_dim),
                   ai["cos"], ai["sin"])
    k = apply_rope(k.reshape(b, t, g.num_kv_heads, spec.head_dim),
                   ai["cos"], ai["sin"])
    v = v.reshape(b, t, g.num_kv_heads, spec.head_dim)
    kc, vc = cache["k"], cache["v"]
    bkv.write_slots_at_layer(kc, kv.quantize_kv(k, kc.dtype, spec.kv_scale),
                             li, slot_mapping)
    bkv.write_slots_at_layer(vc, kv.quantize_kv(v, vc.dtype, spec.kv_scale),
                             li, slot_mapping)
    if use_kernel:
        # the step's own token was just written, but the kernel masks
        # kpos < lens strictly and folds the token in from new_k/new_v
        attn_out = decode_attention.paged_decode_attention(
            q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
            v[:, 0].contiguous(), li, ai["lens"], ai["block_table"],
            scale=spec.scale, kv_scale=spec.kv_scale)[:, None]
    else:
        k_all = kv.dequantize_kv(
            bkv.gather_block_kv(bkv.read_layer(kc, li), block_table),
            h.dtype, spec.kv_scale)
        v_all = kv.dequantize_kv(
            bkv.gather_block_kv(bkv.read_layer(vc, li), block_table),
            h.dtype, spec.kv_scale)
        attn_out = attn_ops.mha(q, k_all, v_all, ai["mask"], spec.scale)
    return attn_out.reshape(b, t, -1) @ layer_w["o_proj"]


def _mlp_block(x, layer_w):
    """Dense GLU MLP: silu(x @ gate) * (x @ up) @ down."""
    inter = F.silu(x @ layer_w["gate_proj"]) * (x @ layer_w["up_proj"])
    return inter @ layer_w["down_proj"]


def _layer_body(spec: DecoderSpec, hidden, layer_w, cache, li: int, ai,
                slot_mapping, block_table, use_kernel: bool):
    """One pre-norm transformer layer."""
    h = rms_norm(hidden, layer_w["input_norm"], spec.rms_eps)
    hidden = hidden + _attn_block(spec, h, layer_w, cache, li, ai,
                                  slot_mapping, block_table, use_kernel)
    h = rms_norm(hidden, layer_w["post_norm"], spec.rms_eps)
    return hidden + _mlp_block(h, layer_w)


def run_layers(spec: DecoderSpec, params, cache, hidden, ai, slot_mapping,
               block_table, use_kernel: bool):
    """The layer loop (the counterpart scans stacked weights with
    ``lax.scan``; here each layer's weights are views into the stacks)."""
    stacks = params["layers"]
    for i in range(spec.num_layers):
        layer_w = {k: w[i] for k, w in stacks.items()}
        hidden = _layer_body(spec, hidden, layer_w, cache, i, ai,
                             slot_mapping, block_table, use_kernel)
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


def use_decode_kernel(spec: DecoderSpec, phase_t: int,
                      cache_dtype: torch.dtype) -> bool:
    """The paged branch's kernel admission (model_base.py:1071-1077)."""
    return (phase_t == 1 and spec.decode_kernel is not False
            and decode_attention.supports(spec, 1)
            and (cache_dtype == spec.dtype
                 or decode_attention.quantized_cache_ok(cache_dtype)))


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
    t = input_ids.shape[1]
    use_kernel = use_decode_kernel(spec, t, cache["k"].dtype)
    ai = attn_inputs(spec, position_ids, inv_freq)
    if use_kernel:
        ai["lens"] = position_ids[:, 0].to(torch.int32).contiguous()
        ai["block_table"] = block_table.to(torch.int32).contiguous()
    else:
        kv_len = block_table.shape[1] * cache["k"].shape[2]
        ai["mask"] = attn_ops.decode_mask(position_ids, kv_len)
    hidden = _embed(params, input_ids)
    hidden = run_layers(spec, params, cache, hidden, ai, slot_mapping,
                        block_table, use_kernel)
    idx = last_idx.long()[:, None, None].expand(-1, 1, hidden.shape[-1])
    last_h = torch.gather(hidden, 1, idx)
    logits = _lm_head(spec, params, last_h)[:, 0, :]
    out = {}
    if tpu_cfg.output_logits:
        out["logits"] = _lm_head(spec, params, hidden)[..., :spec.vocab_size]
    out["tokens"] = sampling_ops.sample(
        logits, tpu_cfg.on_device_sampling_config, sampling_params,
        generator)
    return out


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


def spec_from_config(config: InferenceConfig,
                     tp_degree: Optional[int] = None) -> DecoderSpec:
    """DecoderSpec from the HF-style attributes of an InferenceConfig.
    Raises :class:`ConfigurationError` for what the port does not run yet."""
    tcfg = config.tpu_config
    tp = tp_degree if tp_degree is not None else tcfg.tp_degree
    bad = _unported_knobs(tcfg, config)
    if tp != 1:
        bad.append(f"tp_degree={tp}")
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
        decode_kernel=tcfg.attn_block_tkg_kernel_enabled,
        dtype=tcfg.torch_dtype,
        kv_dtype=tcfg.torch_kv_dtype,
        kv_scale=(tcfg.kv_cache_scale if tcfg.kv_cache_quant else None),
    )


def rope_inv_freq(spec: DecoderSpec, device: torch.device) -> torch.Tensor:
    """The step-invariant inverse-frequency table, moved to ``device`` once
    by the application."""
    return compute_inv_freq(spec.rope).to(device)
