"""DeepSeek-V2/V3 family (counterpart:
``neuronx_distributed_inference_tpu/models/deepseek/modeling_deepseek.py``
— ``DeepseekInferenceConfig`` :27, ``deepseek_style_moe_weights`` :35,
``DeepseekFamily`` :66-193, ``TpuDeepseekForCausalLM`` :196).

  * multi-head latent attention (``model_base.MLASpec``, ``_mla_qkv``):
    q through the optional q-LoRA, K/V from a compressed latent plus one
    shared rope head; K heads are nope + rope wide, V heads ``v_head_dim``;
  * the interleaved RoPE pairing on the rope head (``rope_interleave``,
    default true), YaRN with the softmax scale times mscale(mscale_all_dim)
    squared;
  * the sigmoid router with ``e_score_correction_bias`` (selection only),
    group-limited routing (``n_group`` / ``topk_group``),
    ``routed_scaling_factor`` and shared experts;
  * the mixed stack: ``first_k_dense_replace`` dense layers, then MoE
    layers (``params["layers"]`` / ``params["moe_layers"]``).

As in the reference, ``deepseek_v2`` maps to the same family and so to
V3's routing (sigmoid with the correction bias), not HF's V2 softmax
routing: a V2 checkpoint without ``e_score_correction_bias`` raises
``KeyError`` at conversion. MLA runs on the contiguous app only; the paged
app refuses it."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ..family import DecoderFamily, register_family
from ..model_base import (DecoderSpec, MLASpec, layer_plan,
                          spec_from_config)


class DeepseekInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "vocab_size", "kv_lora_rank", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim"]


def deepseek_style_moe_weights(get, prefix: str, i: int, spec: DecoderSpec,
                               transpose) -> Dict[str, Any]:
    """DeepSeek-V3-shaped MoE weights of layer ``i``: the fp32 router (and
    its ``e_score_correction_bias`` when the spec has a router bias), the
    per-expert gate / up / down, and the shared experts."""
    out: Dict[str, Any] = {
        "router": transpose(get(
            f"{prefix}.layers.{i}.mlp.gate.weight")).astype(np.float32),
    }
    if spec.moe.has_router_bias:
        out["router_bias"] = np.asarray(get(
            f"{prefix}.layers.{i}.mlp.gate.e_score_correction_bias")).astype(
            np.float32)
    for key, name in (("expert_gate", "gate_proj"),
                      ("expert_up", "up_proj"),
                      ("expert_down", "down_proj")):
        out[key] = np.stack([
            transpose(get(f"{prefix}.layers.{i}.mlp.experts.{e}.{name}"
                          ".weight"))
            for e in range(spec.moe.num_experts)])
    if spec.moe.shared_intermediate:
        for key, name in (("shared_gate", "gate_proj"),
                          ("shared_up", "up_proj"),
                          ("shared_down", "down_proj")):
            out[key] = transpose(get(
                f"{prefix}.layers.{i}.mlp.shared_experts.{name}.weight"))
    return out


def _mscale(factor: float, mscale_all_dim: float) -> float:
    return (1.0 if factor <= 1 else
            0.1 * mscale_all_dim * math.log(factor) + 1.0)


@register_family("deepseek_v3", "deepseek_v2")
class DeepseekFamily(DecoderFamily):
    config_cls = DeepseekInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        mla = MLASpec(
            kv_lora_rank=config.kv_lora_rank,
            qk_nope_head_dim=config.qk_nope_head_dim,
            qk_rope_head_dim=config.qk_rope_head_dim,
            v_head_dim=config.v_head_dim,
            q_lora_rank=getattr(config, "q_lora_rank", None),
        )
        scale = mla.qk_head_dim ** -0.5
        rope_scaling = getattr(config, "rope_scaling", None) or {}
        mscale_all_dim = rope_scaling.get("mscale_all_dim", 0) or 0
        if mscale_all_dim:
            m = _mscale(float(rope_scaling["factor"]), mscale_all_dim)
            scale = scale * m * m
        moe = None
        first_dense = 0
        if getattr(config, "n_routed_experts", None):
            moe = MoESpec(
                num_experts=config.n_routed_experts,
                top_k=config.num_experts_per_tok,
                intermediate_size=config.moe_intermediate_size,
                normalize_topk=bool(getattr(config, "norm_topk_prob", True)),
                routed_scaling=float(getattr(config, "routed_scaling_factor",
                                             1.0)),
                router_act="sigmoid",
                has_router_bias=True,          # e_score_correction_bias
                router_bias_mode="select",
                shared_intermediate=(config.moe_intermediate_size
                                     * getattr(config, "n_shared_experts",
                                               0)),
                n_group=int(getattr(config, "n_group", 1) or 1),
                topk_group=int(getattr(config, "topk_group", 1) or 1),
            )
            first_dense = int(getattr(config, "first_k_dense_replace", 0))
        spec = spec_from_config(
            config, tp_degree, mla=mla, moe=moe, first_dense=first_dense,
            head_dim=mla.qk_head_dim, attn_scale=scale,
            rope_interleaved=bool(getattr(config, "rope_interleave", True)))
        # RoPE turns the rope head only
        return dataclasses.replace(spec, rope=dataclasses.replace(
            spec.rope, head_dim=mla.qk_rope_head_dim))

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """HF names -> the stacked tree: a mixed stack's dense layers in
        ``"layers"`` and MoE layers in ``"moe_layers"``; an all-MoE or
        all-dense stack in ``"layers"`` (counterpart :123-193)."""
        p = cls.hf_prefix

        def get(name):
            if name in sd:
                return np.asarray(sd[name])
            raise KeyError(f"missing checkpoint tensor {name}")

        def t(w):
            return np.ascontiguousarray(np.asarray(w).T)

        def attn_layer(i: int) -> Dict[str, np.ndarray]:
            base = f"{p}.layers.{i}.self_attn"
            out = {
                "input_norm": get(f"{p}.layers.{i}.input_layernorm.weight"),
                "post_norm": get(
                    f"{p}.layers.{i}.post_attention_layernorm.weight"),
                "kv_a_proj": t(get(f"{base}.kv_a_proj_with_mqa.weight")),
                "kv_a_norm": get(f"{base}.kv_a_layernorm.weight"),
                "kv_b_proj": t(get(f"{base}.kv_b_proj.weight")),
                "o_proj": t(get(f"{base}.o_proj.weight")),
            }
            if spec.mla.q_lora_rank:
                out["q_a_proj"] = t(get(f"{base}.q_a_proj.weight"))
                out["q_a_norm"] = get(f"{base}.q_a_layernorm.weight")
                out["q_b_proj"] = t(get(f"{base}.q_b_proj.weight"))
            else:
                out["q_proj"] = t(get(f"{base}.q_proj.weight"))
            return out

        def dense_layer(i: int) -> Dict[str, np.ndarray]:
            out = attn_layer(i)
            for name in ("gate_proj", "up_proj", "down_proj"):
                out[name] = t(get(f"{p}.layers.{i}.mlp.{name}.weight"))
            return out

        def moe_layer(i: int) -> Dict[str, np.ndarray]:
            out = attn_layer(i)
            out.update(deepseek_style_moe_weights(get, p, i, spec, t))
            return out

        def stack(dicts: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
            return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

        def vpad(w):
            if w.shape[0] < spec.padded_vocab:
                w = np.pad(w, [(0, spec.padded_vocab - w.shape[0])]
                           + [(0, 0)] * (w.ndim - 1))
            return w

        out: Dict[str, Any] = {
            "embed": vpad(get(p + ".embed_tokens.weight")),
            "final_norm": get(p + ".norm.weight"),
        }
        convert = {"dense": dense_layer, "moe": moe_layer}
        stacks: Dict[str, list] = {}
        for key, i, _, kind in layer_plan(spec):
            stacks.setdefault(key, []).append(convert[kind](i))
        for key, layers in stacks.items():
            out[key] = stack(layers)
        if not spec.tie_word_embeddings:
            out["lm_head"] = np.ascontiguousarray(
                vpad(get("lm_head.weight")).T)
        return out


def TpuDeepseekForCausalLM(model_path: str, config: InferenceConfig,
                           device: DeviceLike = None):
    """The contiguous-cache application over the DeepSeek family, as the
    JAX entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, DeepseekFamily,
                               device=device)
