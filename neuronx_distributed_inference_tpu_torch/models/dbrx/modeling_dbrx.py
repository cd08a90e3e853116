"""DBRX family (counterpart:
``neuronx_distributed_inference_tpu/models/dbrx/modeling_dbrx.py`` —
``DbrxInferenceConfig`` :21, ``DbrxFamily`` :49-126,
``TpuDbrxForCausalLM`` :129).

DBRX's deltas from the Llama decoder, as ``DecoderSpec`` knobs: bias-free
LayerNorm in every block norm and the final norm (``norm_type``), the
fused ``Wqkv`` projection clamped to +-``clip_qkv`` (``qkv_clip``), and an
MoE in every layer: softmax over the experts, top-k, the k weights
renormalised (``moe_normalize_expert_weights`` 1, an L1 norm of positive
weights), experts stored fused (``w1`` / ``v1`` / ``w2``, each (E * I,
H)). DBRX's 48 query heads over 8 KV heads give both decode kernels a
group of 6."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ...parallel.layers import place_q_weight, replicate_kv_weight
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


def _as_dict(x) -> Dict[str, Any]:
    if not x:
        return {}
    return x if isinstance(x, dict) else dict(x.__dict__)


class DbrxInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["d_model", "n_heads", "n_layers", "vocab_size"]

    def add_derived_config(self):
        """DBRX's names onto the HF-standard attributes the spec reads
        (counterpart :25-45)."""
        if hasattr(self, "d_model"):
            self.hidden_size = self.d_model
            self.num_attention_heads = self.n_heads
            self.num_hidden_layers = self.n_layers
            attn = _as_dict(getattr(self, "attn_config", None))
            self.num_key_value_heads = attn.get("kv_n_heads", self.n_heads)
            self.rope_theta = attn.get("rope_theta", 10000.0)
            self.clip_qkv = attn.get("clip_qkv")
            ffn = _as_dict(getattr(self, "ffn_config", None))
            self.intermediate_size = ffn.get("ffn_hidden_size",
                                             4 * self.d_model)
            self.moe_num_experts = ffn.get("moe_num_experts", 16)
            self.moe_top_k = ffn.get("moe_top_k", 4)
            self.moe_normalize_expert_weights = ffn.get(
                "moe_normalize_expert_weights", 1)


@register_family("dbrx")
class DbrxFamily(DecoderFamily):
    config_cls = DbrxInferenceConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        moe = MoESpec(
            num_experts=config.moe_num_experts,
            top_k=config.moe_top_k,
            intermediate_size=config.intermediate_size,
            normalize_topk=bool(config.moe_normalize_expert_weights),
        )
        clip = getattr(config, "clip_qkv", None)
        return spec_from_config(config, tp_degree, moe=moe,
                                norm_type="layernorm",
                                qkv_clip=float(clip) if clip else None)

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """HF names -> one ``"layers"`` stack (counterpart :72-126): the
        fused ``Wqkv`` (out, H) split into q / k / v, the fused experts
        reshaped to (E, I, H), ``w1`` / ``v1`` transposed to (E, H, I)."""
        p = cls.hf_prefix
        g, D = spec.gqa, spec.head_dim
        E, inter = spec.moe.num_experts, spec.moe.intermediate_size
        H = spec.hidden_size

        def get(name):
            if name in sd:
                return np.asarray(sd[name])
            raise KeyError(f"missing checkpoint tensor {name}")

        def t(w):
            return np.ascontiguousarray(np.asarray(w).T)

        def layer(i: int) -> Dict[str, np.ndarray]:
            base = f"{p}.blocks.{i}"
            wqkv = get(f"{base}.norm_attn_norm.attn.Wqkv.weight")
            nq, nkv = g.orig_q_heads * D, g.orig_kv_heads * D
            experts = {name: get(f"{base}.ffn.experts.mlp.{name}").reshape(
                E, inter, H) for name in ("w1", "v1", "w2")}
            return {
                "input_norm": get(f"{base}.norm_attn_norm.norm_1.weight"),
                "post_norm": get(f"{base}.norm_attn_norm.norm_2.weight"),
                "q_proj": place_q_weight(t(wqkv[:nq]), g, D, -1),
                "k_proj": replicate_kv_weight(t(wqkv[nq:nq + nkv]), g, D,
                                              -1),
                "v_proj": replicate_kv_weight(
                    t(wqkv[nq + nkv:nq + 2 * nkv]), g, D, -1),
                "o_proj": place_q_weight(t(get(
                    f"{base}.norm_attn_norm.attn.out_proj.weight")), g, D,
                    0),
                "router": t(get(f"{base}.ffn.router.layer.weight")).astype(
                    np.float32),
                "expert_gate": np.ascontiguousarray(
                    np.swapaxes(experts["w1"], 1, 2)),
                "expert_up": np.ascontiguousarray(
                    np.swapaxes(experts["v1"], 1, 2)),
                "expert_down": np.ascontiguousarray(experts["w2"]),
            }

        layers = [layer(i) for i in range(spec.num_layers)]

        def vpad(w):
            if w.shape[0] < spec.padded_vocab:
                w = np.pad(w, [(0, spec.padded_vocab - w.shape[0])]
                           + [(0, 0)] * (w.ndim - 1))
            return w

        return {
            "embed": vpad(get(p + ".wte.weight")),
            "layers": {k: np.stack([d[k] for d in layers])
                       for k in layers[0]},
            "final_norm": get(p + ".norm_f.weight"),
            "lm_head": np.ascontiguousarray(vpad(get("lm_head.weight")).T),
        }


def TpuDbrxForCausalLM(model_path: str, config: InferenceConfig,
                       device: DeviceLike = None):
    """The contiguous-cache application over the DBRX family, as the JAX
    entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, DbrxFamily, device=device)
