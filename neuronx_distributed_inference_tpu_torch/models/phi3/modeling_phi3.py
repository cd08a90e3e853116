"""Phi-3 family, Phi-3 and Phi-4 (counterpart:
``neuronx_distributed_inference_tpu/models/phi3/modeling_phi3.py:17-51``).
Llama-shaped with fused projections in the checkpoint: ``qkv_proj`` (q, k
and v rows in that order) and ``gate_up_proj`` (gate rows, then up rows),
split here before the base converter runs; no biases. Phi-3.5's longrope
(``rope_scaling`` type "longrope", or the legacy "su") is
``ops/rope.py``'s."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec


class Phi3InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]


@register_family("phi3", "phi4")
class Phi3Family(DecoderFamily):
    config_cls = Phi3InferenceConfig

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, np.ndarray]:
        """Split the fused projections into the standard names, then
        convert as the base family does."""
        g = spec.gqa
        D = spec.head_dim
        nq, nkv = g.orig_q_heads * D, g.orig_kv_heads * D
        inter = spec.intermediate_size
        split = dict(sd)
        for k in sd:
            if k.endswith("self_attn.qkv_proj.weight"):
                w = np.asarray(sd[k])
                base = k[:-len("qkv_proj.weight")]
                split[base + "q_proj.weight"] = w[:nq]
                split[base + "k_proj.weight"] = w[nq:nq + nkv]
                split[base + "v_proj.weight"] = w[nq + nkv:nq + 2 * nkv]
            elif k.endswith("mlp.gate_up_proj.weight"):
                w = np.asarray(sd[k])
                base = k[:-len("gate_up_proj.weight")]
                split[base + "gate_proj.weight"] = w[:inter]
                split[base + "up_proj.weight"] = w[inter:]
        return super().convert_hf_state_dict(split, spec)


def TpuPhi3ForCausalLM(model_path: str, config: InferenceConfig,
                       device: DeviceLike = None):
    """The contiguous-cache application over the Phi-3 family, as the JAX
    entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Phi3Family,
                               device=device)
