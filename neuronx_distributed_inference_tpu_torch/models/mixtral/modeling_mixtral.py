"""Mixtral family (counterpart:
``neuronx_distributed_inference_tpu/models/mixtral/modeling_mixtral.py:23-62``).

Routing as HF Mixtral: softmax over all experts, top-k, the selected
affinities renormalised. The config's ``sliding_window`` reaches the spec;
a window shorter than ``seq_len`` takes the rolling cache on the
contiguous app unless ``rolling_kv_cache=False`` keeps the full cache."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class MixtralInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "rms_norm_eps", "num_local_experts", "num_experts_per_tok"]


@register_family("mixtral")
class MixtralFamily(DecoderFamily):
    config_cls = MixtralInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        moe = MoESpec(
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            intermediate_size=config.intermediate_size,
            normalize_topk=True,
            act=getattr(config, "hidden_act", "silu"),
        )
        window = getattr(config, "sliding_window", None) or 0
        return spec_from_config(config, tp_degree, moe=moe,
                                sliding_window=int(window))

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        """HF names: block_sparse_moe.gate (E, H) router;
        experts.{e}.w1 / w3 / w2 = gate / up / down."""
        p = cls.hf_prefix + ".layers.{i}.block_sparse_moe."
        return cls.convert_moe_weights(
            get, spec, router_name=p + "gate.weight",
            expert_fmt=p + "experts.{e}.{name}.weight",
            gate="w1", up="w3", down="w2")


def TpuMixtralForCausalLM(model_path: str, config: InferenceConfig,
                          device: DeviceLike = None):
    """The contiguous-cache application over the Mixtral family, as the
    JAX entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, MixtralFamily,
                               device=device)
