"""Qwen3-MoE family (counterpart:
``neuronx_distributed_inference_tpu/models/qwen3_moe/modeling_qwen3_moe.py:20-65``).

Qwen3 attention (per-head q/k RMSNorm, decoupled head_dim) and
Mixtral-style routing (softmax over all experts, top-k, renormalised when
``norm_topk_prob``). Every layer is an MoE layer: ``mlp_only_layers`` and
``decoder_sparse_step != 1`` are refused, as the reference refuses them."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ...resilience.errors import ConfigurationError
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class Qwen3MoeInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "head_dim",
                "num_experts", "num_experts_per_tok", "moe_intermediate_size"]


@register_family("qwen3_moe")
class Qwen3MoeFamily(DecoderFamily):
    config_cls = Qwen3MoeInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        if getattr(config, "mlp_only_layers", None):
            raise ConfigurationError(
                "qwen3_moe mlp_only_layers (a mixed dense / MoE stack) is "
                "not supported (ROADMAP A14)")
        if getattr(config, "decoder_sparse_step", 1) != 1:
            raise ConfigurationError(
                "qwen3_moe decoder_sparse_step != 1 is not supported "
                "(ROADMAP A14)")
        moe = MoESpec(
            num_experts=config.num_experts,
            top_k=config.num_experts_per_tok,
            intermediate_size=config.moe_intermediate_size,
            normalize_topk=bool(getattr(config, "norm_topk_prob", True)),
            act=getattr(config, "hidden_act", "silu"),
        )
        return spec_from_config(config, tp_degree, moe=moe, qk_norm=True,
                                intermediate_size=config.moe_intermediate_size)

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        """HF names: mlp.gate.weight (E, H) router;
        mlp.experts.{e}.gate_proj / up_proj / down_proj."""
        p = cls.hf_prefix
        return cls.convert_moe_weights(
            get, spec,
            router_name=p + ".layers.{i}.mlp.gate.weight",
            expert_fmt=p + ".layers.{i}.mlp.experts.{e}.{name}.weight",
            gate="gate_proj", up="up_proj", down="down_proj")


def TpuQwen3MoeForCausalLM(model_path: str, config: InferenceConfig,
                           device: DeviceLike = None):
    """The contiguous-cache application over the Qwen3-MoE family, as the
    JAX entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Qwen3MoeFamily,
                               device=device)
