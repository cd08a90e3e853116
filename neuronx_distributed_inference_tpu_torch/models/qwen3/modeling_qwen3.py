"""Qwen3 family (counterpart:
``neuronx_distributed_inference_tpu/models/qwen3/modeling_qwen3.py:14-28``).
Llama-shaped with a per-head q/k RMSNorm and an explicit head_dim
decoupled from hidden_size / num_heads."""

from __future__ import annotations

from typing import List, Optional

from ...config import InferenceConfig
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class Qwen3InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "head_dim"]


@register_family("qwen3")
class Qwen3Family(DecoderFamily):
    config_cls = Qwen3InferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        return spec_from_config(config, tp_degree, qk_norm=True)
