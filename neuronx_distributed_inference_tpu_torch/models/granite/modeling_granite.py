"""Granite family (counterpart:
``neuronx_distributed_inference_tpu/models/granite/modeling_granite.py:15-43``).
Llama-shaped with IBM's multipliers: ``embedding_multiplier`` on the
embeddings (``embed_scale``), ``attention_multiplier`` as the softmax
scale, ``residual_multiplier`` on every block output before its residual
add, and ``logits_scaling`` dividing the lm-head logits
(``logits_divide``); tied embeddings unless the config says otherwise."""

from __future__ import annotations

from typing import List, Optional

from ...config import InferenceConfig
from ...device import DeviceLike
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class GraniteInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]


@register_family("granite")
class GraniteFamily(DecoderFamily):
    config_cls = GraniteInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        return spec_from_config(
            config, tp_degree,
            embed_scale=float(getattr(config, "embedding_multiplier", 1.0)),
            attn_scale=float(getattr(config, "attention_multiplier", None)
                             or 0) or None,
            residual_multiplier=float(getattr(config, "residual_multiplier",
                                              1.0)),
            logits_divide=float(getattr(config, "logits_scaling", 0) or 0)
            or None,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             True)),
        )


def TpuGraniteForCausalLM(model_path: str, config: InferenceConfig,
                          device: DeviceLike = None):
    """The contiguous-cache application over the Granite family, as the
    JAX entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, GraniteFamily,
                               device=device)
