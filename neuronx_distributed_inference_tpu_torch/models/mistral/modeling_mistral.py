"""Mistral family (counterpart:
``neuronx_distributed_inference_tpu/models/mistral/modeling_mistral.py:14-36``).
Llama-shaped with an optional uniform sliding window (Mistral-7B-v0.1:
window 4096). Above the window the contiguous app keeps the rolling
cache of ``sliding_window`` slots a row unless ``rolling_kv_cache=False``
keeps full rows. A non-uniform ``layer_types`` becomes a layer pattern
(alternating local and global layers), which takes the mixed per-layer
cache there (``model_base.cache_layout``)."""

from __future__ import annotations

from typing import List, Optional

from ...config import InferenceConfig
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class MistralInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]


@register_family("mistral", "ministral")
class MistralFamily(DecoderFamily):
    """mistral + ministral (uniformly sliding layers)."""
    config_cls = MistralInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        window = getattr(config, "sliding_window", None) or 0
        lt = list(getattr(config, "layer_types", []) or [])
        pattern = (tuple(t == "sliding_attention" for t in lt)
                   if lt and not all(t == lt[0] for t in lt) else None)
        if lt and all(t == "full_attention" for t in lt):
            window = 0
        return spec_from_config(config, tp_degree,
                                sliding_window=int(window),
                                layer_pattern=pattern)
