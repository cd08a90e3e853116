"""Qwen2 family (counterpart:
``neuronx_distributed_inference_tpu/models/qwen2/modeling_qwen2.py:13-31``).
Llama-shaped with q/k/v projection biases; the HF config's sliding window
applies only with ``use_sliding_window`` (off in every Qwen2 / Qwen2.5
checkpoint), and then to every layer."""

from __future__ import annotations

from typing import List, Optional

from ...config import InferenceConfig
from ...device import DeviceLike
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class Qwen2InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]


@register_family("qwen2")
class Qwen2Family(DecoderFamily):
    config_cls = Qwen2InferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        window = 0
        if getattr(config, "use_sliding_window", False):
            window = getattr(config, "sliding_window", None) or 0
        return spec_from_config(config, tp_degree, qkv_bias=True,
                                sliding_window=int(window))


def TpuQwen2ForCausalLM(model_path: str, config: InferenceConfig,
                        device: DeviceLike = None):
    """The contiguous-cache application over the Qwen2 family."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Qwen2Family,
                               device=device)
