"""Llama family, 2 and 3.x (counterpart:
``neuronx_distributed_inference_tpu/models/llama/modeling_llama.py:16-31``).
Llama-3.1 scaled RoPE is the generic "llama3" scaling of ops/rope.py,
selected from the HF ``rope_scaling`` dict."""

from __future__ import annotations

from typing import List

from ...config import InferenceConfig
from ..family import DecoderFamily, register_family


class LlamaInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size",
                "intermediate_size", "rms_norm_eps"]


@register_family("llama")
class LlamaFamily(DecoderFamily):
    config_cls = LlamaInferenceConfig


def TpuLlamaForCausalLM(model_path: str, config: InferenceConfig,
                        device=None):
    """The contiguous-cache application over the Llama family, as the JAX
    entry of this name builds it (the README's Quick start). Paged serving
    builds ``PagedCausalLMApplication`` directly."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, LlamaFamily,
                               device=device)
