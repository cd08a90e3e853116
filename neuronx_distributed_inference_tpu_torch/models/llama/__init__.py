"""Llama model family."""
from .modeling_llama import (LlamaFamily, LlamaInferenceConfig,  # noqa: F401
                             TpuLlamaForCausalLM)
