"""Llama4 text model family."""
from .modeling_llama4 import (Llama4Family,  # noqa: F401
                              Llama4InferenceConfig,
                              TpuLlama4ForCausalLM)
