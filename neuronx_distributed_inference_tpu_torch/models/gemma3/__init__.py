"""Gemma-3 (text) model family."""
from .modeling_gemma3 import (Gemma3Family,  # noqa: F401
                              Gemma3InferenceConfig, TpuGemma3ForCausalLM)
