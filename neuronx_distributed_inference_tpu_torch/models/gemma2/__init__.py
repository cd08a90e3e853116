"""Gemma-2 model family."""
from .modeling_gemma2 import (Gemma2Family,  # noqa: F401
                              Gemma2InferenceConfig, TpuGemma2ForCausalLM)
