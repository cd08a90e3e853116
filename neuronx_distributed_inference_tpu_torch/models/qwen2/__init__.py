"""Qwen2 model family."""
from .modeling_qwen2 import (Qwen2Family,  # noqa: F401
                             Qwen2InferenceConfig, TpuQwen2ForCausalLM)
