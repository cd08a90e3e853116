"""Qwen3-MoE model family."""
from .modeling_qwen3_moe import (Qwen3MoeFamily,  # noqa: F401
                                 Qwen3MoeInferenceConfig,
                                 TpuQwen3MoeForCausalLM)
