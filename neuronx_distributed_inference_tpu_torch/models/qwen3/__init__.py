"""Qwen3 model family."""
from .modeling_qwen3 import Qwen3Family, Qwen3InferenceConfig  # noqa: F401
