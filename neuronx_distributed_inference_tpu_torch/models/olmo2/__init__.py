"""OLMo-2 model family."""
from .modeling_olmo2 import (Olmo2Family,  # noqa: F401
                             Olmo2InferenceConfig, TpuOlmo2ForCausalLM)
