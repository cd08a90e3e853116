"""DeepSeek-V2/V3 model family."""
from .modeling_deepseek import (DeepseekFamily,  # noqa: F401
                                DeepseekInferenceConfig,
                                TpuDeepseekForCausalLM)
