"""GPT-OSS model family."""
from .modeling_gpt_oss import (GptOssFamily,  # noqa: F401
                               GptOssInferenceConfig, TpuGptOssForCausalLM)
