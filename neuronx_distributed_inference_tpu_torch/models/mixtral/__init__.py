"""Mixtral model family."""
from .modeling_mixtral import (MixtralFamily,  # noqa: F401
                               MixtralInferenceConfig, TpuMixtralForCausalLM)
