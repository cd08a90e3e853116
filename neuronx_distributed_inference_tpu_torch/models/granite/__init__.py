"""Granite model family."""
from .modeling_granite import (GraniteFamily,  # noqa: F401
                               GraniteInferenceConfig, TpuGraniteForCausalLM)
