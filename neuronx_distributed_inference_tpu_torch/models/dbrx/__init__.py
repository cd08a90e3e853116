"""DBRX model family."""
from .modeling_dbrx import (DbrxFamily, DbrxInferenceConfig,  # noqa: F401
                            TpuDbrxForCausalLM)
