"""Phi-3 / Phi-4 model family."""
from .modeling_phi3 import (Phi3Family,  # noqa: F401
                            Phi3InferenceConfig, TpuPhi3ForCausalLM)
