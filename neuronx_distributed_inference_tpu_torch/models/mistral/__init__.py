"""Mistral model family."""
from .modeling_mistral import (MistralFamily,  # noqa: F401
                               MistralInferenceConfig)
