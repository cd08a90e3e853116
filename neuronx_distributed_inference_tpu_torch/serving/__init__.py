"""Serving surface of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/``): the continuous-batching
adapter over the contiguous app, the paged engine adapter (with its
ragged unified dispatch, ``.ragged``) and the bounded LoRA adapter pool
it serves from (``.lora_pool``); the multi-tenant engine over the paged
adapter is imported from ``.engine``."""

from .adapter import ContinuousBatchingAdapter, PagedEngineAdapter
from .lora_pool import LoraAdapterPool

__all__ = ["ContinuousBatchingAdapter", "LoraAdapterPool",
           "PagedEngineAdapter"]
