"""Serving surface of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/``): the continuous-batching
adapter over the contiguous app and the paged engine adapter (with its
ragged unified dispatch, ``.ragged``); the multi-tenant engine over the
paged adapter is imported from ``.engine``."""

from .adapter import ContinuousBatchingAdapter, PagedEngineAdapter

__all__ = ["ContinuousBatchingAdapter", "PagedEngineAdapter"]
