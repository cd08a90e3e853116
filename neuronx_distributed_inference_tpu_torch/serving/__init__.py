"""Serving surface of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/``): the paged engine adapter."""

from .adapter import PagedEngineAdapter

__all__ = ["PagedEngineAdapter"]
