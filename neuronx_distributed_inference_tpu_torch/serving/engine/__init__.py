"""Multi-tenant serving engine of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/engine/``): request queue with
priority classes and weighted-fair tenant scheduling, prefix-cache-aware
admission ordering and per-request token streams, over the paged
adapter. The HTTP/SSE front door (``ServingFrontend``) is not ported
yet."""

from .queue import MultiTenantQueue, QueuedRequest
from .scheduler import ServingEngine
from .streams import TokenStream

__all__ = ["ServingEngine", "TokenStream", "MultiTenantQueue",
           "QueuedRequest"]
