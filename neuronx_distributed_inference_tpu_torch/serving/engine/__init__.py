"""Multi-tenant serving engine of the port (counterpart:
``neuronx_distributed_inference_tpu/serving/engine/``): request queue with
priority classes and weighted-fair tenant scheduling, prefix-cache-aware
admission ordering, per-request token streams and the asyncio HTTP/SSE
front door (``ServingFrontend``), over the paged adapter."""

from .frontend import ServingFrontend
from .queue import MultiTenantQueue, QueuedRequest
from .scheduler import ServingEngine
from .streams import TokenStream

__all__ = ["ServingEngine", "ServingFrontend", "TokenStream",
           "MultiTenantQueue", "QueuedRequest"]
