"""Serving resilience layer of the port (counterpart:
``neuronx_distributed_inference_tpu/resilience/``): the typed failure
taxonomy and the recompute-preemption policies. Fault injection and the
degradation controller are not ported yet."""

from .errors import (AdmissionError, Cancelled, CapacityError,
                     ConfigurationError, DeadlineExceeded, HandoffError,
                     KVCacheStateError, QueueOverflow, ReplicaUnavailable,
                     SequenceStateError, ServingError, StepFailure)
from .preemption import PREEMPTION_POLICIES, Preempted, pick_victim

__all__ = [
    "ServingError", "AdmissionError", "CapacityError", "ConfigurationError",
    "DeadlineExceeded", "KVCacheStateError", "SequenceStateError",
    "StepFailure", "QueueOverflow", "Cancelled",
    "ReplicaUnavailable", "HandoffError",
    "Preempted", "PREEMPTION_POLICIES", "pick_victim",
]
