"""Serving resilience layer of the port (counterpart:
``neuronx_distributed_inference_tpu/resilience/``): the typed failure
taxonomy, deterministic fault injection and the recompute-preemption
policies. The degradation controller is not ported yet."""

from .errors import (AdmissionError, Cancelled, CapacityError,
                     ConfigurationError, DeadlineExceeded, HandoffError,
                     KVCacheStateError, QueueOverflow, ReplicaUnavailable,
                     SequenceStateError, ServingError, StepFailure)
from .faults import FAULT_POINTS, FAULTS, FaultInjector, InjectedFault
from .preemption import PREEMPTION_POLICIES, Preempted, pick_victim

__all__ = [
    "ServingError", "AdmissionError", "CapacityError", "ConfigurationError",
    "DeadlineExceeded", "KVCacheStateError", "SequenceStateError",
    "StepFailure", "QueueOverflow", "Cancelled",
    "ReplicaUnavailable", "HandoffError",
    "FAULTS", "FAULT_POINTS", "FaultInjector", "InjectedFault",
    "Preempted", "PREEMPTION_POLICIES", "pick_victim",
]
