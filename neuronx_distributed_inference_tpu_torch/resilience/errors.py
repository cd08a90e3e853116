"""Typed failure taxonomy for the serving surface — a copy of
``neuronx_distributed_inference_tpu/resilience/errors.py`` (the JAX
package imports jax at its root, so the port keeps its own copy).

Everything the engine adapter and the paged KV cache manager raise at
their public boundaries derives from :class:`ServingError`, so an engine
can catch the whole family with one clause and branch on type to pick a
recovery: re-queue (:class:`CapacityError`), reject the request
(:class:`AdmissionError`), drop it (:class:`DeadlineExceeded`), or retry
the step (:class:`StepFailure` — host state is rolled back before it
propagates). Each class also subclasses the builtin it stands for
(``ValueError`` / ``RuntimeError`` / ``TimeoutError``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = [
    "ServingError", "AdmissionError", "SequenceStateError",
    "ConfigurationError", "CapacityError", "KVCacheStateError",
    "DeadlineExceeded", "StepFailure", "QueueOverflow", "Cancelled",
    "ReplicaUnavailable", "HandoffError",
]


class ServingError(Exception):
    """Base of the serving failure taxonomy. :attr:`seq_ids` carries the
    affected sequence ids when the failure is attributable to specific
    rows (empty otherwise), so engines never have to parse messages."""

    trace_id = None

    def __init__(self, msg: str, seq_ids: Sequence[int] = ()):
        super().__init__(msg)
        self.seq_ids: Tuple[int, ...] = tuple(seq_ids)


class AdmissionError(ServingError, ValueError):
    """``add_requests`` arguments are invalid: empty/duplicate seq_ids,
    zero-length or over-long prompts, seq_id already running or out of
    range. Nothing was admitted; no device or cache state changed."""


class SequenceStateError(ServingError, ValueError):
    """An operation addressed a seq_id in the wrong lifecycle state
    (e.g. ``step()`` on a released or never-added id)."""


class ConfigurationError(ServingError, ValueError):
    """The adapter or application was built over an incompatible
    configuration (including features the port does not run yet)."""


class CapacityError(ServingError, RuntimeError):
    """A bounded resource ran out: KV cache blocks, batch slots, or the
    configured ``seq_len``. The failed call was rolled back (or, with a
    preemption policy armed, lower-priority sequences were evicted first —
    a ``CapacityError`` then means eviction could not free enough)."""


class KVCacheStateError(ServingError, RuntimeError):
    """KV-cache bookkeeping invariant violated (double free, shrink below
    zero). Indicates a caller bug, not load — never retry."""


class DeadlineExceeded(ServingError, TimeoutError):
    """One or more sequences blew their per-request wall-clock budget.
    Raised by ``step()`` BEFORE any device work."""


class QueueOverflow(CapacityError):
    """A request queue is full: admission control rejected the submit."""


class ReplicaUnavailable(CapacityError):
    """No replica is able to take the request."""


class HandoffError(ServingError, RuntimeError):
    """A disaggregated prefill→decode handoff failed."""


class Cancelled(ServingError):
    """The request was cancelled."""


class StepFailure(ServingError, RuntimeError):
    """A device step (prefill or decode) raised. Host-side adapter and
    cache-manager bookkeeping was rolled back to the pre-call state before
    this propagates. The original exception rides along as ``__cause__``;
    :attr:`phase` is ``"prefill"`` or ``"decode"``; :attr:`seq_ids` names
    the rows in the failed call.

    :attr:`retry_safe` is True when the failure happened before the step
    touched the KV cache. The port updates the cache IN PLACE, so a
    failure after the step began writing leaves the cache undefined and
    ``retry_safe`` is False."""

    def __init__(self, msg: str, phase: str = "",
                 seq_ids: Sequence[int] = (), retry_safe: bool = True):
        super().__init__(msg, seq_ids)
        self.phase = phase
        self.retry_safe = retry_safe
