"""Deterministic fault-injection harness for the serving surface — a copy
of ``neuronx_distributed_inference_tpu/resilience/faults.py``. The port's
adapters traverse ``slow_step``, ``decode_step``, ``prefill_chunk``,
``spec_draft``, ``spec_verify`` and ``ragged_step``; the other points keep
their names and never fire here.

Named fault points are compiled into the adapters and the paged cache
manager; arming one makes the Nth traversal of that point fail (or stall)
deterministically, so every recovery path — admission rollback, preemption,
deadline expiry, step retry — is exercised by fast CPU tests.

Usage::

    from neuronx_distributed_inference_tpu_torch.resilience import FAULTS

    with FAULTS.inject("paged_alloc", nth=2) as fp:
        adapter.add_requests([0, 1], [p0, p1])   # 2nd block alloc fails
    assert fp.trips == 1

Fault points (a STABLE contract, like the telemetry metric names):

  ``paged_alloc``    block allocation in ``BlockKVCacheManager``
                     (``begin_sequence`` / ``grow``) — default raises
                     :class:`~.errors.CapacityError`, indistinguishable
                     from a genuinely exhausted pool
  ``prefill_step``   the device prefill call inside ``add_requests``
  ``prefill_chunk``  one packed chunk dispatch of the paged adapter's
                     chunked prefill path — fires BEFORE the dispatch, so
                     rollback of partially-prefilled sequences (progress
                     made by earlier chunks) is exercised deterministically
  ``decode_step``    the device decode call inside ``step()`` — fires
                     AFTER host-side KV growth, so it proves rollback
  ``slow_step``      start of ``step()`` — sleeps ``delay_s`` instead of
                     raising (drives deadline expiry deterministically)
  ``pipeline_flush`` the deferred token fetch of the pipelined decode path
                     (``pipeline_depth >= 1``) — fires where a genuine
                     asynchronous device failure from the PREVIOUS dispatch
                     would surface, so lookahead rollback is testable
                     deterministically
  ``spec_draft``     the draft pass of a speculative serving step
                     (serving/speculation/) — fires AFTER per-row KV
                     growth, so draft-failure rollback (blocks shrunk,
                     positions untouched) is provable
  ``spec_verify``    the batched k+1-token verify dispatch of a
                     speculative step — fires after the draft pass wrote
                     its KV, so mid-verify failure must roll EVERY packed
                     row back to its last accepted token (no
                     half-accepted cache poisoning)
  ``ragged_step``    THE unified mixed dispatch of a ragged engine step
                     (serving/ragged/) — fires AFTER per-row KV growth
                     and the draft pass, so a failure must roll EVERY
                     packed row back to its last accepted/delivered
                     token: live rows' growth shrunk with positions
                     untouched, prefill rows aborted exactly like a
                     failed chunk dispatch
  ``kv_spill``       a block payload spill into the host-RAM KV tier
                     (serving/fleet/kv_tier.py) — spills are best-effort:
                     a trip is swallowed by the adapter's spill hook and
                     counted (``tier.stats["spill_errors"]``), never
                     failing the allocation that evicted the block
  ``kv_restore``     the device write that re-admits spilled block
                     payloads inside ``add_requests`` — fires BEFORE the
                     write, so the transactional admission rollback
                     (nothing admitted, free pool restored exactly) is
                     provable; retry heals
  ``handoff``        a prefill→decode handoff (serving/fleet/handoff.py),
                     fired on BOTH capture and admit — either side fails
                     typed (:class:`~.errors.HandoffError`) with its
                     engine state unchanged
  ``migrate_capture`` the source-side capture of a live decode→decode
                     migration (serving/fleet/handoff.py ``migrate``) —
                     fires BEFORE any source state changes, so a trip
                     leaves BOTH engines untouched and the un-migrated
                     stream keeps serving on the source
  ``migrate_admit``  the destination-side admission of a migration —
                     fires BEFORE the tier seed and the transactional
                     re-admission, so a trip leaves the destination's
                     free pool exact and the source still serving
                     (typed :class:`~.errors.HandoffError` either way)
  ``autoscale``      one FleetAutoscaler evaluation
                     (serving/fleet/autoscaler.py) — a trip aborts that
                     evaluation (no spawn, no retire) with the fleet
                     unchanged; serving is never disturbed
  ``adapter_swap``   the device write of a LoRA adapter swap
                     (serving/lora_pool.py) — fires AFTER the pre-swap
                     snapshot and BEFORE the stacked-slot write, so the
                     transactional rollback (every touched stacked leaf
                     restored, slot returned to the free list, no
                     resident slot corrupted) is provable; surfaces as a
                     retry-safe typed :class:`~.errors.StepFailure`
                     (``phase="adapter_swap"``), so retry heals
  ``adapter_spill``  the device→host copy of an evicted adapter slot's
                     (A,B) factors into the pool's bounded host cache —
                     spills are best-effort: a trip is swallowed and
                     counted (``pool.stats["spill_errors"]``), never
                     failing the acquisition whose eviction triggered it
                     (the re-acquire just pays a cold checkpoint load)

Hot-path cost while nothing is armed: a single attribute check
(``FAULTS.active``) — no call, no allocation (pinned by
``tests/test_resilience.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .errors import CapacityError

__all__ = ["FAULT_POINTS", "FAULTS", "FaultInjector", "InjectedFault"]

FAULT_POINTS = ("paged_alloc", "prefill_step", "prefill_chunk",
                "decode_step", "slow_step", "pipeline_flush",
                "spec_draft", "spec_verify", "ragged_step",
                "kv_spill", "kv_restore", "handoff",
                "migrate_capture", "migrate_admit", "autoscale",
                "adapter_swap", "adapter_spill")


class InjectedFault(RuntimeError):
    """Default exception raised by an armed step fault point. Deliberately
    NOT a :class:`~.errors.ServingError`: it models an unexpected low-level
    failure, which the adapters must wrap into a typed
    :class:`~.errors.StepFailure` at the boundary."""


def _default_exc(point: str) -> Exception:
    if point == "paged_alloc":
        # must look exactly like a real pool-dry failure so the recovery
        # path under test is the production one
        return CapacityError("out of KV cache blocks (injected fault)")
    return InjectedFault(f"injected fault at point {point!r}")


class FaultPoint:
    """One arming of one fault point. Context manager: armed on
    ``__enter__``, disarmed on ``__exit__``. Exposes :attr:`calls` (times
    the point was traversed while armed) and :attr:`trips` (times the
    fault actually fired) for test assertions."""

    def __init__(self, injector: "FaultInjector", point: str, nth: int,
                 times: int, delay_s: Optional[float],
                 exc_factory: Optional[Callable[[], Exception]]):
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known points: "
                             f"{FAULT_POINTS}")
        if nth < 1 or times < 1:
            raise ValueError("nth and times must be >= 1")
        self.injector = injector
        self.point = point
        self.nth = nth
        self.times = times
        self.delay_s = delay_s
        self.exc_factory = exc_factory
        self.calls = 0
        self.trips = 0

    def __enter__(self) -> "FaultPoint":
        self.injector._arm(self)
        return self

    def __exit__(self, *exc_info) -> bool:
        self.injector._disarm(self)
        return False

    def _hit(self):
        """Called by the injector on each traversal of the armed point."""
        self.calls += 1
        if not (self.nth <= self.calls < self.nth + self.times):
            return
        self.trips += 1
        if self.delay_s is not None:
            time.sleep(self.delay_s)
            return
        raise (self.exc_factory() if self.exc_factory is not None
               else _default_exc(self.point))


class FaultInjector:
    """Registry of armed fault points. The module-level singleton
    :data:`FAULTS` is the one the library's call sites consult; tests arm
    it via :meth:`inject`. At most one arming per point at a time."""

    def __init__(self):
        self.active = False            # the ONLY thing hot paths read
        self._armed: Dict[str, FaultPoint] = {}

    def inject(self, point: str, *, nth: int = 1, times: int = 1,
               delay_s: Optional[float] = None,
               exc_factory: Optional[Callable[[], Exception]] = None
               ) -> FaultPoint:
        """Build a :class:`FaultPoint` arming ``point`` to fire on calls
        ``nth .. nth+times-1`` (1-based). ``delay_s`` makes it sleep
        instead of raise; ``exc_factory`` overrides the default exception.
        Use as a context manager."""
        return FaultPoint(self, point, nth, times, delay_s, exc_factory)

    def _arm(self, fp: FaultPoint):
        if fp.point in self._armed:
            raise RuntimeError(f"fault point {fp.point!r} is already armed")
        self._armed[fp.point] = fp
        self.active = True

    def _disarm(self, fp: FaultPoint):
        if self._armed.get(fp.point) is fp:
            del self._armed[fp.point]
        self.active = bool(self._armed)

    def fire(self, point: str):
        """Traverse ``point``: no-op unless that point is armed. Call
        sites guard with ``if FAULTS.active:`` so this is never entered
        in an unarmed process."""
        fp = self._armed.get(point)
        if fp is not None:
            fp._hit()


FAULTS = FaultInjector()
