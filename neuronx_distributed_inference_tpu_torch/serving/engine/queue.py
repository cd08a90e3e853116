"""Multi-tenant admission queue (a copy of
``neuronx_distributed_inference_tpu/serving/engine/queue.py``): priority
classes within a tenant,
weighted-fair scheduling across tenants, a starvation bound, and in-queue
deadline expiry.

Scheduling contract (README "Serving engine"):

  * **Across tenants — weighted fair slots.** Each tenant has a weight
    (default 1.0). When the engine has ``k`` free batch slots it fills
    them one at a time, each time picking the tenant whose
    ``occupied_slots / weight`` ratio is lowest (ties broken by oldest
    head request), so steady-state running-slot shares — and therefore
    per-tenant token throughput under continuous batching — converge to
    the weight ratios. Fairness is over SLOTS, not over requests: a
    tenant cannot buy throughput by splitting work into more requests.
  * **Within a tenant — strict priority, then FIFO.** Higher ``priority``
    values run first; equal priorities are served in arrival order.
    Priorities are intra-tenant QoS: a tenant that floods its own
    high-priority lane starves only its own low-priority work.
  * **Starvation bound.** A tenant whose HEAD (next-to-run) request has
    waited longer than ``starvation_bound_s`` jumps the weighted-fair
    order for the next free slot (oldest such head first, across
    tenants), so a low weight or a burst elsewhere can delay but never
    indefinitely starve a tenant's lane. Keying on the head — not the
    tenant's oldest request overall — means a tenant cannot hold one
    stale low-priority request to permanently bypass weighted fairness.
  * **Deadline expiry in queue.** A queued request whose deadline passes
    is removed and typed-expired WITHOUT consuming any device work.
  * **Bounded depth.** ``push`` past ``max_depth`` raises the typed
    :class:`~...resilience.errors.QueueOverflow` before any state change;
    requeues of already-admitted work (preemption victims) bypass the
    bound so eviction can never deadlock against admission control.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...resilience.errors import ConfigurationError, QueueOverflow
from ...telemetry import get_registry
from ...telemetry import metrics as tmetrics
from .streams import TokenStream

__all__ = ["QueuedRequest", "MultiTenantQueue"]


@dataclass
class QueuedRequest:
    """One submitted request while it waits for (re-)admission.

    ``tokens`` is the CURRENT admission prompt: the original prompt, plus —
    after a preemption — every token generated before eviction (the
    recompute prompt from the :class:`~...resilience.Preempted` record).
    ``orig_prompt_len`` never changes; ``max_new_tokens`` budgets total
    GENERATED tokens across preemptions."""

    request_id: str
    tokens: List[int]
    max_new_tokens: int
    tenant: str
    priority: int
    deadline: Optional[float]          # absolute perf_counter(); None = ∞
    enqueue_t: float
    order: int                         # global arrival index (FIFO tiebreak)
    stream: TokenStream
    orig_prompt_len: int = 0
    stop_tokens: frozenset = frozenset()
    n_preemptions: int = 0
    meta: dict = field(default_factory=dict)
    # SLO-plane anchors (host wall clock; written only when the engine
    # has an SLOTracker attached — see scheduler.py)
    t_first: Optional[float] = None    # first token delivered
    t_last: Optional[float] = None     # latest token delivered
    last_enqueue_t: Optional[float] = None   # most recent (re)queue entry

    def sort_key(self) -> Tuple[int, int]:
        return (-self.priority, self.order)


class MultiTenantQueue:
    """Per-tenant priority heaps + the weighted-fair/starvation pop."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 max_depth: Optional[int] = 256,
                 starvation_bound_s: float = 2.0):
        self.weights = {t: float(w) for t, w in (weights or {}).items()}
        bad = {t: w for t, w in self.weights.items() if w <= 0}
        if bad or default_weight <= 0:
            # a zero weight reads as "deprioritize" but would divide by
            # zero in the fairness pick; starve-but-don't-kill intent is
            # a small positive weight + the starvation bound
            raise ConfigurationError(
                f"tenant weights must be > 0 (got {bad or default_weight}); "
                "use a small positive weight to deprioritize a tenant")
        self.default_weight = float(default_weight)
        self.max_depth = max_depth
        self.starvation_bound_s = float(starvation_bound_s)
        # degradation overlay (resilience/controller.py): a tenant whose
        # queue-wait SLO is burning gets its EFFECTIVE weight scaled down
        # without touching the configured weights, so releasing the
        # action restores the exact original fairness
        self._weight_scale: Dict[str, float] = {}
        self._heaps: Dict[str, List[Tuple[Tuple[int, int], QueuedRequest]]] \
            = {}
        self._order = itertools.count()

    # -- introspection -----------------------------------------------------
    @property
    def depth(self) -> int:
        return sum(len(h) for h in self._heaps.values())

    def depth_of(self, tenant: str) -> int:
        return len(self._heaps.get(tenant, ()))

    def weight_of(self, tenant: str) -> float:
        """The tenant's EFFECTIVE weight: configured (or default) weight
        times any degradation scale currently applied."""
        return (self.weights.get(tenant, self.default_weight)
                * self._weight_scale.get(tenant, 1.0))

    def set_weight_scale(self, tenant: str, scale: float = 1.0) -> None:
        """Scale a tenant's effective WFQ weight (degradation-controller
        hook — ``tighten_admission``). ``scale=1.0`` removes the overlay;
        the starvation bound still protects a scaled-down tenant."""
        if scale <= 0:
            raise ConfigurationError(
                f"weight scale must be > 0 (got {scale}); use a small "
                "positive scale to deprioritize a tenant")
        if scale == 1.0:
            self._weight_scale.pop(tenant, None)
        else:
            self._weight_scale[tenant] = float(scale)

    def next_order(self) -> int:
        return next(self._order)

    # -- mutation ----------------------------------------------------------
    def push(self, req: QueuedRequest, front: bool = False) -> None:
        """Enqueue. ``front=True`` (preemption requeue) bypasses the depth
        bound and keeps the request's ORIGINAL order/enqueue time, so the
        victim retains its age (and with it the starvation bound's
        protection) instead of going to the back of the line."""
        if (not front and self.max_depth is not None
                and self.depth >= self.max_depth):
            raise QueueOverflow(
                f"serving queue is full ({self.depth}/{self.max_depth}); "
                "shed or retry later")
        heapq.heappush(self._heaps.setdefault(req.tenant, []),
                       (req.sort_key(), req))
        self._tel_depth(req.tenant)

    def remove(self, request_id: str) -> Optional[QueuedRequest]:
        """Drop one queued request by id (cancellation); None if absent."""
        for tenant, heap in self._heaps.items():
            for i, (_, req) in enumerate(heap):
                if req.request_id == request_id:
                    heap[i] = heap[-1]
                    heap.pop()
                    heapq.heapify(heap)
                    self._tel_depth(tenant)
                    return req
        return None

    def expire(self, now: Optional[float] = None) -> List[QueuedRequest]:
        """Remove and return every queued request whose deadline has
        passed — BEFORE it costs any device work."""
        if now is None:
            now = time.perf_counter()
        out: List[QueuedRequest] = []
        for tenant, heap in self._heaps.items():
            live = [(k, r) for k, r in heap
                    if r.deadline is None or now < r.deadline]
            if len(live) != len(heap):
                out.extend(r for _, r in heap
                           if r.deadline is not None and now >= r.deadline)
                heap[:] = live
                heapq.heapify(heap)
                self._tel_depth(tenant)
        return out

    def pop_batch(self, slots: int, occupied: Dict[str, int],
                  now: Optional[float] = None) -> List[QueuedRequest]:
        """Take up to ``slots`` requests in weighted-fair order.

        ``occupied`` maps tenant -> batch slots it currently holds on the
        device (running + pending); each pick increments the local copy so
        one call filling several slots stays proportional."""
        if now is None:
            now = time.perf_counter()
        share = dict(occupied)
        picked: List[QueuedRequest] = []
        while len(picked) < slots:
            tenants = [t for t, h in self._heaps.items() if h]
            if not tenants:
                break
            starving = [t for t in tenants
                        if now - self._oldest(t) > self.starvation_bound_s]
            if starving:
                tenant = min(starving, key=self._oldest)
            else:
                tenant = min(
                    tenants,
                    key=lambda t: (share.get(t, 0) / self.weight_of(t),
                                   self._heaps[t][0][0]))
            _, req = heapq.heappop(self._heaps[tenant])
            self._tel_depth(tenant)
            share[tenant] = share.get(tenant, 0) + 1
            picked.append(req)
        return picked

    # -- helpers -----------------------------------------------------------
    def _oldest(self, tenant: str) -> float:
        """Enqueue time of the tenant's HEAD request — the one the next
        pop would take. Intra-tenant priority stays strict, so a buried
        low-priority request does not age the tenant's lane."""
        return self._heaps[tenant][0][1].enqueue_t

    def _tel_depth(self, tenant: str) -> None:
        reg = get_registry()
        if reg.enabled:
            tmetrics.queue_depth_gauge(reg).set(self.depth_of(tenant),
                                                tenant=tenant)
