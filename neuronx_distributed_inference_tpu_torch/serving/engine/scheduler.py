"""The closed-loop multi-tenant serving engine over the paged adapter
(counterpart: ``neuronx_distributed_inference_tpu/serving/engine/
scheduler.py``; ``run_pass`` :292).

:class:`ServingEngine` composes the adapter's serving primitives — typed
transactional admission, recompute preemption, per-request deadlines,
prefix caching with unwritten-block tracking, chunked prefill under
``prefill_budget_tokens`` or the ragged unified dispatch, ``step_many``,
and the telemetry contract — into the engine a load balancer talks to.

One :meth:`ServingEngine.run_pass` is the whole closed loop:

  1. **expire** queued requests past their deadline (typed, zero device
     work) and collect adapter preemption records into front-of-queue
     requeues (the :class:`~...resilience.Preempted` ``requeue`` payload —
     tokens, remaining deadline, tenant/priority meta — re-admits without
     side tables; greedy replay is bit-identical, pinned);
  2. **preempt** for priority: when the batch is full and a strictly
     higher-priority request is queued, evict the lowest-priority (then
     most recently admitted) victim via the adapter's public
     :meth:`~..adapter.PagedEngineAdapter.preempt` hook;
  3. **admit** up to ``free_capacity`` requests picked by the queue's
     weighted-fair/priority/starvation-bound order, sorted warm-prefix
     first (:meth:`~..adapter.PagedEngineAdapter.prefix_warmth` peeks the
     block-hash state read-only), as ONE transactional ``add_requests``
     call — chunked prefill under the adapter's budget knob keeps a long
     admission from stalling running decodes;
  4. **dispatch** one decode horizon (``step``/``step_many``) for every
     eligible running row — skipping consumers over their backpressure
     bound — and route tokens to per-request streams.

The engine is synchronous at its core (drive it with :meth:`run_pass` /
:meth:`run_until_drained` from tests and benches); its asyncio loop
``run_forever`` waits with the HTTP front door. The per-tenant SLO
tracker (``slo=``) and the degradation controller (``degradation=``) are
not ported yet: the constructor refuses them.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ...resilience.errors import (AdmissionError, CapacityError,
                                  ConfigurationError, DeadlineExceeded,
                                  ServingError, StepFailure)
from ...telemetry import get_registry
from ...telemetry import metrics as tmetrics
from ...telemetry.request_trace import new_trace_id, trace_of
from ...telemetry.trace import get_recorder as _get_recorder
from .queue import MultiTenantQueue, QueuedRequest
from .streams import TokenStream

__all__ = ["ServingEngine", "admission_headroom"]


def admission_headroom(adapter) -> Dict[str, int]:
    """The scheduler's capacity-reject log line: free batch slots, free
    KV blocks, and the token headroom they represent (a copy of
    ``neuronx_distributed_inference_tpu/serving/warmup.py``
    ``admission_headroom`` :367-376; the warm-up plane is not ported)."""
    out = {"free_slots": int(getattr(adapter, "free_capacity", 0))}
    mgr = getattr(getattr(adapter, "app", None), "kv_mgr", None)
    if mgr is not None:
        free = int(mgr.allocator.num_free)
        out["free_blocks"] = free
        out["headroom_tokens"] = free * int(mgr.spec.block_size)
    return out


class ServingEngine:
    """Multi-tenant scheduler + streaming front door over a
    :class:`~..adapter.PagedEngineAdapter`.

    ``tenant_weights`` maps tenant name -> weight (unlisted tenants get
    ``default_weight``); running-slot shares converge to the weight ratios
    under backlog (see ``queue.py`` for the full fairness contract).
    ``decode_steps_per_pass > 1`` fuses that many decode steps per pass
    through ``step_many`` (one dispatch + one fetch), clamped so no row
    can overshoot its token budget or the compiled ``seq_len``.
    ``max_unread_tokens`` bounds how far a stream may run ahead of its
    consumer before the engine stops stepping that sequence (None = no
    backpressure). ``priority_preemption=False`` disables scheduler-driven
    eviction (the adapter's own KV-pressure preemption still applies)."""

    def __init__(self, adapter, *,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 max_queue_depth: Optional[int] = 256,
                 starvation_bound_s: float = 2.0,
                 max_unread_tokens: Optional[int] = None,
                 decode_steps_per_pass: int = 1,
                 priority_preemption: bool = True,
                 debug_dump_dir: Optional[str] = None,
                 slo=None, degradation=None):
        for hook in ("take_preempted", "preempt", "prefix_warmth",
                     "free_capacity", "pending_prefill_ids"):
            if not hasattr(adapter, hook):
                raise ConfigurationError(
                    "ServingEngine needs the paged adapter surface "
                    f"(missing {hook!r}); build it over a "
                    "PagedEngineAdapter")
        if decode_steps_per_pass < 1:
            raise ConfigurationError("decode_steps_per_pass must be >= 1")
        waiting = [name for name, v in (("slo=", slo),
                                        ("degradation=", degradation))
                   if v is not None]
        if waiting:
            raise ConfigurationError(
                "the PyTorch port's engine does not run these yet: "
                + ", ".join(waiting) + " (ROADMAP queue item 1: "
                "telemetry/slo.py and resilience/controller.py)")
        self.adapter = adapter
        self.queue = MultiTenantQueue(tenant_weights, default_weight,
                                      max_queue_depth, starvation_bound_s)
        self.decode_steps_per_pass = decode_steps_per_pass
        self.max_unread_tokens = max_unread_tokens
        self.priority_preemption = priority_preemption
        # post-mortem artifacts: when set, an unrecoverable StepFailure
        # writes dump_debug_state() here before the engine closes
        self.debug_dump_dir = debug_dump_dir
        self._active: Dict[int, QueuedRequest] = {}     # seq_id -> request
        self._sid_of: Dict[str, int] = {}               # request_id -> seq
        self._seq_ids = itertools.count()
        self._rid_counter = itertools.count()
        self._reserved: List[str] = []   # rids owed the next freed slots
        self._closed = False
        try:
            self._max_prompt = adapter.app.tpu_config.seq_len
        except AttributeError:
            self._max_prompt = None
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "expired_queue": 0,
            "expired_running": 0, "cancelled": 0, "preempt_requeues": 0,
            "priority_preemptions": 0, "admission_retries": 0,
            "capacity_stalls": 0, "step_retries": 0}

    # -- public surface ----------------------------------------------------
    def submit(self, tokens: Sequence[int], max_new_tokens: int, *,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None,
               stop_tokens: Sequence[int] = (),
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               adapter: Optional[str] = None) -> TokenStream:
        """Enqueue one request; returns its :class:`TokenStream`
        immediately (no device work happens here). Raises the typed
        :class:`~...resilience.errors.QueueOverflow` when the queue is at
        ``max_queue_depth`` and :class:`AdmissionError` for malformed
        arguments — both before any state change.

        ``trace_id`` continues an existing request trace (a fleet router
        or handoff continuation passes the original id); None mints a
        fresh one. The id rides ``meta["trace"]`` through the adapter,
        ``Preempted`` records and handoffs, so one trace follows the
        request across preemptions and replicas (see
        telemetry/request_trace.py).

        ``adapter`` names the request's LoRA adapter: it rides
        ``meta["adapter"]`` to the paged adapter, which resolves it to a
        pinned device slot at admission (README "Multi-LoRA serving") —
        no-op for engines without a lora_pool (the key is simply never
        read)."""
        if self._closed:
            raise ServingError("engine is closed")
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise AdmissionError("empty prompt")
        if self._max_prompt is not None and len(tokens) > self._max_prompt:
            # reject here, not at admission time: by then the request is
            # batched with innocent neighbours inside one transactional
            # add_requests call
            raise AdmissionError(
                f"prompt is {len(tokens)} tokens — beyond the compiled "
                f"seq_len {self._max_prompt}")
        if max_new_tokens < 1:
            raise AdmissionError("max_new_tokens must be >= 1")
        rid = (request_id if request_id is not None
               else f"r{next(self._rid_counter)}")
        if rid in self._sid_of or any(
                r.request_id == rid for r in self._queued()):
            raise AdmissionError(f"request_id {rid!r} already in flight")
        now = time.perf_counter()
        tid = trace_id if trace_id is not None else new_trace_id()
        stream = TokenStream(rid, tenant)
        req = QueuedRequest(
            request_id=rid, tokens=tokens, max_new_tokens=max_new_tokens,
            tenant=tenant, priority=priority,
            deadline=None if deadline_s is None else now + deadline_s,
            enqueue_t=now, order=self.queue.next_order(), stream=stream,
            orig_prompt_len=len(tokens),
            stop_tokens=frozenset(int(t) for t in stop_tokens),
            meta={"request_id": rid, "tenant": tenant,
                  "priority": priority, "trace": tid})
        if adapter is not None:
            req.meta["adapter"] = str(adapter)
        self.queue.push(req)         # may raise QueueOverflow
        stream._cancel_cb = lambda: self.cancel(rid)
        self.stats["submitted"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("trace.begin", cat="request", trace=tid,
                        request_id=rid, tenant=tenant,
                        prompt_len=len(tokens), deadline_s=deadline_s,
                        continued=trace_id is not None)
        return req.stream

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or running request: queued entries are dropped
        with zero device work; running sequences are released and their
        KV blocks reclaimed. Returns False when the id is unknown or
        already finished."""
        req = self.queue.remove(request_id)
        if req is not None:
            self._observe_wait(req, "cancelled")
            req.stream.finish("cancelled", req.stream.cancelled_error())
            self._finalize(req)
            self.stats["cancelled"] += 1
            return True
        sid = self._sid_of.get(request_id)
        if sid is None:
            return False
        req = self._retire(sid)
        self.adapter.release([sid])
        req.stream.finish("cancelled", req.stream.cancelled_error())
        self._finalize(req)
        self.stats["cancelled"] += 1
        return True

    def submit_record(self, rec, max_new_tokens: int, *,
                      stop_tokens: Sequence[int] = (),
                      request_id: Optional[str] = None) -> TokenStream:
        """Submit one :class:`~...resilience.Preempted` record — the
        fleet router's replica-failover path, riding the same
        ``admission_kwargs()`` requeue contract the in-engine preemption
        requeue uses: the record's tokens are the recompute prompt, its
        remaining deadline budget carries over, and tenant/priority come
        from the meta passthrough. ``max_new_tokens`` is the REMAINING
        token budget (the caller already delivered the rest)."""
        kw = rec.admission_kwargs()
        meta = kw["meta"][0] if isinstance(kw["meta"][0], dict) else {}
        return self.submit(
            kw["prompts"][0], max_new_tokens,
            tenant=str(meta.get("tenant", "default")),
            priority=int(meta.get("priority", 0)),
            deadline_s=kw["deadline_s"][0], stop_tokens=stop_tokens,
            request_id=request_id, trace_id=trace_of(meta),
            adapter=meta.get("adapter"))

    @property
    def has_work(self) -> bool:
        return bool(self._active) or self.queue.depth > 0

    def run_pass(self) -> int:
        """One closed-loop scheduling pass (see the module docstring).
        Returns the number of tokens delivered to streams. With the flight
        recorder enabled each stage lands as a ``pass.*`` complete slice
        on the trace timeline (stable names: ``pass.expire``,
        ``pass.preempt``, ``pass.admit``, ``pass.dispatch``; the adapter
        adds ``dispatch.*``/``fetch.*`` inside the dispatch slice)."""
        now = time.perf_counter()
        rec = _get_recorder()            # disabled: span() is a no-op CM
        with rec.span("pass.expire", cat="engine"):
            self._expire_queue(now)
        with rec.span("pass.preempt", cat="engine"):
            self._collect_preempted()
            self._priority_preempt()
        with rec.span("pass.admit", cat="engine"):
            self._admit(now)
            # admission may itself have preempted running victims for
            # blocks (reason="admission"): requeue them before the
            # dispatch stage so their dead seq_ids never reach a step call
            self._collect_preempted()
        with rec.span("pass.dispatch", cat="engine"):
            return self._dispatch_engine_pass()

    def run_until_drained(self, max_passes: int = 100000) -> None:
        """Drive :meth:`run_pass` until no queued or running work remains
        (closed-loop tests and benches). Raises :class:`StepFailure` if
        the device dies unrecoverably mid-drive."""
        passes = 0
        while self.has_work:
            self.run_pass()
            passes += 1
            if passes >= max_passes:
                raise ServingError(
                    f"run_until_drained made no progress in {max_passes} "
                    "passes — scheduler wedged (file a bug with the "
                    "engine stats)", seq_ids=tuple(self._active))

    def close(self) -> None:
        """Stop serving and fail over remaining work: queued and running
        requests finish with reason "cancelled"."""
        self._closed = True
        for req in list(self._queued()):
            self.queue.remove(req.request_id)
            req.stream.finish("cancelled", req.stream.cancelled_error())
            self._finalize(req)
        for sid in list(self._active):
            req = self._retire(sid)
            self.adapter.release([sid])
            req.stream.finish("cancelled", req.stream.cancelled_error())
            self._finalize(req)

    # -- pass stages -------------------------------------------------------
    def _expire_queue(self, now: float) -> None:
        rec = _get_recorder()
        for req in self.queue.expire(now):
            self._observe_wait(req, "expired")
            reg = get_registry()
            if reg.enabled:
                tmetrics.deadline_expired_counter(reg).inc(
                    engine="queue", tenant=req.tenant)
            err = DeadlineExceeded(
                f"request {req.request_id} expired after "
                f"{now - req.enqueue_t:.3f}s in queue")
            if rec.enabled:
                rec.error(err, request_id=req.request_id,
                          tenant=req.tenant, where="queue")
            req.stream.finish("deadline", err)
            self._finalize(req)
            self.stats["expired_queue"] += 1

    def _collect_preempted(self) -> None:
        for rec in self.adapter.take_preempted():
            self._requeue(rec)

    def _requeue(self, rec) -> None:
        """Turn one :class:`Preempted` record back into a queued request
        via its requeue payload. Tokens the victim generated before
        eviction are part of the recompute prompt — any not yet delivered
        (sampled while in flight) are delivered now, and the budget
        counts them."""
        meta = rec.meta or {}
        rid = meta.get("request_id")
        req = self._active.get(rec.seq_id)
        if req is None or rid != req.request_id:
            return                   # not engine-owned (foreign caller)
        del self._active[rec.seq_id]
        del self._sid_of[rid]
        generated = list(rec.tokens[req.orig_prompt_len:])
        already = req.stream.n_tokens
        done = False
        for tok in generated[already:]:
            req.stream.put(tok)
            done = self._hit_limit(req, tok)
            if done:
                break
        if done:
            self._finalize(req)
            self.stats["completed"] += 1
            return
        req.tokens = list(rec.tokens)
        req.deadline = rec.deadline
        req.n_preemptions += 1
        # the queue-wait clock restarts here: time already spent RUNNING
        # must not count as queue wait after the requeue
        req.last_enqueue_t = time.perf_counter()
        self.queue.push(req, front=True)
        self.stats["preempt_requeues"] += 1
        trec = _get_recorder()
        if trec.enabled:
            trec.instant("trace.requeue", cat="request",
                         trace=trace_of(req.meta),
                         request_id=req.request_id, reason=rec.reason,
                         n_delivered=req.stream.n_tokens)

    def _priority_preempt(self) -> None:
        """When the batch is full and a strictly higher-priority request
        waits, evict the lowest-priority victim (ties: most recently
        submitted) through the adapter hook and requeue it at the front
        of its tenant's lane. The freed slot is RESERVED for the request
        that justified the eviction — without the reservation, weighted
        fairness could hand the slot straight back to the victim and
        livelock in an evict/re-prefill cycle while the high-priority
        request starves."""
        if not self.priority_preemption:
            return
        while self.adapter.free_capacity == 0 and self._active:
            best = max(self._queued(),
                       key=lambda r: (r.priority, -r.order), default=None)
            if best is None:
                return
            victim_sid, victim = min(
                self._active.items(),
                key=lambda kv: (kv[1].priority, -kv[1].order))
            if victim.priority >= best.priority:
                return               # nothing strictly lower-priority
            rec = self.adapter.preempt(victim_sid, reason="scheduler")
            self.stats["priority_preemptions"] += 1
            self._requeue(rec)
            self._reserved.append(best.request_id)

    def _admit(self, now: float) -> None:
        cap = self.adapter.free_capacity
        if cap <= 0 or self.queue.depth == 0:
            self._reserved.clear()
            return
        # slots freed by priority preemption go to the requests that
        # justified the evictions, ahead of the weighted-fair pick
        batch: List[QueuedRequest] = []
        for rid in self._reserved:
            if len(batch) >= cap:
                break
            req = self.queue.remove(rid)   # None: cancelled/expired since
            if req is not None:
                batch.append(req)
        self._reserved.clear()
        if len(batch) < cap:
            occupied: Dict[str, int] = {}
            for req in self._active.values():
                occupied[req.tenant] = occupied.get(req.tenant, 0) + 1
            for req in batch:
                occupied[req.tenant] = occupied.get(req.tenant, 0) + 1
            batch.extend(self.queue.pop_batch(cap - len(batch), occupied,
                                              now))
        if not batch:
            return
        # warm-prefix-first admission ordering: stable sort keeps the
        # fairness pick order among equally-warm requests, and puts warm
        # prompts ahead so intra-call shared prefixes hit originator-first
        batch.sort(key=lambda r: -self.adapter.prefix_warmth(r.tokens))
        try:
            first = self._add_batch(batch, now)
        except DeadlineExceeded:
            # a zero-remaining budget expired inside admission: retry the
            # expiry stage next pass (adapter rolled the call back)
            for r in reversed(batch):
                self.queue.push(r, front=True)
            self.stats["admission_retries"] += 1
            return
        except AdmissionError:
            # one bad request must not sink its innocent batch neighbours
            # (or the serving loop): isolate it by admitting one-by-one
            first = {}
            for r in batch:
                try:
                    first.update(self._add_batch([r], now))
                except AdmissionError as e:
                    r.stream.finish("error", e)
                    self._finalize(r)
                except (DeadlineExceeded, CapacityError, StepFailure) as e:
                    if isinstance(e, StepFailure) and not e.retry_safe:
                        self._fatal(e)
                        raise
                    self.queue.push(r, front=True)
                    self.stats["admission_retries"] += 1
        except (CapacityError, StepFailure) as e:
            if isinstance(e, StepFailure) and not e.retry_safe:
                self._fatal(e)
                raise
            # pool dry even after the adapter's own eviction, or a
            # retry-safe fault: requeue and try again next pass
            for r in reversed(batch):
                self.queue.push(r, front=True)
            self.stats["admission_retries"] += 1
            if isinstance(e, CapacityError):
                self._note_headroom("admit")
            return
        for sid, tok in first.items():   # non-deferred adapters
            self._deliver(sid, [tok])

    def _add_batch(self, batch: List[QueuedRequest],
                   now: float) -> Dict[int, int]:
        """One transactional add_requests call; registers the admitted
        requests and returns the adapter's first-token dict (empty under
        a deferred prefill budget)."""
        sids = [next(self._seq_ids) for _ in batch]
        first = self.adapter.add_requests(
            sids, [r.tokens for r in batch],
            deadline_s=[None if r.deadline is None
                        else max(r.deadline - now, 0.0) for r in batch],
            meta=[r.meta for r in batch])
        rec = _get_recorder()
        for sid, req in zip(sids, batch):
            self._active[sid] = req
            self._sid_of[req.request_id] = sid
            self._observe_wait(req, "admitted")
            if rec.enabled:
                # wait_s measures from the most recent (re)queue entry,
                # matching the SLO queue-wait sample for this admission
                since = (req.last_enqueue_t
                         if req.last_enqueue_t is not None
                         else req.enqueue_t)
                rec.instant("trace.admit", cat="request",
                            trace=trace_of(req.meta),
                            request_id=req.request_id, seq_id=int(sid),
                            wait_s=now - since)
        return first

    def _dispatch_engine_pass(self) -> int:
        """Drive one decode horizon and route tokens to streams. This is
        the engine's dispatch-driving loop: it must not read device values
        — every token it touches is already a host int handed back by the
        adapter."""
        pending = set(self.adapter.pending_prefill_ids)
        alive = self.adapter.seqs
        eligible: List[int] = []
        horizon = self.decode_steps_per_pass
        # ragged adapter: the pass budgets by TOKENS-DELIVERED, not steps
        # — each row gets its remaining token budget as a per-row width
        # clamp (decode_steps_per_pass > 1 caps it), and the pass stays
        # one engine step: ONE materialized mixed prefill+decode dispatch
        # planned by the RaggedBatchPlanner (serving/ragged/)
        ragged = getattr(self.adapter, "_ragged", None)
        room: Dict[int, int] = {}
        for sid, req in self._active.items():
            if sid not in alive and sid not in pending:
                continue             # preempted, record not collected yet
            if sid in pending:
                eligible.append(sid)   # wants prefill progress, no decode
                continue
            if (self.max_unread_tokens is not None
                    and req.stream.unread >= self.max_unread_tokens):
                continue               # backpressure: consumer is behind
            r = self._room(sid, req)
            if ragged is not None:
                room[sid] = (min(r, self.decode_steps_per_pass)
                             if self.decode_steps_per_pass > 1 else r)
            else:
                horizon = min(horizon, r)
            eligible.append(sid)
        if not eligible:
            # first tokens a failed step left undelivered (the eager
            # adapters keep no dispatch in flight)
            return self._route(self.adapter.flush())
        try:
            if ragged is not None:
                res = self.adapter.step(eligible, token_room=room)
            elif horizon > 1:
                res = self.adapter.step_many(horizon, eligible)
            else:
                res = {s: [t] for s, t in
                       self.adapter.step(eligible).items()}
        except DeadlineExceeded as e:
            self._expire_running(e.seq_ids)
            return 0
        except CapacityError as e:
            if e.seq_ids:
                self._finish_capacity(e.seq_ids)
            else:
                self.stats["capacity_stalls"] += 1
            self._note_headroom("step")
            return 0
        except StepFailure as e:
            if e.retry_safe:
                self.stats["step_retries"] += 1
                return 0
            self._fatal(e)
            raise
        return self._route(res)

    # -- token routing -----------------------------------------------------
    def _route(self, res) -> int:
        n = 0
        for sid, toks in res.items():
            toks = toks if isinstance(toks, list) else [toks]
            n += self._deliver(sid, toks)
        if n:
            rec = _get_recorder()
            if rec.enabled:
                rec.instant("stream.deliver", cat="engine", tokens=n,
                            seq_ids=[int(s) for s in res])
        return n

    def _deliver(self, sid: int, toks: List[int]) -> int:
        req = self._active.get(sid)
        if req is None:
            return 0                 # raced with cancel/preempt
        n = 0
        done = False
        for tok in toks:
            req.stream.put(tok)
            n += 1
            if self._hit_limit(req, tok):
                self._retire(sid)
                self.adapter.release([sid])
                self.stats["completed"] += 1
                done = True
                break
        if done:
            self._finalize(req)
        return n

    def _hit_limit(self, req: QueuedRequest, tok: int) -> bool:
        if tok in req.stop_tokens:
            req.stream.finish("stop")
            return True
        if req.stream.n_tokens >= req.max_new_tokens:
            req.stream.finish("length")
            return True
        return False

    def _room(self, sid: int, req: QueuedRequest) -> int:
        """Largest decode horizon this row can take without overshooting
        its token budget or the compiled seq_len."""
        room = req.max_new_tokens - req.stream.n_tokens
        st = self.adapter.seqs.get(sid)
        limit = getattr(self.adapter, "_pos_limit", None)
        if st is not None and limit is not None:
            room = min(room, limit - st.position)
        return max(room, 1)

    # -- terminal paths ----------------------------------------------------
    def _retire(self, sid: int) -> QueuedRequest:
        req = self._active.pop(sid)
        self._sid_of.pop(req.request_id, None)
        return req

    def _expire_running(self, seq_ids: Sequence[int]) -> None:
        for sid in seq_ids:
            if sid not in self._active:
                continue
            req = self._retire(sid)
            self.adapter.release([sid])
            req.stream.finish("deadline", DeadlineExceeded(
                f"request {req.request_id} exceeded its deadline while "
                "running"))
            self._finalize(req)
            self.stats["expired_running"] += 1

    def _finish_capacity(self, seq_ids: Sequence[int]) -> None:
        for sid in seq_ids:
            if sid not in self._active:
                continue
            req = self._retire(sid)
            self.adapter.release([sid])
            req.stream.finish("capacity", CapacityError(
                f"request {req.request_id} reached the compiled seq_len",
                seq_ids=(sid,)))
            self._finalize(req)

    def _fatal(self, err: StepFailure) -> None:
        """Unrecoverable device failure: every stream is failed; the
        adapter (and its application) must be rebuilt before serving.
        With ``debug_dump_dir`` set, the post-mortem (flight-recorder tail
        + engine/adapter snapshot) is written BEFORE the teardown empties
        the state it describes."""
        if self.debug_dump_dir is not None:
            try:
                self.dump_debug_state(
                    os.path.join(self.debug_dump_dir,
                                 f"nxdi_postmortem_{id(err):x}.json"),
                    error=err)
            except Exception:
                # the dump must never mask the error OR abort the stream
                # teardown below (e.g. a non-JSON-able recorded arg)
                pass
        self._closed = True
        for sid in list(self._active):
            req = self._retire(sid)
            req.stream.finish("error", err)
            self._finalize(req)
        for req in list(self._queued()):
            self.queue.remove(req.request_id)
            req.stream.finish("error", err)
            self._finalize(req)

    def _note_headroom(self, where: str) -> None:
        """Flight-record the admission-headroom estimate at the moment a
        capacity reject happens — free batch slots, free KV blocks and
        the token headroom they represent (:func:`admission_headroom`),
        so post-mortems can tell a full pool from a fragmented one."""
        rec = _get_recorder()
        if not rec.enabled:
            return
        try:
            rec.instant("admission.headroom", cat="engine", where=where,
                        **admission_headroom(self.adapter))
        except Exception:
            # best-effort observability: a broken estimate must never
            # turn a capacity stall into an engine fault
            pass

    # -- post-mortem surface ----------------------------------------------
    def debug_state(self) -> Dict[str, Any]:
        """Read-only JSON-able snapshot of the scheduler + adapter:
        per-tenant queue depths, active requests (seq_id, tenant,
        priority, delivered tokens), reservation state and the adapter's
        own view (running/pending ids, block occupancy, pipeline depth).
        Served live by ``GET /v1/debug/state``."""
        per_tenant = {t: self.queue.depth_of(t)
                      for t in self.queue._heaps if self.queue.depth_of(t)}
        active = {
            int(sid): {"request_id": req.request_id, "tenant": req.tenant,
                       "priority": req.priority,
                       "n_tokens": req.stream.n_tokens,
                       "max_new_tokens": req.max_new_tokens,
                       "n_preemptions": req.n_preemptions}
            for sid, req in self._active.items()}
        adapter = (self.adapter.debug_state()
                   if hasattr(self.adapter, "debug_state") else {})
        out = {
            "closed": self._closed,
            "stats": dict(self.stats),
            "queue": {"depth": self.queue.depth, "per_tenant": per_tenant},
            "active": active,
            "reserved": list(self._reserved),
            "adapter": adapter,
        }
        return out

    def dump_debug_state(self, path: Optional[str] = None,
                         error: Optional[BaseException] = None,
                         trace_tail: int = 256) -> Dict[str, Any]:
        """Assemble (and optionally write) one post-mortem artifact: the
        engine/adapter snapshot, the newest ``trace_tail`` flight-recorder
        events with the ring's own drop count (so the artifact states its
        truncation), and the failing error's identity + ``trace_id`` when
        one is given. Returns the JSON-able dict; writes it to ``path``
        when provided (parent directories are created)."""
        rec = _get_recorder()
        dump: Dict[str, Any] = {
            "schema": "nxdi-debug-state-v1",
            "error": None if error is None else {
                "type": type(error).__name__,
                "message": str(error),
                "seq_ids": [int(s) for s in
                            getattr(error, "seq_ids", ()) or ()],
                "phase": getattr(error, "phase", None),
                "retry_safe": getattr(error, "retry_safe", None),
                "trace_id": getattr(error, "trace_id", None),
            },
            "engine": self.debug_state(),
            "trace": {
                "enabled": rec.enabled,
                "events": rec.tail(trace_tail),
                "dropped": rec.dropped,
                "capacity": rec.capacity,
            },
        }
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as fh:
                json.dump(dump, fh, indent=1)
            dump["artifact_path"] = path
        return dump

    # -- helpers -----------------------------------------------------------
    def _queued(self):
        for heap in self.queue._heaps.values():
            for _, req in heap:
                yield req

    def _observe_wait(self, req: QueuedRequest, outcome: str) -> None:
        now = time.perf_counter()
        reg = get_registry()
        if reg.enabled:
            tmetrics.queue_wait_histogram(reg).observe(
                now - req.enqueue_t,
                tenant=req.tenant, outcome=outcome)

    def _finalize(self, req: QueuedRequest) -> None:
        """Terminal request bookkeeping shared by every finish path: the
        ``trace.emit`` lifecycle event."""
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("trace.emit", cat="request",
                        trace=trace_of(req.meta),
                        request_id=req.request_id, tenant=req.tenant,
                        reason=req.stream.finish_reason,
                        n_tokens=req.stream.n_tokens)
