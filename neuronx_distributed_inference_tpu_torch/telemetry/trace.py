"""Flight recorder (a copy of
``neuronx_distributed_inference_tpu/telemetry/trace.py``) — a bounded,
lock-guarded ring of structured trace
events, the "what happened, in what order" layer on top of the metrics
registry ("how much / how often").

Every event carries a monotonic ``perf_counter()`` timestamp, a stable
``name``, a category lane (``engine`` — scheduler pass phases, ``adapter``
— dispatch/fetch boundaries, ``app`` — ``_run_*`` compile/execute,
``error`` — typed failures) and structured ``args`` (request / tenant /
seq_id labels). Two pure exporters:

  * :meth:`FlightRecorder.to_chrome` — Chrome trace-event JSON
    (``chrome://tracing`` / Perfetto loadable: ``traceEvents`` with
    ``ph="X"`` complete slices and ``ph="i"`` instants, one ``tid`` lane
    per category, timestamps in microseconds from the recorder epoch);
  * :meth:`FlightRecorder.to_jsonl` — one JSON object per line, for
    grep/jq post-mortems.

Event **names are a stable contract** exactly like the metric names in
``metrics.py`` — dashboards, the post-mortem tooling, and the golden test
(``tests/test_flight_recorder.py``) key on them; renames are breaking.
The canonical set lives in :data:`ENGINE_PASS_PHASES` /
:data:`ADAPTER_EVENTS` / :data:`APP_EVENTS`.

Disabled by default (the zero-cost contract): the module-global
recorder is a shared no-op (:data:`NULL_RECORDER`); instrumented call
sites pay one attribute check (``rec.enabled``) and never touch device
state — recording can change neither jit cache keys nor token streams
(pinned bit-identical by ``tests/test_flight_recorder.py``). When the ring
wraps, dropped events are counted (:attr:`FlightRecorder.dropped` plus the
``nxdi_trace_events_dropped_total{ring="trace"}`` counter when a live
metrics registry is installed) so a post-mortem states its own truncation
instead of silently starting mid-story.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

from .registry import get_registry

__all__ = [
    "ENGINE_PASS_PHASES", "ENGINE_EVENTS", "ADAPTER_EVENTS", "APP_EVENTS",
    "FLEET_EVENTS", "DEGRADE_EVENTS", "WARMUP_EVENTS", "EVENT_NAMES",
    "FlightRecorder", "NullFlightRecorder", "NULL_RECORDER",
    "get_recorder", "set_recorder", "enable_recorder", "disable_recorder",
]

#: Engine scheduling-pass phases, one complete slice per ``run_pass``
#: stage (serving/engine/scheduler.py). STABLE names.
ENGINE_PASS_PHASES = ("pass.expire", "pass.preempt", "pass.admit",
                      "pass.dispatch")

#: Other engine-lane events (serving/engine/scheduler.py). STABLE names.
#:   ``stream.deliver``         tokens routed to request streams
#:   ``admission.headroom``     the scheduler hit a capacity reject/stall;
#:                              carries the adapter's live admission-
#:                              headroom estimate (free_blocks,
#:                              headroom_tokens, free_slots)
ENGINE_EVENTS = ("stream.deliver", "admission.headroom")

#: Adapter boundary events (serving/adapter.py + serving/ragged/path.py).
#: STABLE names.
#:   ``dispatch.decode``        one decode dispatch (eager or pipelined)
#:   ``dispatch.decode_loop``   one fused step_many(k) dispatch
#:   ``dispatch.prefill_chunk`` one packed prefill-chunk dispatch
#:   ``dispatch.ragged``        THE unified mixed dispatch of a ragged
#:                              engine step (serving/ragged/; carries
#:                              per-row ``seq_ids`` and ``traces``)
#:   ``fetch.tokens``           a blocking device->host token fetch
#:   ``preempt``                one sequence evicted (any reason)
ADAPTER_EVENTS = ("dispatch.decode", "dispatch.decode_loop",
                  "dispatch.prefill_chunk", "dispatch.ragged",
                  "fetch.tokens", "preempt")

#: Application events (models/application.py). STABLE names.
#:   ``run.<kind>``   host window of one _run_* call (entry -> dispatch
#:                    return; asynchronous — excludes device wait)
#:   ``compile``      first-time (kind, bucket, shape) graph build
APP_EVENTS = ("run.prefill", "run.decode", "run.decode_loop", "run.paged",
              "run.paged_loop", "compile")

#: Fleet-layer events (serving/fleet/). STABLE names.
#:   ``fleet.route``    one request routed to a replica (request_id,
#:                      replica, warmth, affinity)
#:   ``fleet.drain``    a replica transitioned to draining/dead
#:                      (replica, state, reason)
#:   ``kv.spill``       one block payload spilled to the host-RAM tier
#:   ``kv.restore``     spilled block payloads restored to device at
#:                      admission (seq_id, blocks, tokens)
#:   ``handoff.send``   a prefill-role engine captured a handoff record
#:   ``handoff.recv``   a decode-role engine admitted a handoff record
#:   ``fleet.all_dead`` the LAST healthy replica left rotation — the
#:                      operator page (replica, reason, in_flight)
#:   ``fleet.scale_up`` the FleetAutoscaler added a replica (replica,
#:                      reason, n_compiles, queue, burn, free_slots)
#:   ``fleet.scale_down`` the FleetAutoscaler started retiring a replica
#:                      (replica, reason, migrated, queue, burn)
FLEET_EVENTS = ("fleet.route", "fleet.drain", "kv.spill", "kv.restore",
                "handoff.send", "handoff.recv", "fleet.all_dead",
                "fleet.scale_up", "fleet.scale_down")

#: Degradation-controller events (resilience/controller.py). STABLE
#: names; both carry ``tenant``, ``action`` and the deciding ``burn``.
#:   ``degrade.enter``  an action engaged (burn crossed the enter
#:                      threshold in BOTH windows)
#:   ``degrade.exit``   an action released (burn below the exit
#:                      threshold after the minimum hold)
DEGRADE_EVENTS = ("degrade.enter", "degrade.exit")

#: Request-trace lifecycle events (telemetry/request_trace.py +
#: serving/engine/scheduler.py + serving/fleet/router.py). STABLE names.
#: Every one carries ``trace`` — the request's stable trace id
#: (``meta["trace"]``), which also rides ``Preempted``/handoff records
#: across replicas so a continuation stitches onto the same trace.
#:   ``trace.begin``    frontend/router/engine ingress (request_id,
#:                      tenant, prompt_len, deadline_s)
#:   ``trace.admit``    the request left the queue into one transactional
#:                      admission (seq_id, wait_s)
#:   ``trace.requeue``  the request went back to a queue — preemption or
#:                      replica failover (reason, replica when fleet)
#:   ``trace.emit``     terminal emission (reason, n_tokens)
TRACE_EVENTS = ("trace.begin", "trace.admit", "trace.requeue",
                "trace.emit")

#: Cold-start / steady-state compile events (serving/warmup.py +
#: models/application.py). STABLE names.
#:   ``compile.unexpected``  a graph build AFTER precompile() declared
#:                           steady state — a tracked incident (kind,
#:                           bucket, sig, plus ``traces`` = the request
#:                           trace ids packed into the triggering
#:                           dispatch, so the incident lands on the
#:                           victims' trace lanes)
WARMUP_EVENTS = ("compile.unexpected",)

EVENT_NAMES = (ENGINE_PASS_PHASES + ENGINE_EVENTS + ADAPTER_EVENTS
               + APP_EVENTS + FLEET_EVENTS + TRACE_EVENTS
               + DEGRADE_EVENTS + WARMUP_EVENTS)

#: Category -> Chrome trace tid lane (deterministic ordering in the UI).
_CAT_TIDS = {"engine": 1, "adapter": 2, "app": 3, "error": 4, "fleet": 5,
             "request": 6}


class _TraceSpan:
    """Context manager handed out by :meth:`FlightRecorder.span`: records
    one complete event over the ``with`` body."""

    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: "FlightRecorder", name: str, cat: str,
                 args: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_TraceSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.complete(self._name, self._t0, cat=self._cat,
                           **self._args)


class FlightRecorder:
    """Bounded ring of structured events (see module docstring)."""

    enabled = True

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.epoch = time.perf_counter()   # chrome ts origin
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._ids = itertools.count()
        self.dropped = 0
        self._dropped_flushed = 0      # high-water mark already counted

    # -- recording ---------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> str:
        with self._lock:
            eid = ev["id"] = f"e{next(self._ids)}"
            self._events.append(ev)
            excess = len(self._events) - self.capacity
            if excess > 0:
                del self._events[:excess]
                self.dropped += excess
        return eid

    def _flush_drops(self) -> None:
        """Report accumulated ring evictions to the metrics registry.
        Deferred off the per-event hot path (once the ring is full EVERY
        push evicts) onto the read/export surfaces, where the count is
        actually consumed.

        Accounting is delta-against-a-high-water-mark, serialized by its
        own lock: concurrent ``tail()``/``events()`` exports each flush
        exactly the drops no other flush has claimed yet (never the same
        delta twice), and a flush while the registry is disabled counts
        NOTHING as flushed — the drops are reported, not lost, once a
        live registry is back. Invariant (regression-pinned):
        ``nxdi_trace_events_dropped_total{ring="trace"}`` on one live
        registry equals ``self.dropped`` after any export."""
        reg = get_registry()
        if not reg.enabled:
            return                 # deferred, not discarded
        with self._flush_lock:
            with self._lock:
                n = self.dropped - self._dropped_flushed
                self._dropped_flushed += n
            if n:
                from . import metrics as tmetrics
                tmetrics.trace_events_dropped_counter(reg).inc(n,
                                                               ring="trace")

    def instant(self, name: str, cat: str = "engine", **args) -> str:
        """Record a point-in-time event; returns its event id."""
        return self._push({"name": name, "cat": cat, "ph": "i",
                           "ts": time.perf_counter(), "args": args})

    def complete(self, name: str, t0: float, cat: str = "engine",
                 t1: Optional[float] = None, **args) -> str:
        """Record a complete slice spanning ``[t0, t1]`` (``t1`` defaults
        to now); returns its event id."""
        if t1 is None:
            t1 = time.perf_counter()
        return self._push({"name": name, "cat": cat, "ph": "X",
                           "ts": t0, "dur": t1 - t0, "args": args})

    def span(self, name: str, cat: str = "engine", **args) -> _TraceSpan:
        """``with rec.span("pass.admit"): ...`` — one complete event over
        the body."""
        return _TraceSpan(self, name, cat, args)

    def error(self, err: BaseException, cat: str = "error", **args):
        """Record a typed failure as an ``error.<Type>`` instant event
        (message, seq_ids, phase/retry_safe when present) and attach the
        event id to the exception as ``err.trace_id`` so a post-mortem
        can jump from the raised error to its place in the timeline.
        Returns ``err`` for ``raise rec.error(...)`` chaining."""
        attrs: Dict[str, Any] = {
            "message": str(err),
            "seq_ids": [int(s) for s in getattr(err, "seq_ids", ()) or ()],
        }
        phase = getattr(err, "phase", None)
        if phase:
            attrs["phase"] = phase
        retry_safe = getattr(err, "retry_safe", None)
        if retry_safe is not None:
            attrs["retry_safe"] = bool(retry_safe)
        attrs.update(args)
        eid = self.instant(f"error.{type(err).__name__}", cat=cat, **attrs)
        try:
            err.trace_id = eid
        except Exception:                  # frozen/slotted carriers
            pass
        return err

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._dropped_flushed = 0

    # -- reading -----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        self._flush_drops()
        with self._lock:
            return [dict(e) for e in self._events]

    def tail(self, n: int = 256) -> List[Dict[str, Any]]:
        """The newest ``n`` events (post-mortem dump payload)."""
        self._flush_drops()
        with self._lock:
            return [dict(e) for e in self._events[-n:]]

    def __len__(self) -> int:
        return len(self._events)

    # -- exporters (pure) --------------------------------------------------
    def to_chrome(self, events: Optional[List[Dict[str, Any]]] = None
                  ) -> Dict[str, Any]:
        """Chrome trace-event JSON (load in ``chrome://tracing`` or
        Perfetto). Timestamps are microseconds from the recorder epoch;
        each category gets its own named thread lane."""
        if events is None:
            events = self.events()
        out: List[Dict[str, Any]] = []
        cats = sorted({e["cat"] for e in events},
                      key=lambda c: _CAT_TIDS.get(c, 99))
        for cat in cats:
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": _CAT_TIDS.get(cat, 99),
                        "args": {"name": f"nxdi.{cat}"}})
        for e in events:
            ce: Dict[str, Any] = {
                "name": e["name"], "cat": e["cat"], "ph": e["ph"],
                "ts": (e["ts"] - self.epoch) * 1e6,
                "pid": 1, "tid": _CAT_TIDS.get(e["cat"], 99),
                "args": {**e["args"], "id": e["id"]},
            }
            if e["ph"] == "X":
                ce["dur"] = e["dur"] * 1e6
            else:
                ce["s"] = "t"          # instant scope: thread
            out.append(ce)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def to_jsonl(self, events: Optional[List[Dict[str, Any]]] = None) -> str:
        """One JSON object per line (grep/jq-friendly), timestamps kept in
        raw ``perf_counter()`` seconds."""
        if events is None:
            events = self.events()
        return "\n".join(json.dumps(e, sort_keys=True) for e in events)


class NullFlightRecorder:
    """Disabled recorder: every method is a no-op; the library default."""

    enabled = False
    capacity = 0
    epoch = 0.0
    dropped = 0

    _NULL_SPAN = None                  # set below (shared instance)

    def instant(self, name, cat="engine", **args):
        return ""

    def complete(self, name, t0, cat="engine", t1=None, **args):
        return ""

    def span(self, name, cat="engine", **args):
        return self._NULL_SPAN

    def error(self, err, cat="error", **args):
        return err

    def clear(self):
        pass

    def events(self):
        return []

    def tail(self, n=256):
        return []

    def __len__(self):
        return 0

    def to_chrome(self, events=None):
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"dropped_events": 0}}

    def to_jsonl(self, events=None):
        return ""


class _NullSpanCM:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NullFlightRecorder._NULL_SPAN = _NullSpanCM()

NULL_RECORDER = NullFlightRecorder()
_global_recorder: Any = NULL_RECORDER


def get_recorder():
    """The process-global flight recorder (a no-op unless
    :func:`enable_recorder`'d or :func:`set_recorder`'d)."""
    return _global_recorder


def set_recorder(rec) -> None:
    global _global_recorder
    _global_recorder = rec if rec is not None else NULL_RECORDER


def enable_recorder(capacity: int = 4096) -> FlightRecorder:
    """Swap a live recorder into the global slot (idempotent; an existing
    live recorder is kept regardless of ``capacity``)."""
    global _global_recorder
    if not isinstance(_global_recorder, FlightRecorder):
        _global_recorder = FlightRecorder(capacity)
    return _global_recorder


def disable_recorder() -> None:
    global _global_recorder
    _global_recorder = NULL_RECORDER
