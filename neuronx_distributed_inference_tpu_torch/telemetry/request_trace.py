"""Request-scoped tracing (a copy of
``neuronx_distributed_inference_tpu/telemetry/request_trace.py``) — one
stable ``trace_id`` per request, end to
end across the whole fleet.

The flight recorder (``trace.py``) answers "what happened, in what
order" per PROCESS; this module adds the per-REQUEST thread through it:
a trace id minted at ingress (:func:`new_trace_id`) that rides the
request's opaque ``meta`` passthrough (``meta["trace"]``) everywhere the
request goes — queue wait, transactional admission, every ragged-step
row it occupies (the ``dispatch.ragged`` event's ``traces`` list),
preemption + requeue, replica failover, and the disaggregated prefill →
decode handoff. Because :class:`~...resilience.preemption.Preempted`
serializes ``meta`` verbatim in ``to_json()``, the trace context crosses
process boundaries for free: a decode-replica continuation stitches onto
the prefill replica's trace with the SAME id (pinned by
``tests/test_slo_observability.py``).

Event convention (stable, like every other recorder contract):

  * lifecycle events (``trace.begin`` / ``trace.admit`` /
    ``trace.requeue`` / ``trace.emit``, cat ``request``) carry
    ``trace=<id>``;
  * batched device events (``dispatch.ragged``) carry
    ``traces=[<id>...]`` — one entry per packed row;
  * error/preempt events carry ``trace=<id>`` when the victim's meta
    held one.

Pure helpers below filter a recorder's event list down to one request
(:func:`trace_events`) and export per-request Chrome lanes
(:func:`chrome_by_trace` — one ``tid`` lane per trace id, so Perfetto
shows each request as its own swimlane). Zero-cost-off: nothing here
runs unless the flight recorder is enabled; minting the id itself is one
``uuid4`` at submit time and changes no device work.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["TRACE_META_KEY", "new_trace_id", "trace_of",
           "trace_events", "trace_ids_in", "chrome_by_trace"]

#: The key the serving layers park the trace id under in the opaque
#: per-request ``meta`` passthrough (a stable contract: ``Preempted``
#: and handoff records serialize meta verbatim, so this key IS the wire
#: format of the cross-replica trace context).
TRACE_META_KEY = "trace"


def new_trace_id() -> str:
    """A fresh request trace id (16 hex chars — short enough for log
    lines, collision-safe for a serving process's lifetime)."""
    return uuid.uuid4().hex[:16]


def trace_of(meta: Any) -> Optional[str]:
    """The trace id carried by an opaque per-request ``meta`` payload,
    or None (non-mapping metas — e.g. the non-engine default None —
    never carry one)."""
    try:
        tid = meta.get(TRACE_META_KEY)
    except AttributeError:
        return None
    return None if tid is None else str(tid)


def _matches(ev: Dict[str, Any], trace_id: str) -> bool:
    args = ev.get("args") or {}
    if args.get("trace") == trace_id:
        return True
    traces = args.get("traces")
    return bool(traces) and trace_id in traces


def trace_events(events: Iterable[Dict[str, Any]],
                 trace_id: str) -> List[Dict[str, Any]]:
    """The subset of recorder events belonging to one request: lifecycle
    events tagged ``trace=<id>`` plus batched device events whose
    ``traces`` row list contains it (recorder order preserved)."""
    return [ev for ev in events if _matches(ev, trace_id)]


def trace_ids_in(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Every distinct trace id present in ``events``, ordered by first
    appearance (the lane order :func:`chrome_by_trace` uses)."""
    seen: Dict[str, None] = {}
    for ev in events:
        args = ev.get("args") or {}
        tid = args.get("trace")
        if tid:
            seen.setdefault(str(tid), None)
        for t in args.get("traces") or ():
            if t:
                seen.setdefault(str(t), None)
    return list(seen)


def chrome_by_trace(recorder, trace_ids: Optional[Iterable[str]] = None
                    ) -> Dict[str, Any]:
    """Chrome trace-event JSON with one thread lane PER REQUEST: every
    event of each trace id lands on its own named ``tid``
    (``trace:<id>``), so Perfetto renders each request as a swimlane
    through queue wait, admission, dispatches and emission. Events
    belonging to several traces (a batched ragged dispatch) are repeated
    on every involved lane — that repetition is the point: each request's
    lane shows the dispatches it actually rode. ``trace_ids=None`` lanes
    every trace in the ring."""
    events = recorder.events()
    ids = list(trace_ids) if trace_ids is not None else trace_ids_in(events)
    out: List[Dict[str, Any]] = []
    epoch = getattr(recorder, "epoch", 0.0)
    for lane, tid in enumerate(ids, start=1):
        out.append({"name": "thread_name", "ph": "M", "pid": 1,
                    "tid": lane, "args": {"name": f"trace:{tid}"}})
    for ev in events:
        for lane, tid in enumerate(ids, start=1):
            if not _matches(ev, tid):
                continue
            ce: Dict[str, Any] = {
                "name": ev["name"], "cat": ev["cat"], "ph": ev["ph"],
                "ts": (ev["ts"] - epoch) * 1e6,
                "pid": 1, "tid": lane,
                "args": {**ev["args"], "id": ev["id"]},
            }
            if ev["ph"] == "X":
                ce["dur"] = ev["dur"] * 1e6
            else:
                ce["s"] = "t"
            out.append(ce)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": recorder.dropped,
                          "traces": ids}}
