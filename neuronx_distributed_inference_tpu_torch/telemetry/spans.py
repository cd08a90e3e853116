"""Per-request spans — a tiny host-side event log (a copy of
``neuronx_distributed_inference_tpu/telemetry/spans.py``).

A :class:`Span` marks one request's lifetime through the serving stack:
created at admission, annotated with named events (``first_token``, one per
decode step boundary, ...), ended at release. Finished spans land in the
owning registry's bounded ring (``registry.snapshot()["spans"]``) so a
``--metrics-json`` dump carries per-request timelines alongside the
aggregate metrics. All timestamps come from ``time.perf_counter()`` —
monotonic, host-only; a span never touches device state.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "NullSpan", "NULL_SPAN"]


class Span:
    """One request's event log. Not thread-safe per instance (a request is
    driven from one host thread)."""

    __slots__ = ("name", "labels", "t_start", "t_end", "events",
                 "_registry_ref")

    def __init__(self, name: str, labels: Optional[Dict[str, Any]] = None,
                 registry=None):
        self.name = name
        self.labels = {k: str(v) for k, v in (labels or {}).items()}
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self.events: List[Dict[str, Any]] = []
        self._registry_ref = registry

    def event(self, name: str, **attrs) -> "Span":
        """Record a named event at now (relative time kept in seconds)."""
        e: Dict[str, Any] = {"name": name,
                             "t": time.perf_counter() - self.t_start}
        if attrs:
            e.update(attrs)
        self.events.append(e)
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def elapsed_since(self, event_name: str) -> Optional[float]:
        """Seconds since the FIRST event with this name; None if absent."""
        for e in self.events:
            if e["name"] == event_name:
                return self.elapsed() - e["t"]
        return None

    def end(self) -> float:
        """Close the span, push it into the registry ring, return its
        duration in seconds. Idempotent."""
        if self.t_end is None:
            self.t_end = time.perf_counter()
            if self._registry_ref is not None:
                self._registry_ref.record_span(self.to_dict())
        return self.t_end - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "labels": dict(self.labels),
            "duration_s": (None if self.t_end is None
                           else self.t_end - self.t_start),
            "events": [dict(e) for e in self.events],
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class NullSpan:
    """Shared no-op span handed out by a disabled registry."""

    __slots__ = ()
    name = ""
    labels: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    t_start = 0.0
    t_end = None

    def event(self, name: str, **attrs) -> "NullSpan":
        return self

    def elapsed(self) -> float:
        return 0.0

    def elapsed_since(self, event_name: str) -> Optional[float]:
        return None

    def end(self) -> float:
        return 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": "", "labels": {}, "duration_s": None, "events": []}

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = NullSpan()
