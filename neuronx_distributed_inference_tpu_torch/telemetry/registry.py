"""Dependency-free serving metrics registry — a copy of
``neuronx_distributed_inference_tpu/telemetry/registry.py`` (metric names,
label sets and bucket edges identical, so both packages render the same
Prometheus text).

The reference NxDI stack leans on external tooling (neuron-profile, runtime
counters) for production visibility; serving engines treat per-request
latency, occupancy gauges and recompile accounting as first-class (vLLM /
Orca-style continuous batching — PAPERS.md). This module is the repo's
equivalent: a tiny Prometheus-style registry with three instrument kinds
(:class:`Counter`, :class:`Gauge`, :class:`Histogram` with fixed log-spaced
latency buckets) and labeled series, plus two pure export surfaces —
``render_prometheus()`` (text exposition format) and ``snapshot()`` (a
JSON-able dict) — so tests and CLIs need no HTTP server.

Zero-cost-when-disabled: the module-global default registry is a
:class:`NullRegistry` whose instruments are shared no-ops, so library code
can call ``registry.counter(...).inc(...)`` unconditionally on the host path.
Instrumented call sites must still measure at host boundaries only — never
inside traced code (a host sync inside a jitted graph would change the graph).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "get_registry", "set_registry", "enable", "disable",
    "render_series",
]

# Log-spaced latency ladder (seconds), 100 us .. 60 s. Fixed so that series
# from different processes/runs line up; chosen to straddle both host-side
# dispatch (~100 us) and cold-compile stalls (tens of seconds).
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0)

_NAME_OK = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _check_name(name: str):
    if not name or name[0].isdigit() or any(c not in _NAME_OK for c in name):
        raise ValueError(f"invalid metric name {name!r}")


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """Float → Prometheus sample text (shortest round-trippable form)."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    out = repr(float(v))
    return out[:-2] if out.endswith(".0") else out


def _labels_key(label_names: Tuple[str, ...], labels: Dict[str, Any]
                ) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(f"expected labels {label_names}, got "
                         f"{tuple(sorted(labels))}")
    return tuple(str(labels[k]) for k in label_names)


def _labels_to_text(labels: Dict[str, Any]) -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()]
    return "{" + ",".join(parts) + "}" if parts else ""


def render_series(name: str, kind: str, entry: Dict[str, Any],
                  extra_labels: Optional[Dict[str, str]] = None
                  ) -> List[str]:
    """Prometheus sample lines for ONE ``snapshot()`` series entry —
    THE snapshot-driven renderer, shared by the live registry's own
    ``render_prometheus()`` and the fleet aggregator
    (serving/fleet/aggregator.py), so the two exposition surfaces can
    never drift apart. ``extra_labels`` are prepended (the aggregator's
    ``replica`` label)."""
    labels = dict(extra_labels or {})
    labels.update(entry["labels"])
    lt = _labels_to_text(labels)
    if kind == "histogram":
        lines = []
        for bound, cum in entry["buckets"]:
            le = _labels_to_text({**labels, "le": _fmt(bound)})
            lines.append(f"{name}_bucket{le} {cum}")
        inf = _labels_to_text({**labels, "le": "+Inf"})
        lines.append(f"{name}_bucket{inf} {entry['count']}")
        lines.append(f"{name}_sum{lt} {_fmt(entry['sum'])}")
        lines.append(f"{name}_count{lt} {entry['count']}")
        return lines
    return [f"{name}{lt} {_fmt(entry['value'])}"]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        _check_name(name)
        for ln in labels:
            _check_name(ln)
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._series: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def _render(self) -> List[str]:
        # snapshot-driven, through THE shared renderer (render_series) —
        # the fleet aggregator rides the same code path
        return [line for entry in self._snapshot()
                for line in render_series(self.name, self.kind, entry)]


class Counter(_Metric):
    """Monotonically increasing counter with optional labels."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labels_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        return self._series.get(_labels_key(self.label_names, labels), 0.0)

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(zip(self.label_names, k)), "value": v}
                    for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Point-in-time value with optional labels."""

    kind = "gauge"

    def set(self, value: float, **labels):
        key = _labels_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _labels_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def get(self, **labels) -> float:
        return self._series.get(_labels_key(self.label_names, labels), 0.0)

    _snapshot = Counter._snapshot


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative counts, Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("buckets must be strictly increasing")
        self.buckets = bs

    def observe(self, value: float, **labels):
        key = _labels_key(self.label_names, labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = {
                    "counts": [0] * len(self.buckets),
                    "sum": 0.0, "count": 0}
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["counts"][i] += 1
                    break
            st["sum"] += float(value)
            st["count"] += 1

    def count(self, **labels) -> int:
        st = self._series.get(_labels_key(self.label_names, labels))
        return st["count"] if st else 0

    def sum(self, **labels) -> float:
        st = self._series.get(_labels_key(self.label_names, labels))
        return st["sum"] if st else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Bucket-upper-bound approximation of the q-th percentile
        (0 <= q <= 1). Returns 0.0 for an empty series."""
        st = self._series.get(_labels_key(self.label_names, labels))
        if not st or st["count"] == 0:
            return 0.0
        target = q * st["count"]
        acc = 0
        for i, c in enumerate(st["counts"]):
            acc += c
            if acc >= target and c:
                return self.buckets[i]
        return st["sum"] / st["count"]  # everything beyond the last bucket

    def _cumulative(self, st) -> List[int]:
        out, acc = [], 0
        for c in st["counts"]:
            acc += c
            out.append(acc)
        return out

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for key, st in sorted(self._series.items()):
                out.append({
                    "labels": dict(zip(self.label_names, key)),
                    "count": st["count"], "sum": st["sum"],
                    "buckets": [[b, c] for b, c in
                                zip(self.buckets, self._cumulative(st))],
                })
            return out


class MetricsRegistry:
    """Live registry: get-or-create instruments by name, export as
    Prometheus text or a JSON-able snapshot. Also keeps a bounded ring of
    finished request :class:`~..telemetry.spans.Span` event logs."""

    enabled = True

    def __init__(self, max_spans: int = 256):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._spans: List[Dict[str, Any]] = []
        self._max_spans = max_spans
        self.spans_dropped = 0

    # -- instruments ------------------------------------------------------
    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}")
        if tuple(labels) != m.label_names:
            raise ValueError(f"metric {name!r} registered with labels "
                             f"{m.label_names}, asked for {tuple(labels)}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- spans ------------------------------------------------------------
    def start_span(self, name: str, **labels):
        from .spans import Span
        return Span(name, labels=labels, registry=self)

    def record_span(self, span_dict: Dict[str, Any]):
        with self._lock:
            self._spans.append(span_dict)
            excess = len(self._spans) - self._max_spans
            if excess > 0:
                del self._spans[:excess]
                self.spans_dropped += excess
        if excess > 0:
            # evictions were silent before the flight-recorder work: count
            # them so a snapshot/post-mortem states its own truncation
            # (counter registration outside self._lock — it re-takes it)
            from . import metrics as tmetrics
            tmetrics.trace_events_dropped_counter(self).inc(excess,
                                                            ring="spans")

    @property
    def spans(self) -> List[Dict[str, Any]]:
        return list(self._spans)

    # -- export (pure; no server required) --------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m._render())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every metric series + finished request spans."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {
            "metrics": {
                name: {"type": m.kind, "help": m.help,
                       "series": m._snapshot()}
                for name, m in metrics
            },
            "spans": self.spans,
        }

    def stats_line(self) -> str:
        """One compact human line (bench/CLI heartbeat)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        parts = []
        for name, m in metrics:
            with m._lock:   # a concurrent inc() may add a new label series
                if isinstance(m, Histogram):
                    n = sum(st["count"] for st in m._series.values())
                    s = sum(st["sum"] for st in m._series.values())
                    if n:
                        parts.append(f"{name}: n={n} mean={s / n * 1e3:.2f}ms")
                else:
                    total = sum(m._series.values())
                    if total:
                        parts.append(f"{name}={_fmt(total)}")
        return " | ".join(parts)


class _NullInstrument:
    """Shared do-nothing instrument handed out by :class:`NullRegistry`."""

    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def get(self, **k):
        return 0.0

    def count(self, **k):
        return 0

    def sum(self, **k):
        return 0.0

    def percentile(self, q, **k):
        return 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled registry: every instrument is a shared no-op; exports are
    empty. The library default — callers pay one attribute check."""

    enabled = False
    spans: List[Dict[str, Any]] = []

    def counter(self, *a, **k):
        return _NULL_INSTRUMENT

    def gauge(self, *a, **k):
        return _NULL_INSTRUMENT

    def histogram(self, *a, **k):
        return _NULL_INSTRUMENT

    def get(self, name):
        return None

    def start_span(self, name, **labels):
        from .spans import NULL_SPAN
        return NULL_SPAN

    def record_span(self, span_dict):
        pass

    def render_prometheus(self) -> str:
        return ""

    def snapshot(self) -> Dict[str, Any]:
        return {"metrics": {}, "spans": []}

    def stats_line(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()
_global_registry: Any = NULL_REGISTRY


def get_registry():
    """The process-global registry (a NullRegistry unless :func:`enable`\\ d
    or explicitly :func:`set_registry`'d)."""
    return _global_registry


def set_registry(reg) -> None:
    global _global_registry
    _global_registry = reg if reg is not None else NULL_REGISTRY


def enable() -> MetricsRegistry:
    """Swap a live registry into the global slot (idempotent)."""
    global _global_registry
    if not isinstance(_global_registry, MetricsRegistry):
        _global_registry = MetricsRegistry()
    return _global_registry


def disable() -> None:
    global _global_registry
    _global_registry = NULL_REGISTRY
