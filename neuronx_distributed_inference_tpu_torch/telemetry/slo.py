"""Per-tenant SLO plane: rolling-window streaming percentiles over
TTFT / TPOT / queue-wait, burn-rate tracking, and a degradation hint (a
copy of ``neuronx_distributed_inference_tpu/telemetry/slo.py``, whose
package imports jax; the port keeps its own).

The metrics registry's histograms answer "what is the all-time
distribution"; an operator paging on an SLO needs "what is the
distribution over the last minute / last ten minutes, per tenant, and
how fast is the error budget burning". This module computes exactly
that, host-side, with **bounded memory and no numpy on the hot path**
(``observe()`` is one deque append; sorting happens only at report
time):

  * :class:`RollingWindow` — a bounded ring of ``(timestamp, value)``
    samples; ``percentile(q, window_s)`` sorts a time-filtered snapshot.
    Memory is capped by ``max_samples`` (oldest evicted first), so a
    traffic burst degrades *resolution*, never footprint;
  * :class:`SLOPolicy` — per-signal latency targets plus the objective
    (the fraction of requests that must meet them, default 0.99) and the
    short/long burn windows;
  * :class:`SLOTracker` — per-(tenant, signal) windows,
    :meth:`~SLOTracker.report` (p50/p99, attainment, burn rate per
    window), :meth:`~SLOTracker.export` (the ``nxdi_slo_*`` gauges), and
    :meth:`~SLOTracker.degradation_hint`.

**Burn rate** (README "Observability contract"): over a window,
``burn = (fraction of requests violating the target) / (1 - objective)``
— the rate at which the error budget is being spent, normalized so 1.0
means "exactly on budget". A hint fires only when BOTH the short and the
long window burn past ``burn_threshold`` (the classic multiwindow rule:
the long window proves it is real, the short window proves it is still
happening). The hint itself is **advisory**: it is served read-only in
``/v1/debug/state``; ``ServingEngine(degradation=...)`` attaches the
actuator that acts on the same burn numbers
(``resilience/controller.py``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import metrics as tmetrics

__all__ = ["SLO_SIGNALS", "RollingWindow", "SLOPolicy", "SLOTracker"]

#: The three per-tenant latency signals the SLO plane tracks. STABLE
#: (label values of the ``nxdi_slo_*`` gauges):
#:   ``ttft``       submit -> first token (client-observed, queue incl.)
#:   ``tpot``       per-request mean time-per-output-token after the first
#:   ``queue_wait`` submit -> admission
SLO_SIGNALS = ("ttft", "tpot", "queue_wait")


class RollingWindow:
    """Bounded ring of timestamped samples with on-demand percentiles.

    ``observe()`` is O(1) (one deque append + bounded evictions); the
    percentile/attainment reads sort a snapshot filtered to the queried
    window — report-time cost, never serving-time cost. One ring serves
    every window length up to ``horizon_s`` (samples older than that are
    evicted on write)."""

    def __init__(self, horizon_s: float = 600.0, max_samples: int = 2048):
        if horizon_s <= 0 or max_samples < 1:
            raise ValueError("horizon_s must be > 0, max_samples >= 1")
        self.horizon_s = float(horizon_s)
        self.max_samples = int(max_samples)
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=max_samples)

    def observe(self, value: float, now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        self._samples.append((now, float(value)))
        cutoff = now - self.horizon_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def __len__(self) -> int:
        return len(self._samples)

    def values(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[float]:
        if now is None:
            now = time.perf_counter()
        cutoff = now - (self.horizon_s if window_s is None else window_s)
        return [v for t, v in self._samples if t >= cutoff]

    def percentile(self, q: float, window_s: Optional[float] = None,
                   now: Optional[float] = None) -> float:
        """The q-th percentile (0 <= q <= 1) of the samples inside the
        window, by nearest-rank on a sorted snapshot; 0.0 when empty."""
        vals = sorted(self.values(window_s, now))
        if not vals:
            return 0.0
        idx = min(int(q * len(vals)), len(vals) - 1)
        return vals[idx]

    def violation_fraction(self, target: float,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None) -> float:
        """Fraction of in-window samples strictly above ``target``
        (0.0 when the window is empty — no traffic burns no budget)."""
        vals = self.values(window_s, now)
        if not vals:
            return 0.0
        return sum(1 for v in vals if v > target) / len(vals)


@dataclass(frozen=True)
class SLOPolicy:
    """Targets + burn semantics for one serving surface.

    ``targets`` maps signal name -> latency target in SECONDS (a signal
    without a target is tracked for percentiles but never burns).
    ``objective`` is the attainment the budget is written against
    (0.99 = "99% of requests meet the target"); ``burn_threshold`` is
    the normalized burn rate BOTH windows must exceed before
    :meth:`SLOTracker.degradation_hint` speaks up."""

    targets: Dict[str, float] = field(default_factory=dict)
    objective: float = 0.99
    short_window_s: float = 60.0
    long_window_s: float = 600.0
    burn_threshold: float = 2.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.short_window_s <= 0 or self.long_window_s <= 0:
            raise ValueError("windows must be > 0")
        if self.short_window_s > self.long_window_s:
            raise ValueError("short window must not exceed the long one")
        for sig in self.targets:
            if sig not in SLO_SIGNALS:
                raise ValueError(f"unknown SLO signal {sig!r}; expected "
                                 f"one of {SLO_SIGNALS}")

    @property
    def budget(self) -> float:
        """The error-budget fraction (1 - objective)."""
        return 1.0 - self.objective


class SLOTracker:
    """Per-(tenant, signal) rolling windows + the report/hint surface.

    One tracker per serving engine (``ServingEngine(slo=...)``); the
    engine feeds it host-side timestamps only, so attaching it cannot
    change device work, graphs, or token streams (zero-cost contract,
    pinned). All read surfaces are pure."""

    def __init__(self, policy: Optional[SLOPolicy] = None,
                 max_samples: int = 2048):
        self.policy = policy if policy is not None else SLOPolicy()
        self.max_samples = max_samples
        self._windows: Dict[Tuple[str, str], RollingWindow] = {}

    # -- write side (engine) ----------------------------------------------
    def observe(self, tenant: str, signal: str, value: float,
                now: Optional[float] = None) -> None:
        if signal not in SLO_SIGNALS:
            raise ValueError(f"unknown SLO signal {signal!r}; expected "
                             f"one of {SLO_SIGNALS}")
        key = (str(tenant), signal)
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = RollingWindow(
                horizon_s=self.policy.long_window_s,
                max_samples=self.max_samples)
        win.observe(value, now)

    # -- read side (pure) --------------------------------------------------
    @property
    def tenants(self) -> List[str]:
        return sorted({t for t, _ in self._windows})

    def _signal_report(self, win: RollingWindow, signal: str,
                       now: float) -> Dict[str, Any]:
        pol = self.policy
        out: Dict[str, Any] = {
            "n": len(win),
            "p50_s": win.percentile(0.50, now=now),
            "p99_s": win.percentile(0.99, now=now),
        }
        target = pol.targets.get(signal)
        if target is not None:
            burns = {}
            attain = {}
            for label, w in (("short", pol.short_window_s),
                             ("long", pol.long_window_s)):
                viol = win.violation_fraction(target, w, now)
                attain[label] = 1.0 - viol
                burns[label] = viol / pol.budget
            out.update(target_s=target, attainment=attain,
                       burn_rate=burns)
        return out

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-able per-tenant SLO report: per-signal sample count,
        p50/p99 over the long window and — for targeted signals —
        short/long attainment + burn rate. Served read-only as the
        ``slo`` section of ``/v1/debug/state``."""
        if now is None:
            now = time.perf_counter()
        pol = self.policy
        tenants: Dict[str, Any] = {}
        for (tenant, signal), win in sorted(self._windows.items()):
            tenants.setdefault(tenant, {})[signal] = \
                self._signal_report(win, signal, now)
        return {
            "schema": "nxdi-slo-report-v1",
            "policy": {
                "targets": dict(pol.targets),
                "objective": pol.objective,
                "short_window_s": pol.short_window_s,
                "long_window_s": pol.long_window_s,
                "burn_threshold": pol.burn_threshold,
            },
            "tenants": tenants,
            "hint": self.degradation_hint(now=now),
        }

    def burn_index(self, now: Optional[float] = None
                   ) -> Dict[Tuple[str, str], float]:
        """``(tenant, signal) -> min(short burn, long burn)`` for every
        TARGETED signal with samples — the multiwindow burn number both
        :meth:`degradation_hint` (against ``policy.burn_threshold``) and
        the :class:`~...resilience.controller.DegradationController`
        (against its own hysteresis thresholds) decide on. Taking the
        MIN of the two windows encodes the classic multiwindow rule:
        both must burn before anyone acts."""
        if now is None:
            now = time.perf_counter()
        pol = self.policy
        out: Dict[Tuple[str, str], float] = {}
        for (tenant, signal), win in sorted(self._windows.items()):
            target = pol.targets.get(signal)
            if target is None:
                continue
            out[(tenant, signal)] = min(
                win.violation_fraction(target, w, now) / pol.budget
                for w in (pol.short_window_s, pol.long_window_s))
        return out

    def degradation_hint(self, now: Optional[float] = None
                         ) -> Dict[str, Any]:
        """Advisory multiwindow burn alerts, per tenant:

          * ``shed_speculation`` — a DECODE-side signal (ttft/tpot) is
            burning in both windows: speculative decode's draft overhead
            is the first latency lever to drop;
          * ``tighten_admission`` — queue wait is burning in both
            windows: the engine is admitting more than it can serve
            inside the target.

        The hint is the threshold-crossed view of :meth:`burn_index`;
        ``ServingEngine(degradation=...)`` attaches the closed-loop
        actuator (resilience/controller.py) that actually acts on the
        same burn numbers with hysteresis — without it the hint stays
        advisory (``/v1/debug/state``)."""
        if now is None:
            now = time.perf_counter()
        pol = self.policy
        tenants: Dict[str, Any] = {}
        for (tenant, signal), burn in self.burn_index(now).items():
            if burn < pol.burn_threshold:
                continue
            entry = tenants.setdefault(
                tenant, {"shed_speculation": False,
                         "tighten_admission": False, "signals": {}})
            entry["signals"][signal] = round(burn, 3)
            if signal in ("ttft", "tpot"):
                entry["shed_speculation"] = True
            else:
                entry["tighten_admission"] = True
        return {"degrade": bool(tenants), "tenants": tenants}

    def export(self, reg, now: Optional[float] = None) -> None:
        """Set the ``nxdi_slo_attainment`` / ``nxdi_slo_burn_rate``
        gauges from the current windows (pull-time export — called by
        the ``/v1/metrics`` scrape path and the bench, never per
        request)."""
        if not getattr(reg, "enabled", False):
            return
        if now is None:
            now = time.perf_counter()
        pol = self.policy
        attain = tmetrics.slo_attainment_gauge(reg)
        burn = tmetrics.slo_burn_rate_gauge(reg)
        for (tenant, signal), win in self._windows.items():
            target = pol.targets.get(signal)
            if target is None:
                continue
            for label, w in (("short", pol.short_window_s),
                             ("long", pol.long_window_s)):
                viol = win.violation_fraction(target, w, now)
                attain.set(1.0 - viol, tenant=tenant, signal=signal,
                           window=label)
                burn.set(viol / pol.budget, tenant=tenant, signal=signal,
                         window=label)
