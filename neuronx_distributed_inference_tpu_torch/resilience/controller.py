"""Closed-loop degradation controller: ACT on SLO burn, reversibly (a
copy of ``neuronx_distributed_inference_tpu/resilience/controller.py``).
On the port's adapter every action acts: ``shed_speculation``
(``set_speculation_shed``), ``drop_ragged`` (``set_ragged_shed``),
``tighten_admission`` (``MultiTenantQueue.set_weight_scale``) and
``shed_adapters`` (``PagedEngineAdapter.set_adapter_shed``; a no-op on
an adapter without a LoRA pool).

The SLO plane (telemetry/slo.py) computes per-tenant multiwindow burn
rates and an advisory hint (``shed_speculation`` /
``tighten_admission``). :class:`DegradationController` is the actuator:
attached via ``ServingEngine(degradation=...)`` (which requires an
``slo=`` tracker), it is consulted once per scheduling pass and drives
three reversible actions off :meth:`~...telemetry.slo.SLOTracker.
burn_index`:

  * ``shed_speculation`` — a decode-side signal (ttft/tpot) burns in
    BOTH windows: the adapter's draft windows clamp to width 1
    (``PagedEngineAdapter.set_speculation_shed`` — no draft dispatches,
    per-sequence proposer state dropped through the ``_active_proposer``
    release path). Greedy token streams are bit-identical to an
    undegraded run; only the dispatch count changes (pinned).
  * ``tighten_admission`` — queue wait burns: the tenant's EFFECTIVE
    WFQ weight is scaled down (``MultiTenantQueue.set_weight_scale``)
    so new admissions defer to tenants still inside their target; the
    starvation bound keeps the tenant alive.
  * ``drop_ragged`` (opt-in, ``drop_ragged=True``) — decode-side burn
    additionally drops the ragged unified dispatch back to the
    two-phase path (``set_ragged_shed``), trading dispatch fusion for
    the smaller, older graphs.
  * ``shed_adapters`` (opt-in, ``shed_adapters=True``) — decode-side
    burn additionally admits NEW LoRA-tagged requests as base-model
    rows (``set_adapter_shed`` — no pool acquires, zero swap H2D
    traffic while burning; running rows finish under their pinned
    adapter, shed streams' meta annotated ``lora_shed=True``).

Every action is **hysteresis-guarded**: it enters when the tenant's
multiwindow burn (min of short/long — both must burn) crosses
``enter_burn``, and exits only once the burn falls below ``exit_burn``
AND the action has been held for ``min_hold_s`` — so a burn rate
oscillating around one threshold cannot flap the actuator. Transitions
land on the flight recorder (``degrade.enter`` / ``degrade.exit``) and
the ``nxdi_degraded{tenant,action}`` gauge (1 while active).

The controller never touches device state directly and never reorders
or changes tokens — every action only changes dispatch shape or
admission ORDER, so shedding and restoring mid-serve keeps every greedy
stream bit-identical (tests/test_torch_slo_control.py pins it on the port).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from .errors import ConfigurationError

__all__ = ["DEGRADE_ACTIONS", "DegradationController"]

#: Stable action names (label values of ``nxdi_degraded`` and the
#: ``degrade.*`` events).
DEGRADE_ACTIONS = ("shed_speculation", "tighten_admission", "drop_ragged",
                   "shed_adapters")

#: SLO signals that implicate the DECODE path (shed speculation /
#: ragged) vs the admission path (tighten the tenant's weight).
_DECODE_SIGNALS = ("ttft", "tpot")


class DegradationController:
    """Hysteresis-guarded actuator over one engine's SLO burn rates.

    ``enter_burn`` defaults to the SLO policy's ``burn_threshold`` at
    first use; ``exit_burn`` must be strictly below it. ``min_hold_s``
    is the minimum time an entered action is held before it may exit
    (flap damping). ``admission_scale`` is the effective-weight factor
    applied to a tenant while ``tighten_admission`` is active.
    ``drop_ragged=True`` additionally drops a ragged adapter to the
    two-phase path while decode-side burn is active.
    ``shed_adapters=True`` additionally admits new LoRA-tagged requests
    as base-model rows while decode-side burn is active (same hysteresis
    band; best-effort tenants trade adapter output for headroom)."""

    def __init__(self, *, enter_burn: Optional[float] = None,
                 exit_burn: float = 1.0, min_hold_s: float = 1.0,
                 admission_scale: float = 0.25,
                 drop_ragged: bool = False,
                 shed_adapters: bool = False,
                 min_interval_s: float = 0.0):
        if enter_burn is not None and enter_burn <= 0:
            raise ConfigurationError("enter_burn must be > 0")
        if exit_burn <= 0:
            raise ConfigurationError("exit_burn must be > 0")
        if enter_burn is not None and exit_burn >= enter_burn:
            raise ConfigurationError(
                f"exit_burn ({exit_burn}) must be below enter_burn "
                f"({enter_burn}) — equal thresholds would flap")
        if min_hold_s < 0:
            raise ConfigurationError("min_hold_s must be >= 0")
        if min_interval_s < 0:
            raise ConfigurationError("min_interval_s must be >= 0")
        if not 0 < admission_scale <= 1:
            raise ConfigurationError(
                "admission_scale must be in (0, 1] — it scales the "
                "tenant's effective weight DOWN")
        self.enter_burn = enter_burn
        self.exit_burn = exit_burn
        self.min_hold_s = min_hold_s
        self.admission_scale = admission_scale
        self.drop_ragged = drop_ragged
        self.shed_adapters = shed_adapters
        # evaluation throttle: burn_index rescans the rolling windows
        # (bounded, but per pass adds up in a tight serving loop) — a
        # production deployment sets e.g. short_window_s / 10; 0 (the
        # default) evaluates every pass, which tests rely on
        self.min_interval_s = min_interval_s
        self._next_eval = 0.0
        # (action, tenant) -> entered_at (host clock)
        self._active: Dict[Tuple[str, str], float] = {}
        # tenants whose weight scale THIS controller installed — the
        # reconcile must never touch an operator-set scale
        self._scaled: set = set()
        self.stats: Dict[str, int] = {"enters": 0, "exits": 0}

    def check_policy(self, policy) -> None:
        """Validate the hysteresis band against the SLO policy the
        controller will act on: with ``enter_burn`` defaulted, the
        EFFECTIVE enter threshold is ``policy.burn_threshold`` — and
        ``exit_burn`` at or above it would flap exactly like the
        explicit case the constructor rejects. ``ServingEngine`` calls
        this at construction so the misconfiguration is loud, not a
        per-pass enter/exit churn."""
        enter = (self.enter_burn if self.enter_burn is not None
                 else policy.burn_threshold)
        if self.exit_burn >= enter:
            raise ConfigurationError(
                f"exit_burn ({self.exit_burn}) must be below the "
                f"effective enter threshold ({enter} — the SLO policy's "
                "burn_threshold when enter_burn is not set); equal or "
                "inverted thresholds would flap")

    # -- read surface ------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return bool(self._active)

    def is_active(self, action: str, tenant: Optional[str] = None) -> bool:
        if tenant is not None:
            return (action, tenant) in self._active
        return any(a == action for a, _ in self._active)

    def state(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-able snapshot — the ``degradation`` section of
        ``debug_state()``."""
        if now is None:
            now = time.perf_counter()
        return {
            "degraded": self.degraded,
            "active": [
                {"action": a, "tenant": t,
                 "held_s": round(now - since, 4)}
                for (a, t), since in sorted(self._active.items())],
            "stats": dict(self.stats),
        }

    # -- the per-pass evaluation -------------------------------------------
    def update(self, engine, now: Optional[float] = None) -> None:
        """One control-loop evaluation: read the engine's SLO burn
        index, reconcile the hysteresis state machines, and apply the
        actuator side effects. Host-side only; called by
        ``ServingEngine.run_pass`` (cheap — bounded windows, no device
        work)."""
        tracker = engine.slo
        if tracker is None:
            return
        if now is None:
            now = time.perf_counter()
        if now < self._next_eval:
            return                     # throttled (actions unchanged)
        self._next_eval = now + self.min_interval_s
        enter = (self.enter_burn if self.enter_burn is not None
                 else tracker.policy.burn_threshold)
        burns = tracker.burn_index(now)
        desired: Dict[Tuple[str, str], float] = {}
        for (tenant, signal), burn in burns.items():
            if signal in _DECODE_SIGNALS:
                desired[("shed_speculation", tenant)] = max(
                    burn, desired.get(("shed_speculation", tenant), 0.0))
                if self.drop_ragged:
                    desired[("drop_ragged", tenant)] = max(
                        burn, desired.get(("drop_ragged", tenant), 0.0))
                if self.shed_adapters:
                    desired[("shed_adapters", tenant)] = max(
                        burn, desired.get(("shed_adapters", tenant), 0.0))
            else:
                desired[("tighten_admission", tenant)] = burn
        # enter: both windows burn past the enter threshold
        for key, burn in desired.items():
            if key not in self._active and burn >= enter:
                self._active[key] = now
                self.stats["enters"] += 1
                self._transition("degrade.enter", key, burn, engine)
        # exit: burn back under the exit threshold AND the hold elapsed
        for key in list(self._active):
            burn = desired.get(key, 0.0)
            if (burn < self.exit_burn
                    and now - self._active[key] >= self.min_hold_s):
                del self._active[key]
                self.stats["exits"] += 1
                self._transition("degrade.exit", key, burn, engine)
        self._apply(engine)

    # -- side effects ------------------------------------------------------
    def _apply(self, engine) -> None:
        """Reconcile the actuators with the active set (idempotent)."""
        adapter = engine.adapter
        if hasattr(adapter, "set_speculation_shed"):
            adapter.set_speculation_shed(self.is_active("shed_speculation"))
        if hasattr(adapter, "set_ragged_shed"):
            adapter.set_ragged_shed(self.is_active("drop_ragged"))
        if hasattr(adapter, "set_adapter_shed"):
            adapter.set_adapter_shed(self.is_active("shed_adapters"))
        queue = engine.queue
        tightened = {t for a, t in self._active if a == "tighten_admission"}
        # re-assert the scale for every ACTIVE tenant (idempotent, like
        # the shed flags — an external reset mid-hold must not leave the
        # gauge claiming an actuator that is silently off) and restore
        # only tenants THIS controller scaled: an operator's own
        # set_weight_scale on other tenants survives untouched
        for t in tightened:
            queue.set_weight_scale(t, self.admission_scale)
        for t in self._scaled - tightened:
            queue.set_weight_scale(t, 1.0)
        self._scaled = tightened

    def _transition(self, event: str, key: Tuple[str, str], burn: float,
                    engine) -> None:
        # imports deferred so resilience/ stays importable before
        # telemetry wires up in exotic embeddings (and to avoid a module
        # cycle: telemetry never imports resilience)
        from ..telemetry import get_registry
        from ..telemetry import metrics as tmetrics
        from ..telemetry.trace import get_recorder
        action, tenant = key
        rec = get_recorder()
        if rec.enabled:
            rec.instant(event, cat="engine", action=action, tenant=tenant,
                        burn=round(burn, 4),
                        active=len(self._active))
        reg = get_registry()
        if reg.enabled:
            tmetrics.degraded_gauge(reg).set(
                1.0 if event == "degrade.enter" else 0.0,
                tenant=tenant, action=action)
