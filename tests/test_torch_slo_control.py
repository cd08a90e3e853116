"""The port's SLO plane (telemetry/slo.py) and degradation controller
(resilience/controller.py) against the JAX package's: the same
observation sequences give the same reports, burn indexes, hints and
enter / exit transitions (the scenarios of
tests/test_slo_observability.py:169-243 and
tests/test_resilience_control.py:125-209, run through both packages), and
the engine with ``drop_ragged`` keeps greedy streams equal to the JAX
engine's. Host-side only, except the engine run (tiny fp32 Llama of
tests/test_torch_ragged.py on the CPU)."""

import json
from types import SimpleNamespace

import pytest

from neuronx_distributed_inference_tpu.resilience.controller import \
    DegradationController as JDegradationController
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.engine import \
    MultiTenantQueue as JMultiTenantQueue
from neuronx_distributed_inference_tpu.serving.engine import \
    ServingEngine as JServingEngine
from neuronx_distributed_inference_tpu.telemetry.slo import (
    RollingWindow as JRollingWindow, SLOPolicy as JSLOPolicy,
    SLOTracker as JSLOTracker)
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.resilience import (
    ConfigurationError, DegradationController)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import (
    MultiTenantQueue, ServingEngine)
from neuronx_distributed_inference_tpu_torch.telemetry import \
    metrics as tmetrics
from neuronx_distributed_inference_tpu_torch.telemetry.slo import (
    RollingWindow, SLOPolicy, SLOTracker)
from test_torch_ragged import P_A, P_B, P_LONG, make_pair

SIDES = {
    "port": SimpleNamespace(RollingWindow=RollingWindow, SLOPolicy=SLOPolicy,
                            SLOTracker=SLOTracker,
                            Controller=DegradationController,
                            Queue=MultiTenantQueue),
    "jax": SimpleNamespace(RollingWindow=JRollingWindow,
                           SLOPolicy=JSLOPolicy, SLOTracker=JSLOTracker,
                           Controller=JDegradationController,
                           Queue=JMultiTenantQueue),
}


def _both(scenario):
    out = {side: scenario(ns) for side, ns in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_rolling_window_matches_reference():
    def run(ns):
        win = ns.RollingWindow(horizon_s=100.0, max_samples=8)
        for i in range(10):
            win.observe(float(i), now=float(i))
        res = [len(win), win.values(now=9.0), win.percentile(0.5, now=9.0),
               win.percentile(0.99, now=9.0),
               win.values(window_s=2.5, now=9.0),
               win.violation_fraction(7.5, window_s=2.5, now=9.0)]
        win.observe(99.0, now=200.0)
        return res + [win.values(now=200.0), ns.RollingWindow().percentile(
            0.5)]
    res = _both(run)
    assert res[0] == 8 and res[2] == 6.0 and res[4] == [7.0, 8.0, 9.0]
    for ns in SIDES.values():
        with pytest.raises(ValueError):
            ns.RollingWindow(horizon_s=0)


def test_slo_burn_index_report_and_hint_match_reference():
    """ttft burns in the long window only (no hint), queue_wait in both
    (tighten_admission), tpot is untargeted (percentiles only)."""
    def run(ns):
        pol = ns.SLOPolicy(targets={"ttft": 1.0, "queue_wait": 0.5},
                           objective=0.9, short_window_s=10.0,
                           long_window_s=100.0, burn_threshold=2.0)
        t = ns.SLOTracker(pol)
        now = 1000.0
        for i, v in enumerate([2.0, 2.0, 2.0, 2.0, 0.5]):
            t.observe("acme", "ttft", v, now=now - 50.0 + i)
        first = (t.report(now=now), sorted(t.burn_index(now=now).items()),
                 t.degradation_hint(now=now))
        for i in range(4):
            t.observe("acme", "queue_wait", 2.0, now=now - 2.0 + 0.1 * i)
        t.observe("acme", "tpot", 5.0, now=now)
        return json.dumps([first, t.report(now=now),
                           sorted(t.burn_index(now=now).items()),
                           t.degradation_hint(now=now)], sort_keys=True)
    res = json.loads(_both(run))
    assert res[0][2]["degrade"] is False
    assert res[3]["tenants"]["acme"]["tighten_admission"] is True
    assert res[0][0]["tenants"]["acme"]["ttft"]["burn_rate"]["long"] == \
        pytest.approx(8.0)


def test_slo_gauges_export_like_reference():
    reg = telemetry.MetricsRegistry()
    t = SLOTracker(SLOPolicy(targets={"ttft": 1.0}, objective=0.9))
    for v in (2.0, 0.5):
        t.observe("a", "ttft", v, now=50.0)
    t.export(reg, now=50.0)
    assert reg.get(tmetrics.SLO_BURN_RATE).get(
        tenant="a", signal="ttft", window="short") == pytest.approx(5.0)
    assert reg.get(tmetrics.SLO_ATTAINMENT).get(
        tenant="a", signal="ttft", window="long") == pytest.approx(0.5)


class _FakeAdapter:
    def __init__(self):
        self.spec_shed = False
        self.ragged_shed = False

    def set_speculation_shed(self, shed):
        self.spec_shed = bool(shed)

    def set_ragged_shed(self, shed):
        self.ragged_shed = bool(shed)


def test_controller_hysteresis_transitions_match_reference():
    """Enter on both-windows burn, hold through min_hold_s, exit after
    it: the same transitions, stats and actuator states on both sides
    (drop_ragged follows the decode-side burn)."""
    def run(ns):
        tracker = ns.SLOTracker(ns.SLOPolicy(
            targets={"tpot": 0.01}, objective=0.9, short_window_s=1.0,
            long_window_s=10.0))
        eng = SimpleNamespace(slo=tracker, adapter=_FakeAdapter(),
                              queue=ns.Queue())
        ctl = ns.Controller(enter_burn=2.0, exit_burn=1.0, min_hold_s=5.0,
                            drop_ragged=True)
        t = 100.0
        for i in range(4):
            tracker.observe("tA", "tpot", 1.0, now=t + i * 0.01)
        trail = []
        for dt in (0.5, 2.0, 6.0):
            ctl.update(eng, now=t + dt)
            trail.append((ctl.is_active("shed_speculation", "tA"),
                          ctl.is_active("drop_ragged", "tA"),
                          eng.adapter.spec_shed, eng.adapter.ragged_shed,
                          dict(ctl.stats),
                          ctl.state(now=t + dt)["degraded"]))
        return trail
    trail = _both(run)
    assert [x[:4] for x in trail] == [(True, True, True, True),
                                      (True, True, True, True),
                                      (False, False, False, False)]
    assert trail[-1][4] == {"enters": 2, "exits": 2}


def test_controller_tighten_admission_matches_reference():
    def run(ns):
        tracker = ns.SLOTracker(ns.SLOPolicy(
            targets={"queue_wait": 0.01}, objective=0.9,
            short_window_s=1.0, long_window_s=10.0))
        eng = SimpleNamespace(slo=tracker, adapter=_FakeAdapter(),
                              queue=ns.Queue({"bulk": 2.0}))
        ctl = ns.Controller(enter_burn=2.0, exit_burn=1.0, min_hold_s=0.0,
                            admission_scale=0.25)
        t = 50.0
        for i in range(3):
            tracker.observe("bulk", "queue_wait", 1.0, now=t + i * 0.01)
        ctl.update(eng, now=t + 0.1)
        w1 = eng.queue.weight_of("bulk")
        eng.queue.set_weight_scale("ops", 0.5)
        ctl.update(eng, now=t + 0.2)
        ctl.update(eng, now=t + 3.0)
        return (w1, eng.queue.weight_of("bulk"), eng.queue.weight_of("ops"),
                ctl.degraded, eng.adapter.spec_shed, dict(ctl.stats))
    res = _both(run)
    assert res[:3] == (pytest.approx(0.5), pytest.approx(2.0),
                       pytest.approx(0.5))
    # ConfigurationError is a ValueError in both packages
    for ns in SIDES.values():
        with pytest.raises(ValueError, match="flap"):
            ns.Controller(enter_burn=2.0, exit_burn=2.0)
        with pytest.raises(ValueError, match="admission_scale"):
            ns.Controller(admission_scale=0.0)
    with pytest.raises(ConfigurationError):
        DegradationController(min_hold_s=-1.0)


def test_drop_ragged_keeps_greedy_streams_equal_to_jax_engine():
    """A TTFT target of 1e-9 burns from the first delivered token on, so
    the controller enters ``drop_ragged`` and the port's adapter leaves
    the unified ragged dispatch for the two-phase path mid-serve; the
    greedy streams still equal the JAX engine's (plain ragged, no SLO)."""
    japp, tapp = make_pair(batch_size=2)
    subs = [(P_A, 6), (P_LONG, 5), (P_B, 7)]

    def serve(eng):
        streams = [eng.submit(p, n) for p, n in subs]
        eng.run_until_drained(max_passes=200)
        return [s.drain() for s in streams]
    want = serve(JServingEngine(JPagedEngineAdapter(
        japp, ragged=True, prefill_chunk_tokens=16)))
    slo = SLOTracker(SLOPolicy(targets={"ttft": 1e-9}, objective=0.9,
                               short_window_s=30.0, long_window_s=60.0))
    ctl = DegradationController(min_hold_s=60.0, drop_ragged=True)
    ad = PagedEngineAdapter(tapp, ragged=True, prefill_chunk_tokens=16)
    eng = ServingEngine(ad, slo=slo, degradation=ctl)
    got = serve(eng)
    assert got == want
    assert ctl.is_active("drop_ragged", "default") and ad.ragged_shed
    # decode-side burn also enters shed_speculation, which now finds its
    # hook on the port's adapter (a flag only: no proposer is attached)
    assert ctl.is_active("shed_speculation", "default")
    assert ad.speculation_shed
    state = eng.debug_state()
    assert state["degradation"]["degraded"] is True
    assert state["slo"]["tenants"]["default"]["ttft"]["n"] == len(subs)
    assert ad.host_stats["dispatches"] > ad.host_stats["ragged_dispatches"]
