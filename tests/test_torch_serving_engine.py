"""The port's ServingEngine over its ragged and two-phase paged adapters,
against the JAX package's ServingEngine on the same submissions.

Geometry and weights: tests/test_torch_ragged.py (the tiny head_dim-16
Llama of tests/test_ragged_dispatch.py, fp32, numpy weights from a seed in
both applications). Streams, finish reasons and the integer counters of
``ServingEngine.stats`` are equal; every pass makes at most one decode
dispatch (ragged: at most one dispatch of any kind)."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.resilience import FAULTS as JFAULTS
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.engine import \
    ServingEngine as JServingEngine
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, ConfigurationError, DegradationController)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.telemetry.slo import (
    SLOPolicy, SLOTracker)
from test_torch_ragged import P_A, P_B, P_LONG, make_pair

SIDES = {"jax": (JPagedEngineAdapter, JServingEngine, JFAULTS),
         "port": (PagedEngineAdapter, ServingEngine, FAULTS)}


@pytest.fixture(scope="module")
def pair():
    return make_pair(batch_size=2)


def _serve(app, side, ragged, submissions, tenant_weights=None,
           fault=None, max_passes=200, chunk=16):
    """Drive one engine to drained (prefill chunks of ``chunk`` tokens);
    returns (streams, finish reasons, stats, per-pass admitted request
    ids, per-pass dispatch deltas)."""
    adapter_cls, engine_cls, faults = SIDES[side]
    ad = adapter_cls(app, ragged=ragged, prefill_chunk_tokens=chunk)
    eng = engine_cls(ad, tenant_weights=tenant_weights)
    streams = [eng.submit(p, n, tenant=t) for p, n, t in submissions]
    admitted, deltas = [], []
    passes = 0
    while eng.has_work:
        before = dict(ad.host_stats)
        if fault is not None and passes == fault[1]:
            with faults.inject(fault[0]) as fp:
                eng.run_pass()
            assert fp.trips == 1
        else:
            eng.run_pass()
        passes += 1
        assert passes < max_passes
        deltas.append({k: ad.host_stats[k] - before.get(k, 0)
                       for k in ("dispatches", "prefill_dispatches",
                                 "blocking_fetches")})
        admitted.append(sorted(r.request_id for r in eng._active.values()))
    toks = [s.drain() for s in streams]
    reasons = [s.finish_reason for s in streams]
    stats = {k: v for k, v in eng.stats.items() if isinstance(v, int)}
    assert app.kv_mgr.tables == {}
    return toks, reasons, stats, admitted, deltas


SUBS = [(P_A, 6, "default"), (P_B, 5, "default"), (P_LONG, 4, "default")]


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged",
                                                       "two_phase"])
def test_engine_streams_match_jax(pair, ragged):
    """Three requests through a batch of two: the third waits for a slot.
    Streams, finish reasons, stats and the per-pass admission order equal
    the JAX engine's; each pass makes at most one decode dispatch, and a
    ragged pass at most one dispatch of any kind and one fetch."""
    japp, tapp = pair
    want = _serve(japp, "jax", ragged, SUBS)
    got = _serve(tapp, "port", ragged, SUBS)
    assert got[:4] == want[:4]
    assert [len(t) for t in got[0]] == [6, 5, 4]
    assert got[1] == ["length"] * 3
    for d in got[4]:
        assert d["dispatches"] <= 1
        if ragged:
            assert d["prefill_dispatches"] == 0
            assert d["blocking_fetches"] <= 1


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged",
                                                       "two_phase"])
def test_engine_heals_fault_mid_serve(pair, ragged):
    """A fault at the step's fault point mid-serve (ragged_step, or
    decode_step on the two-phase path) is a retry-safe StepFailure: the
    engine counts a retry and every stream finishes as the fault-free
    run's, on both packages."""
    japp, tapp = pair
    point = "ragged_step" if ragged else "decode_step"
    clean = _serve(tapp, "port", ragged, SUBS[:2])
    want = _serve(japp, "jax", ragged, SUBS[:2], fault=(point, 2))
    got = _serve(tapp, "port", ragged, SUBS[:2], fault=(point, 2))
    assert got[0] == want[0] == clean[0]
    assert got[2] == want[2]
    assert got[2]["step_retries"] >= 1


def test_engine_weighted_fair_admission_matches_jax(pair):
    """Two tenants at weights 3:1 queue four requests each behind a batch
    of two: the per-pass admission order (the weighted-fair pick) and the
    streams equal the JAX engine's."""
    japp, tapp = pair
    rng = np.random.default_rng(12)
    subs = []
    for i in range(4):
        for tenant in ("gold", "bronze"):
            subs.append((rng.integers(1, 500, size=int(rng.integers(5, 14)))
                         .tolist(), 3, tenant))
    weights = {"gold": 3.0, "bronze": 1.0}
    want = _serve(japp, "jax", True, subs, tenant_weights=weights)
    got = _serve(tapp, "port", True, subs, tenant_weights=weights)
    assert got[:4] == want[:4]
    first_two = [r for r in got[3] if r][0]
    assert len(first_two) == 2


def test_engine_refuses_unported_planes(pair):
    """slo= and degradation= are ported: the engine applies the
    reference's checks (scheduler.py:107-126) — degradation= needs slo=,
    needs an ``update`` surface, and its hysteresis band must sit below
    the policy's burn threshold — and accepts a valid pair."""
    _, tapp = pair
    ad = PagedEngineAdapter(tapp, ragged=True)
    slo = SLOTracker(SLOPolicy(targets={"ttft": 1.0}))
    with pytest.raises(ConfigurationError, match="needs slo="):
        ServingEngine(ad, degradation=DegradationController())
    with pytest.raises(ConfigurationError, match="update"):
        ServingEngine(ad, slo=slo, degradation=object())
    with pytest.raises(ConfigurationError, match="exit_burn"):
        ServingEngine(ad, slo=slo,
                      degradation=DegradationController(exit_burn=5.0))
    eng = ServingEngine(ad, slo=slo, degradation=DegradationController())
    assert eng.slo is slo and "slo" in eng.debug_state()
