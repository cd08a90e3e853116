"""The port's telemetry copies against the JAX package's: the same adapter
events render the same Prometheus text (metric names, label sets, bucket
edges and values).

The first test drives ``_AdapterTelemetry`` directly under one fake
``time.perf_counter`` clock, so even the latency histograms agree. The
second serves the same requests through both ragged engines with a
registry attached to each adapter and compares every series that does
not measure wall time."""

import itertools
import re

import pytest

from neuronx_distributed_inference_tpu import telemetry as jtelemetry
from neuronx_distributed_inference_tpu.serving import adapter as jadapter
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.engine import \
    ServingEngine as JServingEngine
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.serving import adapter
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.telemetry import metrics
from test_torch_ragged import P_A, P_B, P_LONG, make_pair


def _events(tel):
    """One scripted sequence of adapter events."""
    tel.on_add([0, 1], [P_A, P_B], 0.0, live=2, padded=2,
               tenants=["gold", "bronze"])
    tel.on_prefill_chunk(2, 2, 21, 32)
    tel.on_step([0, 1], 1.0, padded=2)
    tel.on_ragged_step({"decode": 2, "prefill": 1, "verify": 0, "pad": 1},
                       19, 48)
    tel.on_fetch(1)
    tel.on_step([0], 2.0, padded=2, steps=3)
    tel.on_preempt(1, "grow", "bronze")
    tel.on_deadline([0], ["gold"])
    tel.on_step_failure("ragged", "gold")
    tel.on_admission_rollback()
    tel.on_release([0])


def test_adapter_events_render_identical_prometheus_text(monkeypatch):
    texts = []
    for reg, tel_cls in ((jtelemetry.MetricsRegistry(),
                          jadapter._AdapterTelemetry),
                         (telemetry.MetricsRegistry(),
                          adapter._AdapterTelemetry)):
        clock = itertools.count(start=3.0, step=0.375)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        _events(tel_cls("paged", reg))
        texts.append(reg.render_prometheus())
    jtext, ttext = texts
    assert ttext == jtext
    for name in (metrics.RAGGED_ROWS_TOTAL, metrics.RAGGED_PAD_WASTE,
                 metrics.REQUEST_TTFT_SECONDS + "_bucket"):
        assert name in ttext


def _series(text):
    """Sample lines of an exposition, less the wall-time families."""
    return sorted(line for line in text.splitlines()
                  if line and not line.startswith("#")
                  and not re.match(r"nxdi_\w*seconds", line))


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_served_run_renders_identical_counters(pair):
    japp, tapp = pair
    texts = []
    for app, reg, ad_cls, eng_cls in (
            (japp, jtelemetry.MetricsRegistry(), JPagedEngineAdapter,
             JServingEngine),
            (tapp, telemetry.MetricsRegistry(), PagedEngineAdapter,
             ServingEngine)):
        eng = eng_cls(ad_cls(app, telemetry=reg, ragged=True,
                             prefill_chunk_tokens=16))
        for p, t in ((P_A, "gold"), (P_LONG, "bronze"), (P_B, "gold")):
            eng.submit(p, 4, tenant=t)
        eng.run_until_drained()
        texts.append(_series(reg.render_prometheus()))
    jlines, tlines = texts
    assert tlines == jlines
    assert any(line.startswith(metrics.RAGGED_ROWS_TOTAL) for line in tlines)


def _run_series(text):
    """The application's run-timing series of an exposition: the (kind,
    part) label pairs of ``nxdi_run_seconds`` with their observation
    counts, and the ``nxdi_device_sampled_rows_total`` lines."""
    counts = {}
    for line in text.splitlines():
        if line.startswith(metrics.RUN_SECONDS + "_count{"):
            kind = re.search(r'kind="(\w+)"', line).group(1)
            part = re.search(r'part="(\w+)"', line).group(1)
            counts[(kind, part)] = line.rsplit(" ", 1)[1]
    rows = sorted(line for line in text.splitlines()
                  if line.startswith(metrics.DEVICE_SAMPLED_ROWS_TOTAL))
    return counts, rows


def _timed_schedule(papp, cbapp, paged_cls, cb_cls, reg):
    """One schedule over both adapters with the apps timing into ``reg``:
    packed prefill chunks, decode steps and a fused loop on the paged
    app; a prefill, a decode step and a fused loop on the contiguous
    one."""
    papp.telemetry = reg
    cbapp.telemetry = reg
    try:
        ad = paged_cls(papp)
        ad.add_requests([0, 1], [P_A, P_B])
        for _ in range(2):
            ad.step()
        ad.step_many(2)
        ad.release([0, 1])
        cb = cb_cls(cbapp)
        cb.add_requests([0, 1], [P_A, P_B])
        cb.step()
        cb.step_many(2)
        cb.release([0, 1])
    finally:
        papp.telemetry = None
        cbapp.telemetry = None
    return _run_series(reg.render_prometheus())


def test_run_timings_match_the_reference(pair):
    """``_tel_start`` / ``_tel_end`` around every ``_run_*``: for one
    schedule the (kind, part) pairs of ``nxdi_run_seconds`` (with their
    counts) and ``nxdi_device_sampled_rows_total`` per kind equal the
    reference's."""
    from neuronx_distributed_inference_tpu.serving import \
        ContinuousBatchingAdapter as JCbAdapter
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    from test_torch_decode_pipeline import make_cb_pair
    japp, tapp = pair
    jcb, tcb = make_cb_pair()
    want = _timed_schedule(japp, jcb, JPagedEngineAdapter, JCbAdapter,
                           jtelemetry.MetricsRegistry())
    got = _timed_schedule(tapp, tcb, PagedEngineAdapter,
                          ContinuousBatchingAdapter,
                          telemetry.MetricsRegistry())
    assert got == want
    assert set(got[0]) == {(k, p) for k in ("paged", "paged_loop",
                                            "prefill", "decode",
                                            "decode_loop")
                           for p in ("host", "device")}


def test_disabled_telemetry_does_no_timing(pair):
    """With the registry and the flight recorder off, ``_tel_start`` is
    None: no clock read and no device wait in ``_tel_end``; a live
    registry or recorder starts the clock."""
    _, tapp = pair
    assert not telemetry.get_registry().enabled
    assert tapp._tel_start() is None
    tapp._tel_end("paged", None, {"tokens": None}, 1)   # returns at once
    tapp.telemetry = telemetry.MetricsRegistry()
    try:
        assert isinstance(tapp._tel_start(), float)
    finally:
        tapp.telemetry = None
    telemetry.enable_recorder()
    try:
        assert isinstance(tapp._tel_start(), float)
    finally:
        telemetry.disable_recorder()
