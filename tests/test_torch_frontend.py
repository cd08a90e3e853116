"""The port's HTTP/SSE front door (serving/engine/frontend.py) over
``ServingEngine(slo=, degradation=)`` and the ragged adapter, driven by a
real asyncio client in-process (as tests/test_serving_engine.py:355 does
for the reference): SSE token events equal the JAX app's ``generate`` on
the same weights (greedy, fp32: identical), and the debug and metrics
routes serve the warm-up plane, the SLO and degradation state and the
memory ledger. Tiny fp32 Llama of tests/test_torch_ragged.py on the CPU."""

import asyncio
import json

import numpy as np
import pytest

from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.resilience import (
    ConfigurationError, DegradationController)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import (
    ServingEngine, ServingFrontend)
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    precompile
from neuronx_distributed_inference_tpu_torch.telemetry import \
    trace as trace_mod
from neuronx_distributed_inference_tpu_torch.telemetry.slo import (
    SLOPolicy, SLOTracker)
from test_torch_ragged import P_A, P_B, P_LONG, make_pair

PROMPTS = [P_A, P_B, P_LONG[:14]]
NEW = 6


async def _http(host, port, raw: bytes) -> str:
    r, w = await asyncio.open_connection(host, port)
    w.write(raw)
    await w.drain()
    data = await asyncio.wait_for(r.read(), timeout=60)
    w.close()
    return data.decode()


def _post(path: str, payload) -> bytes:
    body = json.dumps(payload).encode()
    return (f"POST {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\n\r\n"
            .encode() + body)


def _body(resp: str):
    return json.loads(resp.split("\r\n\r\n", 1)[1])


def _sse_tokens(resp: str):
    events = [json.loads(line[6:]) for line in resp.splitlines()
              if line.startswith("data: ")]
    assert events[-1]["done"] is True and events[-1]["reason"] == "length"
    assert [e["index"] for e in events[:-1]] == list(range(len(events) - 1))
    return [e["token"] for e in events[:-1]]


@pytest.fixture(scope="module")
def served():
    """Serve PROMPTS through the front door concurrently, then read every
    debug route; returns (golden streams, SSE streams, route bodies)."""
    japp, tapp = make_pair(batch_size=2)
    golden = [japp.generate(np.asarray([p]),
                            max_new_tokens=NEW)["generated"][0].tolist()
              for p in PROMPTS]
    reg = telemetry.enable()
    trace_mod.enable_recorder()
    try:
        report = precompile(tapp, registry=reg)
        slo = SLOTracker(SLOPolicy(targets={"ttft": 60.0, "tpot": 10.0}))
        eng = ServingEngine(
            PagedEngineAdapter(tapp, ragged=True, prefill_chunk_tokens=16),
            slo=slo, degradation=DegradationController(drop_ragged=True))

        async def main():
            fe = ServingFrontend(eng)
            host, port = await fe.start()
            sse = await asyncio.gather(*[
                _http(host, port, _post("/v1/generate", {
                    "prompt": p, "max_new_tokens": NEW,
                    "request_id": f"q{i}"}))
                for i, p in enumerate(PROMPTS)])
            routes = {path: await _http(
                host, port, f"GET {path} HTTP/1.1\r\n\r\n".encode())
                for path in ("/metrics", "/v1/metrics", "/v1/debug/state",
                             "/v1/debug/memory", "/v1/debug/trace/q0",
                             "/v1/debug/trace/nope", "/healthz")}
            routes["blocks"] = eng.adapter.debug_state()["blocks"]
            await fe.stop()
            return sse, routes
        sse, routes = asyncio.run(main())
    finally:
        trace_mod.disable_recorder()
        telemetry.disable()
    return golden, [_sse_tokens(r) for r in sse], routes, report


def test_sse_streams_equal_jax_generate(served):
    golden, streams, _, _ = served
    assert streams == golden


def test_debug_state_serves_warmup_slo_and_degradation(served):
    _, _, routes, report = served
    state = _body(routes["/v1/debug/state"])["engine"]
    warm = state["warmup"]
    assert warm["steady_state"] is True and warm["incidents"] == []
    assert warm["precompile"]["n_graphs"] == report["n_graphs"]
    assert state["slo"]["tenants"]["default"]["ttft"]["n"] == len(PROMPTS)
    assert state["degradation"]["degraded"] is False
    assert _body(routes["/healthz"])["ok"] is True


def test_metrics_and_memory_routes(served):
    _, _, routes, _ = served
    for path in ("/metrics", "/v1/metrics"):
        text = routes[path]
        assert "nxdi_steady_state_recompiles_total" in text
        assert not [line for line in text.splitlines()
                    if line.startswith("nxdi_steady_state_recompiles_total")
                    and float(line.rsplit(" ", 1)[1]) != 0.0]
        assert "nxdi_slo_burn_rate" in text
    mem = _body(routes["/v1/debug/memory"])
    assert mem["schema"] == "nxdi-memory-ledger-v1"
    assert mem["kv"]["blocks"] == routes["blocks"]


def test_trace_routes(served):
    _, _, routes, _ = served
    chrome = _body(routes["/v1/debug/trace/q0"])
    names = [e["name"] for e in chrome["traceEvents"]]
    assert "trace.begin" in names and "trace.emit" in names
    missing = routes["/v1/debug/trace/nope"]
    assert missing.startswith("HTTP/1.1 404")
    assert _body(missing)["type"] == "trace_not_found"


def test_submit_stream_cancel_and_refusals():
    """/v1/submit + /v1/stream replay + /v1/cancel, the non-streaming
    JSON body, a typed 400, and ``fleet=`` refused until the fleet layer
    is ported."""
    _, tapp = make_pair(batch_size=2)
    eng = ServingEngine(PagedEngineAdapter(tapp, ragged=True))
    with pytest.raises(ConfigurationError, match="fleet"):
        ServingFrontend(eng, fleet=object())

    async def main():
        fe = ServingFrontend(eng)
        host, port = await fe.start()
        rid = _body(await _http(host, port, _post(
            "/v1/submit", {"prompt": P_A, "max_new_tokens": 4})))[
                "request_id"]
        streamed = _sse_tokens(await _http(
            host, port, f"GET /v1/stream/{rid} HTTP/1.1\r\n\r\n".encode()))
        whole = _body(await _http(host, port, _post(
            "/v1/generate", {"prompt": P_A, "max_new_tokens": 4,
                             "stream": False})))
        rid2 = _body(await _http(host, port, _post(
            "/v1/submit", {"prompt": P_B, "max_new_tokens": 40})))[
                "request_id"]
        cancelled = _body(await _http(
            host, port, f"POST /v1/cancel/{rid2} HTTP/1.1\r\n\r\n".encode()))
        bad = await _http(host, port, _post("/v1/generate", {"prompt": []}))
        await fe.stop()
        return streamed, whole, cancelled, bad
    streamed, whole, cancelled, bad = asyncio.run(main())
    assert len(streamed) == 4 and whole["tokens"] == streamed
    assert cancelled == {"cancelled": True}
    assert bad.startswith("HTTP/1.1 400") and _body(bad)["type"] == \
        "bad_request"
