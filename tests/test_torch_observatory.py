"""The port's compiled-graph observatory (``telemetry/observatory.py``)
against the JAX package's (tests/test_flight_recorder.py:357-380).

Apps: the tiny Llama of tests/test_torch_ragged.py (hidden 64, 4 q / 2 kv
heads of head_dim 16, vocab 512), fp32, batch 2, ``decode_chunk_tokens``
4 so the fused loops are graphs too, as a paged app and a contiguous
continuous-batching app, each pair on the same numpy weights; the
``hd64`` apps widen it to head_dim 64, where the T = 1 graphs take the
decode kernels' branches and the counter adds the kernels' own work.

  * the (kind, bucket) list equals the reference's ``analyze_app``;
  * each graph's flops equal an analytic count of its products (2% held):
    the weights' multiply-adds per token, attention's QK and PV over the
    keys each query reads (the kernel's formula where the kernel runs:
    the table's or cache row's capacity plus the active token), the lm
    head over the rows (or columns) it reads; fused loops times k;
  * at one layer each graph's flops lie within 10% below the reference's
    ``cost_analysis`` flops: XLA also counts elementwise ops (norms,
    RoPE, softmax, the SiLU gate), which the port's count leaves out. Two
    differences are structural and corrected for before the comparison:
    XLA counts the body of a scan once (the reference's fused loops; at
    one layer its layer scan runs once too), and the port's ragged step
    runs the lm head on one column where no row verifies, the
    reference's on every column;
  * the report touches no device state (cache and parameters bit for
    bit), sets the gauges, has no roofline on the CPU unless the figures
    are given, refuses a collective op, and feeds
    ``memory_ledger(graph_report=)`` the reference's ``graphs`` section.
"""

import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JCausalLMApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving import warmup as jwarmup
from neuronx_distributed_inference_tpu.telemetry import observatory as jobs
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving import warmup
from neuronx_distributed_inference_tpu_torch.telemetry import (
    metrics, observatory)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_ragged import HF, HF_HD64, _numpy_weights, make_pair

CHUNK = 4
CB_TCFG = dict(batch_size=2, seq_len=64, dtype="float32",
               enable_bucketing=True, context_encoding_buckets=[16],
               is_continuous_batching=True, decode_chunk_tokens=CHUNK)


def make_cb_pair(hf):
    japp = JCausalLMApp(None, JLlamaConfig(JTpuConfig(**CB_TCFG), **hf),
                        JLlamaFamily)
    japp.init_random_weights(0)
    host = _numpy_weights(japp, 7)
    japp._put_params(host)
    japp.init_cache()
    tapp = CausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**CB_TCFG), **hf), LlamaFamily,
        device="cpu")
    tapp.params = params_from_numpy(host, device="cpu")
    tapp.init_cache()
    return japp, tapp


_PAIRS = {}


def pair_of(kind):
    """(JAX app, port app): ``paged`` / ``cb``, ``_hd64`` for head_dim
    64, ``_1l`` for one layer."""
    if kind not in _PAIRS:
        hf = HF_HD64 if "_hd64" in kind else HF
        if kind.endswith("_1l"):
            hf = dict(hf, num_hidden_layers=1)
        _PAIRS[kind] = (make_cb_pair(hf) if kind.startswith("cb")
                        else make_pair(hf, decode_chunk_tokens=CHUNK))
    return _PAIRS[kind]


def _products(spec, tokens, t, keys, lm_rows, kernel=False):
    """2 x multiply-adds of one step: the layers' weights over ``tokens``,
    attention's QK and PV for each of the ``tokens`` queries over
    ``keys`` (the kernel adds the active token), the lm head over
    ``lm_rows``."""
    h, i = spec.hidden_size, spec.intermediate_size
    q, kv, d = spec.q_size, spec.kv_size, spec.head_dim
    per_token = h * (q + 2 * kv) + q * h + 3 * h * i
    attn = 2 * tokens * spec.num_q_heads * (keys + int(kernel)) * d
    return 2 * (spec.num_layers * (tokens * per_token + attn)
                + lm_rows * h * spec.vocab_size)


def analytic_flops(app, kind, bucket, kernel):
    spec, cfg = app.spec, app.tpu_config
    if kind.startswith("paged") or kind in ("spec_verify", "ragged"):
        b = cfg.batch_size
        keys = app.max_blocks * cfg.pa_block_size
        if kind == "paged":
            w = int(bucket[1:bucket.index("x")])
            return _products(spec, b * w, w, keys, b, kernel)
        if kind == "paged_loop":
            return CHUNK * _products(spec, b, 1, keys, b, kernel)
        w = 4
        lm = b * w if kind == "spec_verify" else b
        return _products(spec, b * w, w, keys, lm)
    if kind == "prefill":
        s, cb = (int(x) for x in bucket[3:].split("xb"))
        return _products(spec, cb * s, s, s, cb)
    bb = int(bucket[1:].split("x")[0])
    step = _products(spec, bb, 1, cfg.seq_len, bb, kernel)
    return step if kind == "decode" else CHUNK * step


@pytest.fixture
def kernel_calls():
    """Names of the hand-written kernels the counter was handed (a second
    listener beside the observatory's)."""
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    calls = []
    with decode_attention.kernel_work_listener(
            lambda name, flops, nbytes: calls.append(name)):
        yield calls


@pytest.mark.parametrize("kind", ["paged", "cb"])
def test_graph_list_matches_reference(kind):
    japp, tapp = pair_of(kind)
    rep = observatory.analyze_app(tapp)
    jrep = jobs.analyze_app(japp)
    assert rep["schema"] == jrep["schema"] == "nxdi-graph-report-v1"
    assert ([(g["kind"], g["bucket"]) for g in rep["graphs"]]
            == [(g["kind"], g["bucket"]) for g in jrep["graphs"]])
    assert set(rep) == set(jrep)
    assert set(rep["graphs"][0]) >= set(jrep["graphs"][0])


@pytest.mark.parametrize("kind", ["paged", "cb", "paged_hd64", "cb_hd64"])
def test_flops_equal_the_analytic_products(kind, kernel_calls):
    _, tapp = pair_of(kind)
    weights = (observatory._nbytes(tapp.params)
               - observatory._nbytes(tapp.params["embed"]))
    for g in observatory.analyze_app(tapp)["graphs"]:
        before = len(kernel_calls)
        entry = [e for e in observatory._graph_entries(tapp)
                 if e[:2] == (g["kind"], g["bucket"])][0]
        flops, nbytes = observatory._count(entry[3])
        assert (flops, nbytes) == (g["flops"], g["bytes_accessed"])
        kernel = len(kernel_calls) > before
        if kernel:
            # the decode kernel on every layer of every step
            steps = CHUNK if "loop" in g["kind"] else 1
            assert (len(kernel_calls) - before
                    == steps * tapp.spec.num_layers)
        want = analytic_flops(tapp, g["kind"], g["bucket"], kernel)
        assert abs(g["flops"] - want) <= 0.02 * want, (g, want)
        # bytes: every product reads its weight; the embedding is gathered
        assert g["bytes_accessed"] >= weights and g["arithmetic_intensity"]
    if kind.endswith("_hd64"):
        assert kernel_calls                 # the T = 1 graphs' kernels
    else:
        assert not kernel_calls


@pytest.mark.parametrize("kind", ["paged_1l", "cb_1l"])
def test_flops_within_reference_cost_analysis(kind):
    japp, tapp = pair_of(kind)
    rep = observatory.analyze_app(tapp)
    jrep = jobs.analyze_app(japp)
    spec, b = tapp.spec, tapp.tpu_config.batch_size
    for g, jg in zip(rep["graphs"], jrep["graphs"]):
        port = g["flops"]
        if "loop" in g["kind"]:
            port /= CHUNK                   # XLA counts a scan body once
        if g["kind"] == "ragged":
            port += 2 * b * 3 * spec.hidden_size * spec.vocab_size
        ratio = port / jg["flops"]
        assert 0.90 <= ratio <= 1.0, (g["kind"], g["bucket"], ratio)


def test_report_touches_no_state_and_sets_gauges():
    _, tapp = pair_of("paged")
    cache = {k: v.clone() for k, v in tapp.cache.items()}
    params = {k: v.clone() for k, v in tapp.params["layers"].items()}
    reg = telemetry.MetricsRegistry()
    rep = observatory.analyze_app(tapp, registry=reg)
    for k, v in tapp.cache.items():
        assert torch.equal(v, cache[k])
    for k, v in tapp.params["layers"].items():
        assert torch.equal(v, params[k])
    b = tapp.tpu_config.batch_size
    assert reg.get(metrics.GRAPH_FLOPS).get(
        kind="paged", bucket=f"w1xb{b}") > 0
    assert reg.get(metrics.GRAPH_BYTES).get(
        kind="paged", bucket=f"w16xb{b}") > 0
    assert reg.get(metrics.COMPILE_SECONDS).get(
        kind="paged", bucket=f"w1xb{b}") == 0.0
    for g in rep["graphs"]:
        # the CPU: nothing captured, no card figures
        assert g["compile_seconds"] == 0.0 and g["memory"] is None
        assert g["roofline"] is None
        assert g["collectives"] is None and g["collective_count"] is None
    assert rep["totals"]["graphs"] == len(rep["graphs"])
    # the figures given: a roofline; a zero figure means an unknown chip
    rep = observatory.analyze_app(tapp, hbm_gbps=3350.0, peak_tflops=67.0)
    g = rep["graphs"][0]
    want_ms = max(g["flops"] / 67e12, g["bytes_accessed"] / 3350e9) * 1e3
    # the report keeps 6 decimals of a ms, as the reference does
    assert g["roofline"]["est_step_ms"] == pytest.approx(want_ms, abs=1e-6)
    assert g["roofline"]["bound"] in ("compute", "memory")
    rep = observatory.analyze_app(tapp, hbm_gbps=0.0, peak_tflops=67.0)
    assert rep["graphs"][0]["roofline"] is None
    assert observatory.device_peaks("cpu") is None


def test_collective_in_a_single_device_graph_raises(monkeypatch):
    _, tapp = pair_of("paged")
    step = model_base.paged_forward_step

    def leaky(*args, **kw):
        out = step(*args, **kw)
        torch.ops._c10d_functional.all_reduce(out["tokens"].float(), "sum",
                                              "0")
        return out
    monkeypatch.setattr(model_base, "paged_forward_step", leaky)
    with pytest.raises(RuntimeError, match="collective"):
        observatory.analyze_app(tapp)


def test_memory_ledger_graphs_section():
    japp, tapp = pair_of("paged")
    jad = JPagedEngineAdapter(japp)
    tad = PagedEngineAdapter(tapp)
    report = {"graphs": [{"label": "paged/w1xb2",
                          "memory": {"peak_bytes": 1234}},
                         {"label": "ragged/W4xb2",
                          "memory": {"peak_bytes": 99}}]}
    jl = jwarmup.memory_ledger(jad, graph_report=report)
    tl = warmup.memory_ledger(tad, graph_report=report)
    assert tl["graphs"] == jl["graphs"] == {"paged/w1xb2": 1234,
                                           "ragged/W4xb2": 99}
    assert set(tl) == set(jl)
    assert "graphs" not in warmup.memory_ledger(tad)
    rep = observatory.analyze_app(tapp)
    tl = warmup.memory_ledger(tad, graph_report=rep)
    assert tl["graphs"] == {g["label"]: None for g in rep["graphs"]}
    assert list(tl["graphs"])[0] == "paged/w16xb2"


def test_counter_takes_fp32_output_products():
    """A bf16 pair into fp32 (``out_dtype``, the card's route of
    ``ops/attention._bmm_f32``) is counted from its shapes and answered
    with its ``out`` or an empty result, without the fake-tensor
    decomposition (which fails on it in some torch releases)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), observatory._WorkCounter() as counter:
        a = torch.empty(2, 3, 4, dtype=torch.bfloat16)
        b = torch.empty(2, 4, 5, dtype=torch.bfloat16)
        out = torch.empty(2, 3, 5)
        got = torch.baddbmm(out, a, b, beta=0.0, alpha=0.5,
                            out_dtype=torch.float32, out=out)
        got2 = torch.bmm(a, b, out_dtype=torch.float32)
    assert got is out
    assert got2.shape == (2, 3, 5) and got2.dtype == torch.float32
    assert counter.flops == 2 * (2 * 2 * 3 * 4 * 5)


def test_kernel_wrappers_answer_fake_tensors_without_a_listener():
    """A FakeTensorMode trace outside the observatory (torch.compile,
    export) gets each kernel wrapper's empty output of its shape; a
    listener hears each call's work by the kernel's formula."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention as da, flash_attention as fa)
    b, hq, hkv, d, s, layers, bs = 2, 4, 2, 64, 32, 2, 8
    with FakeTensorMode():
        q = torch.empty(b, hq, d)
        nk, nv = torch.empty(b, hkv, d), torch.empty(b, hkv, d)
        lens = torch.zeros(b, dtype=torch.int32)
        calls = [
            ("decode_attention_stacked", lambda: da.decode_attention_stacked(
                q, torch.empty(layers, b, hkv, d, s),
                torch.empty(layers, b, hkv, s, d), nk, nv, 1, lens,
                scale=d ** -0.5), (b, hq, d)),
            ("paged_decode_attention", lambda: da.paged_decode_attention(
                q, torch.empty(layers, 9, bs, hkv, d),
                torch.empty(layers, 9, bs, hkv, d), nk, nv, 1, lens,
                torch.zeros(b, s // bs, dtype=torch.int32),
                scale=d ** -0.5), (b, hq, d)),
            ("flash_attention", lambda: fa.flash_attention(
                torch.empty(b, s, hq, d), torch.empty(b, s, hkv, d),
                torch.empty(b, s, hkv, d), scale=d ** -0.5),
             (b, s, hq, d))]
        heard = []
        for name, call, shape in calls:
            out = call()
            assert isinstance(out, FakeTensor) and tuple(out.shape) == shape
            with da.kernel_work_listener(
                    lambda *a: heard.append(a)):
                call()
            assert heard[-1][0] == name
    # QK and PV over s keys and the active token, every row and head
    assert heard[0][1] == heard[1][1] == 4 * (b * s + b) * hq * d
    assert heard[2][1] == 4 * b * hq * d * s * (s + 1) // 2
    assert da._work_listeners == []
