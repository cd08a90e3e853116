"""The port's warm-up plane (serving/warmup.py, the app's signature
accounting, models/cuda_graphs.py) and its bf16 attention cores, against
the JAX package.

* bf16 ``mha`` / ``mha_hl`` / ``mha_decode_merged``: the same seed-made
  inputs rounded to bf16 on both sides; the port's CPU route multiplies
  fp32 copies (a product of two bf16 values is exact in fp32), JAX's
  einsums accumulate bf16 operands in fp32. Both round the probabilities
  and the output to bf16, so they may differ by a bf16 rounding of the
  probabilities and the output: the tolerance is two bf16 ulps of the
  largest |v| (every output is a convex combination of value rows).
  XLA's CPU runtime cannot run a bf16 x bf16 -> f32 dot whose batch
  dimensions lead both operands ("Unsupported element type for
  DotThunk"), which the JAX ``mha_hl`` and ``mha_decode_merged`` einsums
  are; those two are held to JAX's bf16 ``mha`` (same math, same dtype
  flow) over the same keys laid out as ``mha`` takes them (the merged
  core's keys concatenated: prior, side, active token).
* ``precompile``'s report has the reference's schema and keys; after it a
  first-seen graph signature is an incident (counter, event, trace lane),
  as tests/test_warmup_plane.py:148,183 pins for the reference; eager
  signatures never are.
* ``memory_ledger`` reconciles with ``debug_state()["blocks"]`` and its
  parameter and pool bytes equal the JAX ledger's.
* Replacing ``params`` or ``cache`` drops the app's CUDA graphs.

The tiny Llama and its weights are tests/test_torch_ragged.py's. Tests that
need the card carry the ``cuda`` marker and skip from inside the test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.warmup import (
    memory_ledger as jmemory_ledger, precompile as jprecompile)
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.models.cuda_graphs import \
    StepGraphs
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.warmup import (
    LEDGER_SCHEMA, WARMUP_SCHEMA, admission_headroom, memory_ledger,
    precompile)
from neuronx_distributed_inference_tpu_torch.telemetry import \
    metrics as tmetrics
from neuronx_distributed_inference_tpu_torch.telemetry import \
    trace as trace_mod
from test_torch_ragged import P_A, P_B, make_pair


# ---------------------------------------------------------------------------
# bf16 attention cores
# ---------------------------------------------------------------------------

def _bf16_pair(x):
    """The same fp32 array as a JAX and a torch bf16 array (both round to
    nearest even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _tol(v) -> float:
    vmax = float(np.abs(np.asarray(v, np.float32)).max())
    return 2 * 2.0 ** (np.floor(np.log2(vmax)) - 7)


def _close(got, want, tol):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= tol, np.abs(g - w).max()


@pytest.mark.parametrize("soft_cap,sink", [(None, False), (5.0, True)])
def test_bf16_mha_matches_jax(soft_cap, sink):
    rng = np.random.default_rng(3)
    b, t, s, hq, hkv, d = 2, 5, 24, 4, 2, 16
    q, k, v = (rng.standard_normal(sh) for sh in
               ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    mask = rng.random((b, t, s)) < 0.7
    mask[:, :, 0] = True
    sk = rng.standard_normal(hq).astype(np.float32) if sink else None
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    kw = dict(logits_soft_cap=soft_cap)
    want = jax.jit(jattn.mha, static_argnums=4,
                   static_argnames="logits_soft_cap")(
        jq, jk, jv, jnp.asarray(mask), 0.25,
        sink=None if sk is None else jnp.asarray(sk), **kw)
    got = tattn.mha(tq, tk, tv, torch.from_numpy(mask), 0.25,
                    sink=None if sk is None else torch.from_numpy(sk), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, _tol(tv.float()))


def test_bf16_mha_hl_matches_jax():
    """The contiguous cache's layouts: K transposed (B, Hkv, D, S), V
    (B, Hkv, S, D), read through a view cut at 20 of 32 slots."""
    rng = np.random.default_rng(4)
    b, t, s, hq, hkv, d, view = 2, 1, 32, 4, 2, 16, 20
    q = rng.standard_normal((b, t, hq, d))
    k = rng.standard_normal((b, hkv, d, s))
    v = rng.standard_normal((b, hkv, s, d))
    pos = np.array([[13], [19]])
    mask = np.arange(view)[None, None, :] <= pos[:, :, None]
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    want = jax.jit(jattn.mha, static_argnums=4)(
        jq, jk[..., :view].transpose(0, 3, 1, 2),
        jv[:, :, :view].transpose(0, 2, 1, 3), jnp.asarray(mask), 0.25)
    got = tattn.mha_hl(tq, tk[..., :view], tv[:, :, :view],
                       torch.from_numpy(mask), 0.25)
    _close(got, want, _tol(tv.float()))


def test_bf16_mha_decode_merged_matches_jax():
    rng = np.random.default_rng(5)
    b, hq, hkv, d, s, c = 2, 4, 2, 16, 24, 4
    arrs = [rng.standard_normal(sh) for sh in (
        (b, 1, hq, d), (b, hkv, d, s), (b, hkv, s, d), (b, hkv, d, c),
        (b, hkv, c, d), (b, 1, hkv, d), (b, 1, hkv, d))]
    mask_p = np.arange(s)[None, None, :] < np.array([[10], [17]])[:, :, None]
    mask_s = np.arange(c)[None, None, :] < np.array([[2], [3]])[:, :, None]
    pairs = list(map(_bf16_pair, arrs))
    j = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    keys = jnp.concatenate([j[1].transpose(0, 3, 1, 2),
                            j[3].transpose(0, 3, 1, 2), j[5]], axis=1)
    vals = jnp.concatenate([j[2].transpose(0, 2, 1, 3),
                            j[4].transpose(0, 2, 1, 3), j[6]], axis=1)
    mask = np.concatenate([mask_p, mask_s, np.ones((b, 1, 1), bool)], -1)
    want = jax.jit(jattn.mha, static_argnums=4)(
        j[0], keys, vals, jnp.asarray(mask), 0.25)
    got = tattn.mha_decode_merged(t[0], t[1], t[2],
                                  torch.from_numpy(mask_p), t[3], t[4],
                                  torch.from_numpy(mask_s), t[5], t[6], 0.25)
    vmax = max(float(x.float().abs().max()) for x in (t[2], t[4], t[6]))
    _close(got, want, _tol(vmax))


@pytest.mark.cuda
def test_bf16_mha_allocates_no_fp32_kv_copy():
    """On the card the bf16 products take bf16 operands: the peak memory
    of one ``mha`` call stays below what one fp32 copy of K and V alone
    would add, and the output equals the fp32 route within the bf16
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, t, s, hq, hkv, d = 2, 1, 65536, 32, 8, 128
    q = torch.randn((b, t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
    mask = torch.ones((b, t, s), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = tattn.mha(q, k, v, mask, d ** -0.5)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    fp32_kv = 2 * k.numel() * 4
    assert extra < fp32_kv, (extra, fp32_kv)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = tattn.mha(q.float(), k.float(), v.float(), mask, d ** -0.5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (out.float() - ref).abs().max().item() <= _tol(
        v.float().cpu()) + 2 ** -7


# ---------------------------------------------------------------------------
# the warm-up report and the steady-state sentinel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return make_pair(batch_size=2)


def _dummy_paged(app, bt_width):
    b = app.tpu_config.batch_size
    app._run_paged(np.zeros((b, 1), np.int32), np.zeros((b, 1), np.int32),
                   np.full((b, 1), -1, np.int32),
                   np.zeros((b, bt_width), np.int32),
                   np.zeros((b,), np.int32))


def test_precompile_report_has_the_reference_schema(pair):
    """Same keys as the JAX report, per graph too; every outcome one of
    the port's three; a second walk finds every run signature warm."""
    japp, tapp = pair
    jrep = jprecompile(japp, widths=[1, 16], declare_steady=False)
    rep = precompile(tapp, widths=[1, 16], declare_steady=False)
    assert rep["schema"] == jrep["schema"] == WARMUP_SCHEMA
    assert set(rep) == set(jrep)
    assert all(set(g) == set(jrep["graphs"][0]) for g in rep["graphs"])
    kinds = [(g["kind"], g["bucket"], g["outcome"]) for g in rep["graphs"]]
    # on the CPU nothing is captured: the T = 1 steps run eagerly
    assert kinds == [("ragged", 1, "eager"), ("ragged", 16, "eager"),
                     ("paged", 1, "eager")]
    assert rep["n_graphs"] == 3 and rep["n_compiles"] == 0
    assert rep["n_cache_loads"] == 3 and rep["cache_monitored"] is False
    again = precompile(tapp, widths=[1, 16], declare_steady=False)
    assert [g["outcome"] for g in again["graphs"]] == ["warm", "eager",
                                                       "warm"]
    state = tapp.warmup_state()
    assert set(state["precompile"]) == set(
        japp.warmup_state()["precompile"])
    assert state["steady_state"] is False


def test_steady_state_graph_signature_is_a_tracked_incident():
    """As the reference pins (tests/test_warmup_plane.py:148): after
    steady state, a T = 1 step at a table width outside the warmed ladder
    moves ``nxdi_steady_state_recompiles_total``, lands a
    ``compile.unexpected`` event carrying the dispatch's traces and shows
    in ``warmup_state()``; the warmed signature and an eager (wide) one
    stay incident-free."""
    _, tapp = make_pair(batch_size=2)
    rep = precompile(tapp, widths=[1])
    assert rep["n_graphs"] == 2
    reg = telemetry.enable()
    rec = trace_mod.enable_recorder()
    try:
        with tapp.request_context(["t-direct", None]):
            _dummy_paged(tapp, 3)          # width 3: not a bucket
        assert reg.get(tmetrics.STEADY_STATE_RECOMPILES_TOTAL).get(
            kind="paged", bucket="1") == 1
        inc = tapp.warmup_state()["incidents"]
        assert len(inc) == 1 and inc[0]["kind"] == "paged"
        assert inc[0]["bucket"] == "1" and inc[0]["traces"] == ["t-direct"]
        evs = [e for e in rec.events() if e["name"] == "compile.unexpected"]
        assert len(evs) == 1 and evs[0]["args"]["traces"] == ["t-direct"]
        with tapp.request_context(["t-warm"]):
            _dummy_paged(tapp, tapp._bt_buckets[0])
            b = tapp.tpu_config.batch_size
            tapp._run_ragged(np.zeros((b, 8), np.int32),
                             np.zeros((b, 8), np.int32),
                             np.full((b, 8), -1, np.int32),
                             np.zeros((b, tapp._bt_buckets[0]), np.int32),
                             np.ones((b,), np.int32),
                             np.zeros((b,), np.int32))
        assert len(tapp.warmup_state()["incidents"]) == 1
    finally:
        trace_mod.disable_recorder()
        telemetry.disable()


def test_adapter_dispatch_attributes_incident_to_request_trace():
    """Through the serving path (reference tests/test_warmup_plane.py:183):
    an app warmed only at table width 1 serves a ragged request; its
    all-decode steps run at the full table width, and the incident carries
    the request's trace id. The eager prefill chunk is no incident."""
    _, tapp = make_pair(batch_size=2)
    precompile(tapp, widths=[1], bt_widths=[1])
    ad = PagedEngineAdapter(tapp, ragged=True)
    assert ad.add_requests([0], [P_A], meta=[{"trace": "t-adapter"}]) == {}
    for _ in range(3):
        ad.step()
    ad.release([0])
    hits = tapp.warmup_state()["incidents"]
    assert hits and all(i["traces"] == ["t-adapter"] for i in hits)
    assert {i["kind"] for i in hits} == {"ragged"}
    assert {i["bucket"] for i in hits} == {"1"}


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------

def test_memory_ledger_reconciles_and_matches_jax():
    japp, tapp = make_pair(batch_size=2)
    ad = PagedEngineAdapter(tapp)
    jad = JPagedEngineAdapter(japp)
    ad.add_requests([0, 1], [P_A, P_B])
    jad.add_requests([0, 1], [P_A, P_B])
    reg = telemetry.MetricsRegistry()
    led = memory_ledger(ad, registry=reg)
    jled = jmemory_ledger(jad)
    assert led["schema"] == jled["schema"] == LEDGER_SCHEMA
    assert led["model_bytes"] == jled["model_bytes"] > 0
    assert led["kv"]["pool_bytes"] == jled["kv"]["pool_bytes"]
    assert led["kv"]["blocks"] == ad.debug_state()["blocks"]
    assert led["kv"]["blocks"] == jled["kv"]["blocks"]
    kv = led["kv"]
    assert (kv["bytes"]["used"] + kv["bytes"]["free"]
            == kv["blocks"]["usable"] * kv["block_bytes"])
    assert led["headroom"] == admission_headroom(ad)
    assert reg.get(tmetrics.HBM_MODEL_BYTES).get() == led["model_bytes"]
    ad.release([0, 1])
    jad.release([0, 1])


# ---------------------------------------------------------------------------
# stale graphs
# ---------------------------------------------------------------------------

def test_replacing_params_or_cache_drops_the_graphs(pair):
    """A graph reads the tensors it was captured over: a new ``params`` or
    ``cache`` drops them; the contiguous ``reset`` zeroes the cache in
    place and keeps them; the paged ``reset`` only releases blocks."""
    from test_torch_contiguous_app import LLAMA, _llama_tcfg, _pair
    _, capp = _pair(LLAMA, _llama_tcfg())
    _, papp = pair
    for app in (capp, papp):
        app.graphs = StepGraphs(torch.device("cpu"))
        app.graphs._graphs["sig"] = object()
        app.reset()
        assert len(app.graphs) == 1
        app.params = app.params
        assert len(app.graphs) == 0
        app.graphs._graphs["sig"] = object()
        app.init_cache()
        assert len(app.graphs) == 0
        app.graphs = None
    k = capp.cache["k"]
    k.fill_(1.0)
    capp.reset()
    assert capp.cache["k"] is k and not k.any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_pair():
    """Two port paged apps on the card with the same weights: one replays
    graphs, one runs every step eagerly."""
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        PagedCausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.llama import (
        LlamaFamily, LlamaInferenceConfig)
    from test_torch_ragged import HF_HD64, TCFG
    apps = []
    for graphs in (True, False):
        cfg = LlamaInferenceConfig(TpuConfig(**dict(TCFG,
                                                    output_logits=True)),
                                   **HF_HD64)
        apps.append(PagedCausalLMApplication(None, cfg, LlamaFamily,
                                             device="cuda",
                                             cuda_graphs=graphs))
    apps[0].init_random_weights(3)
    apps[1].params = apps[0].params
    for a in apps:
        a.init_cache()
    return apps


@pytest.mark.cuda
def test_captured_step_equals_eager_step_and_counts_replays():
    """A T = 1 paged step replayed from its graph gives the eager step's
    tokens and logits on the same cache; the graph holds one paged-kernel
    launch a layer, and its replays are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    g_app, e_app = _cuda_pair()
    prompts = np.asarray([P_A[:8], P_B[:8]])
    g_app.generate(prompts, max_new_tokens=2)
    e_app.cache = g_app.cache
    b = 2
    bt = g_app.kv_mgr.block_table_array(range(b), g_app._bt_width(b))
    args = (np.asarray([[5], [7]], np.int32), np.full((b, 1), 9, np.int32),
            np.full((b, 1), -1, np.int32), bt, np.zeros((b,), np.int32))
    layers = g_app.spec.num_layers
    g_app.graphs.reset_counts()
    eager0 = decode_attention.paged_decode_attention.launches
    outs = [g_app._run_paged(*args) for _ in range(3)]
    assert decode_attention.paged_decode_attention.launches == eager0
    sig = g_app.graphs.signatures()[-1]
    assert g_app.graphs.kernel_launches(sig) == {
        "paged_decode_attention": layers}
    assert g_app.graphs.replayed_launches("paged_decode_attention") == \
        3 * layers
    want = e_app._run_paged(*args)
    for o in outs:
        assert torch.equal(o["tokens"], want["tokens"])
        assert (o["logits"] - want["logits"]).abs().max().item() <= 1e-4
