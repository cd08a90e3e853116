"""The port's depth-1 decode pipeline against its eager path and the JAX
package's pipeline (tests/test_decode_pipeline.py:106-345).

Geometry: the tiny Llama of tests/test_torch_ragged.py (hidden 64, 2
layers, 4 q / 2 kv heads of head_dim 16, vocab 512), fp32, batch 2, with
the same numpy weights in both packages; the ``hd64`` cases widen it to
head_dim 64, where a full batch takes the decode kernels' branches (the
port's twins on CPU tensors). The JAX side runs with
``jax_default_matmul_precision="highest"`` (conftest).

  * pipelined streams equal the eager streams of the same adapter kind,
    and the JAX adapters' own ``pipeline_depth=1`` streams, token for
    token, with the same integer ``host_stats``;
  * the reference's failure contract: a deferred fetch failure
    (``pipeline_flush``) rolls positions and paged KV growth back to the
    last delivered token with ``retry_safe=False``; a dispatch fault keeps
    the healthy in-flight step; deadlines, preemption, re-admission
    scratch and drained tokens as in the reference; depth 2 is refused;
  * a request admitted with the prompt blocks of a row whose step is in
    flight, and a row released and re-admitted under the same id while
    its step is in flight, give the eager streams (no stale token);
  * a ragged or speculative step, ``step_many`` and ``release`` drain the
    pipeline first; the pipeline hooks set ``nxdi_dispatch_depth`` and
    feed ``nxdi_host_overlap_seconds``."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JCausalLMApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.serving import (
    ContinuousBatchingAdapter as JCbAdapter,
    PagedEngineAdapter as JPagedEngineAdapter)
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, ConfigurationError, DeadlineExceeded, StepFailure)
from neuronx_distributed_inference_tpu_torch.serving import (
    ContinuousBatchingAdapter, PagedEngineAdapter)
from neuronx_distributed_inference_tpu_torch.telemetry import metrics
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_ragged import HF, HF_HD64, _numpy_weights, make_pair

RNG = np.random.default_rng(5)
P1 = RNG.integers(1, 500, size=9).tolist()
P2 = RNG.integers(1, 500, size=12).tolist()
CB_TCFG = dict(batch_size=2, seq_len=64, dtype="float32",
               enable_bucketing=True, context_encoding_buckets=[16],
               is_continuous_batching=True)


def make_cb_pair(hf=HF, seed=7):
    """(JAX, port) contiguous continuous-batching apps on the same numpy
    weights."""
    japp = JCausalLMApp(None, JLlamaConfig(JTpuConfig(**CB_TCFG), **hf),
                        JLlamaFamily)
    japp.init_random_weights(0)
    host = _numpy_weights(japp, seed)
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
    """Module-cached (JAX app, port app) of ``kind``: cb / paged, with an
    ``_hd64`` suffix for head_dim 64."""
    if kind not in _PAIRS:
        hf = HF_HD64 if kind.endswith("_hd64") else HF
        _PAIRS[kind] = (make_cb_pair(hf) if kind.startswith("cb")
                        else make_pair(hf))
    return _PAIRS[kind]


def adapter_cls(kind, jax_side=False):
    if kind.startswith("cb"):
        return JCbAdapter if jax_side else ContinuousBatchingAdapter
    return JPagedEngineAdapter if jax_side else PagedEngineAdapter


def _int_stats(eng):
    return {k: v for k, v in eng.host_stats.items() if isinstance(v, int)}


def _eager_streams(make_eng, n_steps):
    """{seq_id: [prefill token + n_steps tokens]} from an eager adapter."""
    eng = make_eng(0)
    res = eng.add_requests([0, 1], [P1, P2])
    out = {0: [res[0]], 1: [res[1]]}
    for _ in range(n_steps):
        for s, t in eng.step().items():
            out[s].append(t)
    eng.release([0, 1])
    return out


def _pipelined_streams(make_eng):
    """The reference's schedule (tests/test_decode_pipeline.py:130-145):
    one call fills the pipeline, four deliver, a call on row 0 alone
    drains the both-row dispatch, ``flush`` drains the last."""
    eng = make_eng(1)
    res = eng.add_requests([0, 1], [P1, P2])
    got = {0: [res[0]], 1: [res[1]]}
    assert eng.step() == {}
    for _ in range(4):
        for s, t in eng.step().items():
            got[s].append(t)
    for s, t in eng.step([0]).items():
        got[s].append(t)
    for s, t in eng.flush().items():
        got[s].append(t)
    assert eng._inflight is None
    eng.release([0, 1])
    return got, eng


@pytest.mark.parametrize("kind", ["cb", "paged", "cb_hd64", "paged_hd64"])
def test_pipelined_streams_match_eager_and_jax(kind):
    japp, tapp = pair_of(kind)
    port = adapter_cls(kind)
    ref = _eager_streams(lambda d: port(tapp, pipeline_depth=d), 6)
    got, eng = _pipelined_streams(lambda d: port(tapp, pipeline_depth=d))
    assert got[0] == ref[0] and got[1] == ref[1][:6], (got, ref)
    # the same schedule on the JAX app (the prefix cache warms alike)
    jax_port = adapter_cls(kind, True)
    assert _eager_streams(lambda d: jax_port(japp, pipeline_depth=d),
                          6) == ref
    jgot, jeng = _pipelined_streams(
        lambda d: jax_port(japp, pipeline_depth=d))
    assert got == jgot
    assert _int_stats(eng) == {k: jeng.host_stats[k]
                               for k in _int_stats(eng)}
    # dispatches: 1 + 4 + 1 (the row-0 call); every one fetched once
    assert eng.host_stats["dispatches"] == 6
    assert eng.host_stats["blocking_fetches"] == 6


@pytest.mark.parametrize("kind", ["cb", "paged"])
def test_pipeline_depth_validated(kind):
    _, tapp = pair_of(kind)
    with pytest.raises(ConfigurationError, match="pipeline_depth"):
        adapter_cls(kind)(tapp, pipeline_depth=2)
    assert adapter_cls(kind)(tapp, pipeline_depth=1).pipeline_depth == 1


def test_lookahead_fetch_failure_rolls_back_to_delivered():
    """A failure at the deferred fetch unwinds both in-flight dispatches:
    positions and KV growth return to the last delivered token, not
    retry-safe."""
    _, tapp = pair_of("paged")
    eng = PagedEngineAdapter(tapp, pipeline_depth=1)
    eng.add_requests([0], [P1])
    free_admitted = tapp.kv_mgr.allocator.num_free
    assert eng.step() == {}
    assert eng.debug_state()["pipeline_inflight"] == 1
    with FAULTS.inject("pipeline_flush"):
        with pytest.raises(StepFailure) as ei:
            eng.step()
    assert ei.value.retry_safe is False and ei.value.phase == "decode"
    assert eng.seqs[0].position == len(P1)
    assert tapp.kv_mgr.lens[0] == len(P1)
    assert tapp.kv_mgr.allocator.num_free == free_admitted
    assert eng._inflight is None
    eng.release([0])
    assert tapp.kv_mgr.tables == {}


def test_dispatch_fault_preserves_lookahead_and_stream():
    """A fault at dispatch keeps the healthy in-flight step (retry-safe),
    and retrying delivers the eager stream."""
    _, tapp = pair_of("cb")
    ref = _eager_streams(
        lambda d: ContinuousBatchingAdapter(tapp, pipeline_depth=d), 3)
    eng = ContinuousBatchingAdapter(tapp, pipeline_depth=1)
    res = eng.add_requests([0, 1], [P1, P2])
    got = {0: [res[0]], 1: [res[1]]}
    assert eng.step() == {}
    with FAULTS.inject("decode_step"):
        with pytest.raises(StepFailure) as ei:
            eng.step()
    assert ei.value.retry_safe is True
    assert eng._inflight is not None
    for _ in range(2):
        for s, t in eng.step().items():
            got[s].append(t)
    for s, t in eng.flush().items():
        got[s].append(t)
    eng.release([0, 1])
    assert got == ref


def test_pipelined_deadline_leaves_pipeline_intact():
    _, tapp = pair_of("paged")
    eng = PagedEngineAdapter(tapp, pipeline_depth=1)
    eng.add_requests([0], [P1], deadline_s=60.0)
    assert eng.step() == {}
    eng.seqs[0].deadline = 0.0               # the budget runs out
    with pytest.raises(DeadlineExceeded):
        eng.step()
    assert eng._inflight is not None
    eng.release([0])                         # drains and drops the token
    assert eng._inflight is None and eng._ready == {}
    assert tapp.kv_mgr.tables == {}


def test_pipelined_preemption_replays_the_eager_stream():
    """Preemption under KV pressure mid-pipeline: the victim's record
    (without its in-flight token) replays to the eager stream."""
    _, tapp = pair_of("paged")

    def eager(prompt, sid, n):
        eng = PagedEngineAdapter(tapp)
        out = [eng.add_requests([sid], [prompt])[sid]]
        for _ in range(n - 1):
            out.append(eng.step()[sid])
        eng.release([sid])
        return out

    ref0, ref1 = eager(P1, 0, 6), eager(P2, 1, 6)
    eng = PagedEngineAdapter(tapp, pipeline_depth=1,
                             preemption_policy="lifo")
    got0 = [eng.add_requests([0], [P1])[0]]
    assert eng.step() == {}
    got1 = [eng.add_requests([1], [P2])[1]]
    got0.append(eng.step()[0])
    with FAULTS.inject("paged_alloc") as fp:
        res = eng.step()                     # preempts row 1 (LIFO)
    assert fp.trips == 1
    got0.extend(t for s, t in res.items() if s == 0)
    got1.extend(t for s, t in res.items() if s == 1)
    recs = eng.take_preempted()
    assert [r.seq_id for r in recs] == [1] and recs[0].reason == "grow"
    assert list(recs[0].tokens) == P2 + got1
    while len(got0) < 6:
        r = eng.step()
        if 0 in r:
            got0.append(r[0])
    got0.extend(eng.flush().values())
    assert got0[:6] == ref0
    got1b = [eng.add_requests([1], [list(recs[0].tokens)])[1]]
    replay = list(recs[0].tokens[len(P2):]) + got1b
    while len(replay) < 6:
        r = eng.step([1])
        if 1 in r:
            replay.append(r[1])
    replay.extend(eng.flush().values())
    assert replay[:6] == ref1
    eng.release([0, 1])


def test_pipelined_deadline_keeps_drained_token():
    """A DeadlineExceeded between drain and dispatch keeps the drained
    token pending; the next call delivers it."""
    _, tapp = pair_of("paged")
    ref = _eager_streams(lambda d: PagedEngineAdapter(
        tapp, pipeline_depth=d), 2)
    eng = PagedEngineAdapter(tapp, pipeline_depth=1)
    eng.add_requests([0, 1], [P1, P2])
    assert eng.step() == {}
    eng.release([1])                         # drains; row 0's token pends
    eng.seqs[0].deadline = 0.0
    with pytest.raises(DeadlineExceeded):
        eng.step([0])
    eng.seqs[0].deadline = None
    eng.seqs[0].expired_reported = False
    assert eng.step([0])[0] == ref[0][1]
    eng.release([0])


def test_step_many_drains_the_inflight_token():
    """``step_many`` retires the in-flight step first; its token leads the
    row's list, and the stream equals the eager one."""
    _, tapp = pair_of("cb")
    ref = _eager_streams(
        lambda d: ContinuousBatchingAdapter(tapp, pipeline_depth=d), 4)
    eng = ContinuousBatchingAdapter(tapp, pipeline_depth=1)
    res = eng.add_requests([0, 1], [P1, P2])
    got = {0: [res[0]], 1: [res[1]]}
    assert eng.step() == {}
    for s, ts in eng.step_many(3).items():
        got[s].extend(ts)
    assert eng._inflight is None
    eng.release([0, 1])
    assert got == ref


def test_scratch_invalidated_on_readmission_in_flight():
    """Release and re-admit row 1 (same block count, blocks reordered)
    while a step is in flight: the released row's in-flight token is
    dropped, the re-admitted row gets a fresh table and the eager
    single-request stream."""
    _, tapp = pair_of("paged")
    p3 = RNG.integers(1, 500, size=len(P2)).tolist()
    eng = PagedEngineAdapter(tapp, pipeline_depth=1)
    eng.add_requests([0, 1], [P1, P2])
    assert eng.step() == {}
    old = list(tapp.kv_mgr.tables[1])
    eng.release([1])
    assert eng._inflight is None and 1 not in eng._ready
    got3 = [eng.add_requests([1], [p3])[1]]
    assert tapp.kv_mgr.tables[1] != old
    while len(got3) < 3:
        got3.extend(t for s, t in eng.step().items() if s == 1)
    got3.extend(t for s, t in eng.flush().items() if s == 1)
    np.testing.assert_array_equal(
        eng._scratch.bt[1, :len(tapp.kv_mgr.tables[1])],
        tapp.kv_mgr.tables[1])
    eng.release([0, 1])
    ge = PagedEngineAdapter(tapp)
    ref3 = [ge.add_requests([1], [p3])[1]]
    for _ in range(3):
        ref3.append(ge.step()[1])
    ge.release([1])
    assert got3 == ref3[:len(got3)]


def test_prefix_shared_admission_while_in_flight():
    """A request whose prompt shares the running row's full prompt block
    is admitted while that row's step is in flight: it hits the prefix
    cache (prompt blocks are published at admission, written by the
    row's prefill before any decode step), and both streams equal the
    eager schedule's."""
    _, tapp = pair_of("paged")
    shared = P2 + RNG.integers(1, 500, size=5).tolist()

    def run(depth):
        eng = PagedEngineAdapter(tapp, pipeline_depth=depth)
        got = {0: [eng.add_requests([0], [P2])[0]]}
        for _ in range(2):
            for s, t in eng.step().items():
                got[s].append(t)
        assert (eng._inflight is not None) == bool(depth)
        before = eng.host_stats["prefill_real_tokens"]
        got[1] = [eng.add_requests([1], [shared])[1]]
        computed = eng.host_stats["prefill_real_tokens"] - before
        for _ in range(4):
            for s, t in eng.step().items():
                got[s].append(t)
        for s, t in eng.flush().items():
            got[s].append(t)
        eng.release([0, 1])
        return got, computed

    piped, computed = run(1)                 # first: the tail is cold
    eager, _ = run(0)
    assert computed == len(shared) - 8      # P2's one full block hit
    assert piped[0] == eager[0][:len(piped[0])] and len(piped[0]) == 7
    assert piped[1] == eager[1][:len(piped[1])] and len(piped[1]) == 5


def test_ragged_and_spec_steps_flush_the_pipeline():
    """A ragged or speculative adapter built with pipeline_depth=1 retires
    a pipelined step before its unified or speculative step, as the
    reference does; streams equal the depth-0 adapter's."""
    _, tapp = pair_of("paged")

    def collect(res, toks):
        for t in res.values():
            toks.extend(t if isinstance(t, list) else [t])

    for kw in ({"ragged": True, "prefill_chunk_tokens": 16},
               {"speculation": 2}):
        streams = []
        for depth in (0, 1):
            eng = PagedEngineAdapter(tapp, pipeline_depth=depth, **kw)
            toks = []
            collect(eng.add_requests([0], [P1]), toks)
            if kw.get("ragged"):
                # shed: the first token, then a two-phase decode step,
                # pipelined at depth 1
                eng.set_ragged_shed(True)
                for _ in range(2):
                    collect(eng.step(), toks)
                assert (eng._inflight is not None) == bool(depth)
                eng.set_ragged_shed(False)
            while len(toks) < 6:
                collect(eng.step(), toks)
                assert eng._inflight is None
            collect(eng.flush(), toks)
            eng.release([0])
            streams.append(toks[:6])
        assert streams[0] == streams[1], kw


def test_pipeline_hooks_and_debug_state():
    """``nxdi_dispatch_depth`` reads 1 while a step is in flight and 0
    after ``flush``; every pipelined fetch observes
    ``nxdi_host_overlap_seconds``; ``debug_state`` counts the in-flight
    rows."""
    _, tapp = pair_of("cb")
    reg = telemetry.MetricsRegistry()
    eng = ContinuousBatchingAdapter(tapp, pipeline_depth=1, telemetry=reg)
    eng.add_requests([0, 1], [P1, P2])
    eng.step()
    depth = reg.get(metrics.DISPATCH_DEPTH)
    assert depth.get(engine="cb") == 1
    assert eng.debug_state()["pipeline_inflight"] == 2
    eng.step()
    eng.step()
    assert depth.get(engine="cb") == 1
    eng.flush()
    assert depth.get(engine="cb") == 0
    assert eng.debug_state()["pipeline_inflight"] == 0
    text = reg.render_prometheus()
    assert (metrics.HOST_OVERLAP_SECONDS + '_count{engine="cb"} 3') in text
    eng.release([0, 1])


def test_full_cb_batch_takes_the_decode_kernel(monkeypatch):
    """Under continuous batching a step that holds every cache row in
    order (the identity rows) takes the contiguous decode kernel's branch
    (its twin on CPU tensors), eager and pipelined alike; a step over
    part of the rows (padded with row 0) keeps the gather path."""
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    _, tapp = pair_of("cb_hd64")
    calls = []
    real = decode_attention.decode_attention_stacked

    def spy(*a, **k):
        calls.append(a[5])
        return real(*a, **k)
    monkeypatch.setattr(decode_attention, "decode_attention_stacked", spy)
    layers = tapp.spec.num_layers
    for depth in (0, 1):
        calls.clear()
        eng = ContinuousBatchingAdapter(tapp, pipeline_depth=depth)
        eng.add_requests([0, 1], [P1, P2])
        eng.step()
        eng.step()
        assert calls == list(range(layers)) * 2
        eng.step([1])                  # one row: not the identity
        eng.flush()
        assert len(calls) == 2 * layers
        eng.release([0, 1])


def test_cb_warmup_covers_a_full_batch_with_a_free_row():
    """After ``precompile``, a continuous-batching app whose full batch
    takes the decode kernel serves steps with a free row (padded with row
    0: the gather path) and full in-order steps (the kernel), eager and
    pipelined, without a steady-state incident."""
    from neuronx_distributed_inference_tpu_torch.serving.warmup import \
        precompile
    _, tapp = pair_of("cb_hd64")
    seen, steady = set(tapp._jit_seen), tapp._steady_state
    tapp._jit_seen.clear()
    try:
        precompile(tapp)
        for depth in (0, 1):
            eng = ContinuousBatchingAdapter(tapp, pipeline_depth=depth)
            for rows, prompts in (([0], [P1]), ([0, 1], [P1, P2])):
                eng.add_requests(rows, prompts)
                eng.step()
                eng.step()
                eng.flush()
                eng.release(rows)
        assert tapp.warmup_state()["incidents"] == []
    finally:
        tapp._jit_seen = seen
        tapp.declare_steady_state(steady)
        tapp._steady_incidents.clear()


def test_engine_serves_through_a_pipelined_adapter():
    """``ServingEngine`` over a depth-1 paged adapter (three requests on
    batch 2: one waits for a row) gives the depth-0 streams and the JAX
    engine's over its depth-1 adapter."""
    from neuronx_distributed_inference_tpu.serving.engine import \
        ServingEngine as JServingEngine
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    japp, tapp = pair_of("paged")
    p3 = RNG.integers(1, 500, size=20).tolist()
    got = []
    for app, ad_cls, eng_cls, depth in (
            (tapp, PagedEngineAdapter, ServingEngine, 0),
            (tapp, PagedEngineAdapter, ServingEngine, 1),
            (japp, JPagedEngineAdapter, JServingEngine, 1)):
        eng = eng_cls(ad_cls(app, pipeline_depth=depth))
        streams = [eng.submit(p, 5) for p in (P1, P2, p3)]
        eng.run_until_drained()
        got.append([s.drain() for s in streams])
    assert got[1] == got[0] == got[2]
    assert all(len(s) == 5 for s in got[0])
