"""Seeded sampling and self-draft speculative serving of the port, held to
the JAX package's streams (the pins of tests/test_sampled_spec.py and
tests/test_spec_serving.py).

Geometry: the tiny fp32 Llama of those files (``HF``: hidden 64, 2 layers,
4 q / 2 kv heads, head_dim 16, vocab 512; block 8, 24 blocks, ctx bucket
16, prefix caching on), batch 2, with the same numpy weights put into the
JAX app and the port's (``test_torch_ragged._numpy_weights``); TF32 off.
The sampled apps carry ``SC`` (do_sample, top_k 8, top_p 0.95, temperature
1.3, stream_seed 11). Tolerance: every served stream of the port EQUALS the
JAX package's stream for the same prompt, weights and seed. A token may
differ only at a near-tie of the coupled draw (two perturbed scores within
1e-5: torch's ``log`` and XLA's differ by an ULP); ``_equal_streams``
would print and count such a case, and none occurs at these seeds."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    OnDeviceSamplingConfig as JOnDeviceSamplingConfig,
    TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.resilience import FAULTS as JFAULTS
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.speculation import (
    PerturbedSelfDraftProposer as JPerturbed,
    SelfDraftProposer as JSelfDraft)
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.config import (
    OnDeviceSamplingConfig, SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.modules import autobucketing
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, ConfigurationError, StepFailure)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.serving.fleet import \
    HostKVSpillTier
from neuronx_distributed_inference_tpu_torch.serving.speculation import (
    PerturbedSelfDraftProposer, SelfDraftProposer, validate_spec_sampling)
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    precompile
from neuronx_distributed_inference_tpu_torch.telemetry import \
    metrics as tmetrics
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_ragged import HF, TCFG, _numpy_weights

SC = dict(do_sample=True, top_k=8, top_p=0.95, temperature=1.3,
          stream_seed=11)
RNG = np.random.default_rng(23)
P_A = RNG.integers(1, 500, size=9).tolist()
P_B = RNG.integers(1, 500, size=12).tolist()
P_LONG = RNG.integers(1, 500, size=24).tolist()   # 2 chunks of 16
PATHS = ["two_phase", "ragged"]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _pair(sampled: bool, seed=7):
    """(JAX app, port app) on TCFG, seeded sampled or greedy, with the
    same numpy weights."""
    jkw = dict(TCFG)
    kw = dict(TCFG)
    if sampled:
        jkw["on_device_sampling_config"] = JOnDeviceSamplingConfig(**SC)
        kw["on_device_sampling_config"] = OnDeviceSamplingConfig(**SC)
    japp = JPagedApp(None, JLlamaConfig(JTpuConfig(**jkw), **HF),
                     JLlamaFamily)
    japp.init_random_weights(0)
    host = _numpy_weights(japp, seed)
    japp._put_params(host)
    japp.init_cache()
    tapp = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**kw), **HF), LlamaFamily,
        device="cpu")
    tapp.params = params_from_numpy(host, device="cpu")
    tapp.init_cache()
    return japp, tapp


@pytest.fixture(scope="module")
def sampled():
    return _pair(True)


@pytest.fixture(scope="module")
def greedy():
    return _pair(False)


def _adapter(side, app, path, proposer=None, **kw):
    cls = JPagedEngineAdapter if side == "jax" else PagedEngineAdapter
    if path == "ragged":
        kw["ragged"] = True
    if proposer is not None:
        kw["speculation"] = proposer
    return cls(app, **kw)


def _proposer(side, kind="self", k=3, corrupt_at=1):
    if kind == "self":
        return (JSelfDraft if side == "jax" else SelfDraftProposer)(k)
    return (JPerturbed if side == "jax" else PerturbedSelfDraftProposer)(
        k, corrupt_at=corrupt_at)


def _collect(eng, sids, prompts, want, meta=None):
    """Drive an adapter until every stream holds ``want`` tokens; returns
    (streams, steps). Ragged adapters defer admission."""
    res = eng.add_requests(sids, prompts, meta=meta)
    got = {s: ([res[s]] if s in res else []) for s in sids}
    steps = 0
    while any(len(got[s]) < want for s in sids):
        for s, toks in eng.step().items():
            got[s].extend(toks if isinstance(toks, list) else [toks])
        steps += 1
        assert steps < 60, "decode made no progress"
    return {s: got[s][:want] for s in sids}, steps


def _equal_streams(want, got):
    """Streams equal; a first difference would be printed (a near-tie of
    the coupled draw is the one allowed cause, and none occurs here)."""
    for s in want:
        if want[s] != got[s]:
            i = next(j for j, (a, b) in enumerate(zip(want[s], got[s]))
                     if a != b)
            print(f"stream {s} first differs at token {i}: "
                  f"{want[s][i]} vs {got[s][i]}")
    assert got == want


def _both(pair, path, proposer_kind=None, want=12, **kw):
    out = []
    for side, app in zip(("jax", "port"), pair):
        prop = (_proposer(side, proposer_kind) if proposer_kind else None)
        eng = _adapter(side, app, path, prop, **kw)
        got, steps = _collect(eng, [0, 1], [P_A, P_B], want)
        stats = {k: v for k, v in eng.host_stats.items()
                 if isinstance(v, int)}
        eng.release([0, 1])
        out.append((got, steps, stats))
    return out


@pytest.fixture(scope="module")
def sampled_refs(sampled):
    """The eager two-phase seeded streams (port), held to JAX's."""
    (jgot, _, _), (got, _, _) = _both(sampled, "two_phase")
    _equal_streams(jgot, got)
    return got


# ---------------------------------------------------------------------------
# seeded eager sampling
# ---------------------------------------------------------------------------

def test_seeded_eager_matches_jax_and_is_request_seeded(sampled,
                                                        sampled_refs):
    """Seeded sampled streams equal the JAX package's, reproduce, and a
    per-request ``sampling_seed`` forks the stream (on both paths)."""
    japp, tapp = sampled
    for path in PATHS:
        streams = []
        for side, app in (("jax", japp), ("port", tapp)):
            eng = _adapter(side, app, path)
            got, _ = _collect(eng, [0], [P_A], 12,
                              meta=[{"sampling_seed": 5}])
            eng.release([0])
            streams.append(got)
        _equal_streams(streams[0], streams[1])
        assert streams[1][0] != sampled_refs[0]
    (_, _, _), (again, _, _) = _both(sampled, "ragged")
    assert again == sampled_refs


def test_seeded_generate_matches_jax(sampled):
    """The paged ``generate`` samples with the coupled draw (row seeds 0),
    as the reference's does."""
    japp, tapp = sampled
    ids = np.asarray([P_B[:9], P_A])
    want = japp.generate(ids, max_new_tokens=6)["generated"]
    got = tapp.generate(ids, max_new_tokens=6)["generated"]
    tapp.reset()
    japp.reset()
    assert np.array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# self-draft and perturbed speculation on both paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_sampled_self_draft_matches_jax_and_eager(sampled, sampled_refs,
                                                  path):
    """Seeded sampled self-draft streams equal the JAX package's and the
    eager streams; the coupled verify replays the draft's draws (accept
    rate 1.0 in fp32); the ragged path makes one dispatch and one
    blocking fetch per step."""
    (jgot, jsteps, jst), (got, steps, st) = _both(sampled, path, "self")
    _equal_streams(jgot, got)
    assert got == sampled_refs
    assert st["spec_accepted_tokens"] == st["spec_drafted_tokens"] > 0
    assert (st["spec_drafted_tokens"], st["spec_accepted_tokens"]) == (
        jst["spec_drafted_tokens"], jst["spec_accepted_tokens"])
    assert steps == jsteps
    if path == "ragged":
        assert st["ragged_dispatches"] == st["ragged_steps"] == steps
        assert st["blocking_fetches"] == steps
        assert st["spec_verify_dispatches"] == 0


@pytest.mark.parametrize("path", PATHS)
def test_sampled_perturbed_partial_accept_matches_jax(sampled, sampled_refs,
                                                      path):
    """corrupt_at=1: exactly 1 of 3 drafts accepted, and the stream is
    still the eager sampled stream (the bonus is the coupled draw)."""
    (jgot, _, jst), (got, _, st) = _both(sampled, path, "perturbed")
    _equal_streams(jgot, got)
    assert got == sampled_refs
    rate = st["spec_accepted_tokens"] / st["spec_drafted_tokens"]
    assert rate == pytest.approx(1 / 3)
    assert st["spec_drafted_tokens"] == jst["spec_drafted_tokens"]


def test_greedy_self_draft_cold_then_warm(greedy):
    """Greedy self-draft k=3, cold (no prefix hits) then warm: streams
    equal JAX's and eager decode; every draft accepted, 11 tokens a row in
    3 verify dispatches, 2 dispatches and 1 fetch a step."""
    japp, tapp = greedy
    (jgot, _, _), (got, steps, st) = _both(greedy, "two_phase", "self")
    _equal_streams(jgot, got)
    (_, _, _), (eager, _, _) = _both(greedy, "two_phase")
    assert got == eager
    assert st["spec_accepted_tokens"] == st["spec_drafted_tokens"] > 0
    assert st["spec_verify_dispatches"] == st["spec_steps"] == steps == 3
    assert st["dispatches"] == 2 * steps
    assert st["blocking_fetches"] == steps
    (_, _, _), (warm, _, _) = _both(greedy, "two_phase", "self")
    assert warm == got


def test_perturbed_kv_shrinks_to_accepted_prefix(greedy):
    """After each partial-accept step the rows hold the blocks of an eager
    row at the same position, as on the JAX side: draft KV never outlives
    its step."""
    japp, tapp = greedy
    blocks = []
    for side, app in (("jax", japp), ("port", tapp)):
        eng = _adapter(side, app, "two_phase", _proposer(side, "perturbed"))
        eng.add_requests([0, 1], [P_A, P_B])
        for _ in range(3):
            eng.step()
        blocks.append(({s: len(app.kv_mgr.tables[s]) for s in (0, 1)},
                       {s: eng.seqs[s].position for s in (0, 1)},
                       eng.host_stats["spec_accepted_tokens"]))
        eng.release([0, 1])
        assert app.kv_mgr.tables == {}
    assert blocks[1] == blocks[0]
    assert blocks[1][2] == 3 * 1 * 2


# ---------------------------------------------------------------------------
# one dispatch per step, budgets by tokens
# ---------------------------------------------------------------------------

def test_one_verify_dispatch_per_step_under_mixed_load(greedy):
    """A deferred 2-chunk admission next to a speculating row: every step
    runs one prefill-chunk dispatch and exactly one verify; both streams
    equal the JAX adapter's."""
    outs = []
    for side, app in zip(("jax", "port"), greedy):
        eng = _adapter(side, app, "two_phase", _proposer(side),
                       prefill_chunk_tokens=16, prefill_budget_tokens=16)
        assert eng.add_requests([0], [P_A]) == {}
        run = list(eng.step()[0])
        assert eng.add_requests([1], [P_LONG]) == {}
        new = []
        while len(new) < 3:
            before = dict(eng.host_stats)
            res = eng.step()
            assert (eng.host_stats["spec_verify_dispatches"]
                    - before["spec_verify_dispatches"]) == 1
            assert (eng.host_stats["prefill_dispatches"]
                    - before["prefill_dispatches"]) <= 1
            run.extend(res.get(0, []))
            new.extend(res.get(1, []))
        eng.release([0, 1])
        outs.append((run, new))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("path", PATHS)
def test_step_many_budgets_by_tokens(greedy, path):
    """step_many(6) delivers exactly 6 tokens a row in 2 speculative steps
    (4 + a clamped 2), never overshooting, as the JAX adapter does."""
    outs = []
    for side, app in zip(("jax", "port"), greedy):
        eng = _adapter(side, app, path, _proposer(side))
        res = eng.add_requests([0], [P_A])
        first = eng.step_many(1, [0])[0] if not res else [res[0]]
        more = eng.step_many(6, [0])[0]
        outs.append((first, more, eng.host_stats["spec_steps"]))
        eng.release([0])
    assert outs[1] == outs[0]
    assert len(outs[1][1]) == 6


def test_engine_run_pass_budgets_by_tokens_delivered(greedy):
    """ServingEngine over speculative adapters (two-phase and ragged):
    streams equal the eager engine's, exactly max_new_tokens each, at most
    one verify dispatch (ragged: one blocking fetch) per pass, and a
    spec_verify fault mid-serve is retried without changing a stream."""
    _, tapp = greedy
    prompts = [P_A, P_B, P_LONG]
    eng = ServingEngine(PagedEngineAdapter(tapp))
    ref = [eng.submit(p, 6) for p in prompts]
    eng.run_until_drained()
    refs = [s.drain() for s in ref]
    for path in PATHS:
        ad = _adapter("port", tapp, path, SelfDraftProposer(3))
        eng = ServingEngine(ad)
        streams = [eng.submit(p, 6) for p in prompts]
        passes = 0
        while eng.has_work:
            before = dict(ad.host_stats)
            eng.run_pass()
            passes += 1
            assert (ad.host_stats["spec_verify_dispatches"]
                    - before["spec_verify_dispatches"]) <= 1
            assert (ad.host_stats["blocking_fetches"]
                    - before["blocking_fetches"]) <= 1 or path != "ragged"
            assert passes < 50
        assert [s.drain() for s in streams] == refs
        assert all(s.finish_reason == "length" for s in streams)
    ad = PagedEngineAdapter(tapp, speculation=SelfDraftProposer(3))
    eng = ServingEngine(ad)
    streams = [eng.submit(p, 6) for p in prompts]
    eng.run_pass()
    with FAULTS.inject("spec_verify"):
        eng.run_pass()
    eng.run_until_drained()
    assert [s.drain() for s in streams] == refs
    assert eng.stats["step_retries"] >= 1


# ---------------------------------------------------------------------------
# shed, faults, preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_shed_speculation_is_stream_preserving_under_sampling(
        sampled, sampled_refs, path):
    """set_speculation_shed toggled every step: shed steps make no draft
    dispatch, and the stream stays the eager sampled stream."""
    _, tapp = sampled
    eng = _adapter("port", tapp, path, SelfDraftProposer(3))
    res = eng.add_requests([0, 1], [P_A, P_B])
    got = {s: ([res[s]] if s in res else []) for s in (0, 1)}
    n = 0
    while any(len(got[s]) < 12 for s in (0, 1)):
        eng.set_speculation_shed(n % 2 == 1)
        assert eng.speculation_shed == (n % 2 == 1)
        before = eng.host_stats["spec_draft_dispatches"]
        for s, toks in eng.step().items():
            got[s].extend(toks)
        if n % 2 == 1:
            assert eng.host_stats["spec_draft_dispatches"] == before
        n += 1
        assert n < 60
    eng.release([0, 1])
    assert {s: got[s][:12] for s in (0, 1)} == sampled_refs


@pytest.mark.parametrize("point", ["spec_draft", "spec_verify"])
def test_sampled_spec_fault_rolls_back_and_retry_heals(sampled,
                                                       sampled_refs, point):
    """A fault at either speculative point raises StepFailure(phase=point,
    retry_safe): position, block table and free pool are as before, and a
    plain retry continues the exact sampled stream — as on the JAX
    side."""
    japp, tapp = sampled
    outs = []
    for side, app, faults in (("jax", japp, JFAULTS),
                              ("port", tapp, FAULTS)):
        eng = _adapter(side, app, "two_phase", _proposer(side))
        got = [eng.add_requests([0], [P_A])[0]]
        got.extend(eng.step()[0])
        pos = eng.seqs[0].position
        blocks = list(app.kv_mgr.tables[0])
        free = int(app.kv_mgr.allocator.num_free)
        with pytest.raises(Exception) as ei:
            with faults.inject(point):
                eng.step()
        err = ei.value
        assert type(err).__name__ == "StepFailure"
        assert (err.phase, err.retry_safe, tuple(err.seq_ids)) == (
            point, True, (0,))
        assert eng.seqs[0].position == pos
        assert list(app.kv_mgr.tables[0]) == blocks
        assert int(app.kv_mgr.allocator.num_free) == free
        got.extend(eng.step()[0])
        eng.release([0])
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1] == sampled_refs[0][:len(outs[1])]


def test_sampled_ragged_fault_rolls_back_and_retry_heals(sampled,
                                                         sampled_refs):
    """The ragged_step fault under sampled speculation: typed, retry-safe,
    and the retry continues the exact stream."""
    _, tapp = sampled
    eng = PagedEngineAdapter(tapp, ragged=True,
                             speculation=SelfDraftProposer(3))
    eng.add_requests([0], [P_A])
    got = list(eng.step()[0])
    with pytest.raises(StepFailure) as ei:
        with FAULTS.inject("ragged_step"):
            eng.step()
    assert ei.value.phase == "ragged" and ei.value.retry_safe
    got.extend(eng.step()[0])
    eng.release([0])
    assert got == sampled_refs[0][:len(got)]
    assert len(got) >= 5


def test_preempt_mid_spec_replays_the_stream(greedy):
    """A preempted speculating row's record pins prompt + every accepted
    token; its replay continues the stream, as on the JAX side."""
    outs = []
    for side, app in zip(("jax", "port"), greedy):
        eng = _adapter(side, app, "two_phase", _proposer(side))
        got = [eng.add_requests([1], [P_B])[1]]
        got.extend(eng.step()[1])
        rec = eng.preempt(1, reason="test")
        assert list(rec.tokens) == P_B + got
        assert rec.n_generated == len(got)
        assert eng.take_preempted()[0] is rec
        cont = [eng.add_requests([1], [list(rec.tokens)])[1]]
        while len(got) + len(cont) < 10:
            cont.extend(eng.step()[1])
        eng.release([1])
        outs.append((got + cont)[:10])
    assert outs[1] == outs[0]


def test_on_verify_failure_degrades_not_corrupts(greedy):
    """A proposer failing in on_verify costs its state (forget), never the
    stream."""
    _, tapp = greedy

    class Flaky(SelfDraftProposer):
        calls = 0
        forgotten = ()

        def on_verify(self, ctx, tokens, n_emit, hidden):
            Flaky.calls += 1
            if Flaky.calls == 2:
                raise RuntimeError("stateful proposer bug")

        def forget(self, seq_ids):
            Flaky.forgotten += tuple(seq_ids)

    eager = PagedEngineAdapter(tapp)
    ref = [eager.add_requests([0], [P_A])[0]]
    for _ in range(12):
        ref.append(eager.step()[0])
    eager.release([0])
    eng = PagedEngineAdapter(tapp, speculation=Flaky(3))
    got = [eng.add_requests([0], [P_A])[0]]
    for _ in range(3):
        got.extend(eng.step()[0])
    eng.release([0])
    assert got == ref[:len(got)] and len(got) == 13
    assert 0 in Flaky.forgotten


# ---------------------------------------------------------------------------
# configuration, metrics, warm-up, dispatch regions
# ---------------------------------------------------------------------------

def test_sampling_modes_and_refusals(sampled):
    """Unseeded do_sample is refused with speculation (both paths),
    seeded is accepted as "sampled"; stream_seed needs do_sample; what
    waits for later slices stays refused."""
    import dataclasses
    _, tapp = sampled
    assert validate_spec_sampling(None, "x") == "greedy"
    assert validate_spec_sampling(
        OnDeviceSamplingConfig(do_sample=True, stream_seed=3),
        "x") == "sampled"
    with pytest.raises(ConfigurationError, match="unseeded do_sample"):
        validate_spec_sampling(OnDeviceSamplingConfig(do_sample=True), "x")
    orig = tapp.tpu_config
    try:
        tapp.tpu_config = dataclasses.replace(
            orig, on_device_sampling_config=OnDeviceSamplingConfig(
                do_sample=True))
        for kw in ({}, {"ragged": True}):
            with pytest.raises(ConfigurationError, match="SEEDED"):
                PagedEngineAdapter(tapp, speculation=SelfDraftProposer(3),
                                   **kw)
    finally:
        tapp.tpu_config = orig
    assert PagedEngineAdapter(
        tapp, speculation=SelfDraftProposer(3))._spec.mode == "sampled"
    assert PagedEngineAdapter(
        tapp, ragged=True, speculation=3)._ragged.mode == "sampled"
    with pytest.raises(ConfigurationError, match="stream_seed"):
        TpuConfig(batch_size=1, seq_len=64,
                  on_device_sampling_config=OnDeviceSamplingConfig(
                      do_sample=False, stream_seed=3))
    # speculation beside a depth-1 pipeline builds, as the reference
    # allows (its speculative step flushes the pipeline first); depth 2
    # is refused
    ad = PagedEngineAdapter(tapp, speculation=2, pipeline_depth=1)
    assert ad.pipeline_depth == 1 and ad._spec is not None
    for kw in ({"pipeline_depth": 2}, {"lora_pool": object()}):
        with pytest.raises(ConfigurationError):
            PagedEngineAdapter(tapp, speculation=2, **kw)
    # a host-RAM spill tier attaches beside speculation (ROADMAP A8,
    # ported), as the reference allows
    tier = HostKVSpillTier(max_blocks=4)
    ad = PagedEngineAdapter(tapp, speculation=2, kv_spill_tier=tier)
    assert ad._kv_tier is tier and ad._spec is not None
    assert tapp.kv_mgr.allocator.on_evict == ad._spill_block
    tapp.kv_mgr.set_spill_hook(None)
    # the speculation config builds now (ROADMAP A6, ported); as in the
    # reference it keeps a windowed model off the rolling cache
    sc = SpeculationConfig(speculation_length=3)
    spec = model_base.spec_from_config(LlamaInferenceConfig(TpuConfig(
        **dict(TCFG, speculation_config=sc)), **HF))
    assert spec.num_layers == HF["num_hidden_layers"]
    assert model_base.cache_layout(TpuConfig(
        batch_size=1, seq_len=64, speculation_config=sc), 8) == (False, False)
    assert model_base.cache_layout(TpuConfig(batch_size=1, seq_len=64),
                                   8) == (True, False)
    with pytest.raises(ConfigurationError, match="DraftProposer"):
        PagedEngineAdapter(tapp, speculation="greedy")
    with pytest.raises(ConfigurationError, match="corrupt_at"):
        PerturbedSelfDraftProposer(3, corrupt_at=3)
    with pytest.raises(ConfigurationError, match="k >= 1"):
        SelfDraftProposer(0)
    assert autobucketing.spec_width_buckets(4) == [1, 2, 4]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_metrics_carry_the_mode_label(sampled, greedy, mode):
    """The spec counters, accept-rate gauge and width histogram flow with
    the mode label, as the reference's do."""
    _, tapp = sampled if mode == "sampled" else greedy
    reg = telemetry.MetricsRegistry()
    telemetry.set_registry(reg)
    try:
        eng = PagedEngineAdapter(tapp, speculation=SelfDraftProposer(3))
        eng.add_requests([0], [P_A])
        eng.step()
        eng.step()
        eng.release([0])
    finally:
        telemetry.disable()
    assert reg.get(tmetrics.SPEC_DRAFTED_TOKENS_TOTAL).get(
        engine="paged", mode=mode) == 6
    assert reg.get(tmetrics.SPEC_ACCEPTED_TOKENS_TOTAL).get(
        engine="paged", mode=mode) == 6
    assert reg.get(tmetrics.SPEC_ACCEPT_RATE).get(engine="paged",
                                                  mode=mode) == 1.0
    width = reg.get(tmetrics.SPEC_VERIFY_WIDTH)
    assert width.count(engine="paged") == 2
    assert width.sum(engine="paged") == 8.0


def test_precompile_plans_the_draft_loop_and_verify_widths(sampled):
    """spec_widths adds, per table width and batch bucket, the draft loop
    of w - 1 steps (a graph signature) and the eager verify window; on the
    CPU nothing is captured. A second walk finds the draft loops warm."""
    _, tapp = sampled
    rep = precompile(tapp, widths=[1], spec_widths=[1, 2, 4],
                     declare_steady=False)
    kinds = [(g["kind"], g["bucket"]) for g in rep["graphs"]]
    per = len(tapp._bt_buckets) * len(tapp.batch_buckets)
    assert kinds.count(("spec_draft", 1)) == per
    assert kinds.count(("spec_draft", 3)) == per
    assert sum(1 for k in kinds if k[0] == "spec_verify") == 3 * per
    assert {g["outcome"] for g in rep["graphs"]} <= {"eager", "warm"}
    assert {g["outcome"] for g in rep["graphs"]
            if g["kind"] == "spec_verify"} == {"eager"}
    again = precompile(tapp, widths=[1], spec_widths=[1, 2, 4],
                       declare_steady=False)
    assert {g["outcome"] for g in again["graphs"]
            if g["kind"] == "spec_draft"} == {"warm"}


def guard_dispatch_reads(monkeypatch):
    """Make every read of a tensor's data (``cpu``, ``item``, ``numpy``,
    ``tolist``, ``__array__``) raise inside the dispatch regions
    (``_dispatch_decode``, ``_dispatch_ragged``, ``_dispatch_spec_draft``,
    ``_dispatch_spec_verify``); outside them reads work as before."""
    from neuronx_distributed_inference_tpu_torch.serving import adapter
    from neuronx_distributed_inference_tpu_torch.serving.ragged import path
    from neuronx_distributed_inference_tpu_torch.serving.speculation import \
        verifier
    inside = []

    def guard(owner, name):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            inside.append(name)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        monkeypatch.setattr(owner, name, wrapped)

    def refuse(orig):
        def read(self, *a, **kw):
            if inside:
                raise AssertionError(f"device read inside {inside[-1]}")
            return orig(self, *a, **kw)
        return read

    for name in ("cpu", "item", "numpy", "tolist", "__array__"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(getattr(torch.Tensor, name)))
    guard(adapter.PagedEngineAdapter, "_dispatch_decode")
    guard(path.RaggedDispatchPath, "_dispatch_ragged")
    guard(verifier.SpeculativeDecodePath, "_dispatch_spec_draft")
    guard(verifier.SpeculativeDecodePath, "_dispatch_spec_verify")


def test_dispatch_helpers_read_no_device_value(sampled, monkeypatch):
    """The dispatch regions never read a device value: every read of a
    tensor's data raises inside them (:func:`guard_dispatch_reads`), and
    the streams still equal the eager sampled ones."""
    _, tapp = sampled
    guard_dispatch_reads(monkeypatch)
    want = None
    for path_kind, prop in (("two_phase", None), ("two_phase", 3),
                            ("ragged", 3)):
        eng = _adapter("port", tapp, path_kind, prop)
        got, _ = _collect(eng, [0], [P_A], 6)
        eng.release([0])
        want = want or got
        assert got == want


# ---------------------------------------------------------------------------
# model level: the draft loop and verify against JAX, and on the card
# ---------------------------------------------------------------------------

def _verify_inputs(tapp, japp):
    """Two rows' candidate windows at W = 4 over fresh blocks."""
    bs = tapp.tpu_config.pa_block_size
    b, w = 2, 4
    ids = np.asarray([[7, 11, 13, 17], [19, 23, 29, 31]], np.int32)
    pos = np.asarray([[5], [12]], np.int32) + np.arange(w, dtype=np.int32)
    wid = np.asarray([4, 2], np.int32)
    bt = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    slot_pos = np.where(np.arange(w)[None, :] < wid[:, None], pos, -1)
    slots = np.where(slot_pos >= 0, bt[np.arange(b)[:, None],
                                       np.maximum(slot_pos, 0) // bs] * bs
                     + slot_pos % bs, -1).astype(np.int32)
    return ids, pos, slots, bt, wid


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_draft_loop_and_verify_match_jax(sampled, greedy, mode):
    """``_run_spec_draft`` (frozen rows write nothing) and
    ``_run_spec_verify`` give the JAX app's drafts, tokens and accept
    counts, and leave the same caches (1e-5)."""
    japp, tapp = sampled if mode == "sampled" else greedy
    japp.init_cache()
    tapp.init_cache()
    ids, pos, slots, bt, wid = _verify_inputs(tapp, japp)
    seeds = np.asarray([3, -4], np.int32)
    kw = {"row_seeds": seeds}
    jd = japp._run_spec_draft(ids[:, 0], pos[:, 0], bt, wid, 3, **kw)
    td = tapp._run_spec_draft(ids[:, 0], pos[:, 0], bt, wid, 3, **kw)
    assert np.array_equal(td["tokens"].numpy(), np.asarray(jd["tokens"]))
    cand = np.concatenate([ids[:, :1], np.asarray(jd["tokens"])], axis=1)
    jv = japp._run_spec_verify(cand, pos, slots, bt, wid, **kw)
    tv = tapp._run_spec_verify(torch.as_tensor(cand), pos, slots, bt, wid,
                               **kw)
    assert np.array_equal(tv["tokens"].numpy(), np.asarray(jv["tokens"]))
    assert np.array_equal(tv["num_emitted"].numpy(),
                          np.asarray(jv["num_emitted"]))
    assert tv["num_emitted"].tolist() == [4, 2]
    for n in ("k", "v"):
        np.testing.assert_allclose(tapp.cache[n].numpy(),
                                   np.asarray(japp.cache[n]), atol=1e-5,
                                   rtol=1e-5)
    tapp.init_cache()
    japp.init_cache()


def _cuda_apps(sampled_cfg):
    """Two port paged apps on the card with the same weights, head_dim 64
    (the kernel branch): one replays graphs, one runs eagerly."""
    from test_torch_ragged import HF_HD64
    kw = dict(TCFG)
    if sampled_cfg:
        kw["on_device_sampling_config"] = OnDeviceSamplingConfig(**SC)
    apps = [PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**kw), **HF_HD64), LlamaFamily,
        device="cuda", cuda_graphs=g) for g in (True, False)]
    apps[0].init_random_weights(3)
    apps[1].params = apps[0].params
    for a in apps:
        a.init_cache()
    return apps


@pytest.mark.cuda
def test_cuda_captured_coupled_step_equals_eager():
    """On the card: a coupled T = 1 paged step and ragged W = 1 step
    replayed from their graphs give the eager steps' tokens exactly, on
    the same cache and seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    g_app, e_app = _cuda_apps(True)
    g_app.generate(np.asarray([P_A[:8], P_B[:8]]), max_new_tokens=2)
    e_app.cache = g_app.cache
    b = 2
    bt = g_app.kv_mgr.block_table_array(range(b), g_app._bt_width(b))
    seeds = np.asarray([5, -9], np.int32)
    for pos in (9, 10, 11):
        args = (np.asarray([[5], [7]], np.int32),
                np.full((b, 1), pos, np.int32),
                np.full((b, 1), -1, np.int32), bt, np.zeros((b,), np.int32))
        outs = [g_app._run_paged(*args, row_seeds=seeds) for _ in range(2)]
        want = e_app._run_paged(*args, row_seeds=seeds)
        for o in outs:
            assert torch.equal(o["tokens"], want["tokens"])
        rg = g_app._run_ragged(*args[:4], np.ones((b,), np.int32),
                               np.ones((b,), np.int32), row_seeds=seeds)
        re_ = e_app._run_ragged(*args[:4], np.ones((b,), np.int32),
                                np.ones((b,), np.int32), row_seeds=seeds)
        assert torch.equal(rg["tokens"], re_["tokens"])
    sigs = [s for s in g_app.graphs.signatures() if s[0] in ("paged",
                                                              "ragged")]
    assert any("coupled" in s[2] for s in sigs)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled_cfg", [False, True])
def test_cuda_draft_loop_graph_equals_eager(sampled_cfg):
    """On the card: the draft loop replayed from its graph gives the eager
    loop's drafts exactly (frozen rows included), and the graph holds one
    paged-kernel launch per layer and step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    g_app, e_app = _cuda_apps(sampled_cfg)
    g_app.generate(np.asarray([P_A[:8], P_B[:8]]), max_new_tokens=2)
    e_app.cache = g_app.cache
    b = 2
    for i in range(b):
        g_app.kv_mgr.grow(i, 4)
    bt = g_app.kv_mgr.block_table_array(range(b), g_app._bt_width(b))
    first = np.asarray([5, 7], np.int32)
    pos = np.asarray([10, 10], np.int32)
    wid = np.asarray([4, 2], np.int32)
    seeds = np.asarray([1, 2], np.int32)
    outs = [g_app._run_spec_draft(first, pos, bt, wid, 3, row_seeds=seeds)
            for _ in range(2)]
    want = e_app._run_spec_draft(first, pos, bt, wid, 3, row_seeds=seeds)
    for o in outs:
        assert torch.equal(o["tokens"], want["tokens"])
    sig = [s for s in g_app.graphs.signatures() if s[0] == "spec_draft"][0]
    assert g_app.graphs.kernel_launches(sig) == {
        "paged_decode_attention": 3 * g_app.spec.num_layers}
