"""The ragged unified engine step of the port against the JAX package's.

Geometry: the tiny Llama of tests/test_ragged_dispatch.py:60-81 (hidden
64, 2 layers, 4 q / 2 kv heads, head_dim 16, vocab 512, block 8, 24
blocks, ctx bucket 16, prefix caching on), fp32, with weights drawn from a
seed with numpy and put into both applications (``_numpy_weights``). The
JAX side runs with ``jax_default_matmul_precision="highest"`` (conftest);
the port's matmuls keep TF32 off. Tokens, ``num_emitted`` and served
streams are identical; caches agree within 1e-5.

The W = 1 case of ``paged_ragged_step`` runs at head_dim 64, where both
sides take their decode-kernel branch: the JAX Pallas kernel in interpret
mode and the port's kernel wrapper on its plain twin (CPU tensors)."""

import dataclasses

import jax.numpy as jnp
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
from neuronx_distributed_inference_tpu.resilience import \
    FAULTS as JFAULTS
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.config import (
    OnDeviceSamplingConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, ConfigurationError, DeadlineExceeded, StepFailure)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
HF = dict(model_type="llama", hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
          hidden_act="silu", tie_word_embeddings=False,
          torch_dtype="float32")
HF_HD64 = dict(HF, hidden_size=256, head_dim=64, intermediate_size=512)
TCFG = dict(batch_size=2, seq_len=64, dtype="float32", enable_bucketing=True,
            context_encoding_buckets=[16], is_block_kv_layout=True,
            pa_block_size=8, pa_num_blocks=24, is_prefix_caching=True)

RNG = np.random.default_rng(31)
P_A = RNG.integers(1, 500, size=9).tolist()
P_B = RNG.integers(1, 500, size=12).tolist()
P_LONG = RNG.integers(1, 500, size=24).tolist()   # 2 chunks of 16


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _numpy_weights(japp, seed):
    """A numpy parameter tree shaped like the JAX app's, drawn from
    ``seed``: normal(0, 0.08) matrices, norms 1 + normal(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(node[k], k) for k in sorted(node)}
        shape = np.shape(node)
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.08 * rng.standard_normal(shape)).astype(np.float32)
    return fill(japp.params, "")


def make_pair(hf=HF, seed=7, **tcfg_over):
    """(JAX app, port app) on one config, both holding the same numpy
    weights drawn from ``seed``."""
    kw = dict(TCFG, **tcfg_over)
    japp = JPagedApp(None, JLlamaConfig(JTpuConfig(**kw), **hf),
                     JLlamaFamily)
    japp.init_random_weights(0)
    host = _numpy_weights(japp, seed)
    japp._put_params(host)
    japp.init_cache()
    tapp = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**kw), **hf), LlamaFamily,
        device="cpu")
    tapp.params = params_from_numpy(host, device="cpu")
    tapp.init_cache()
    return japp, tapp


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _collect(eng, sids, want, max_steps=60):
    """Drive a ragged adapter until every stream in ``sids`` holds
    ``want`` tokens; returns (streams, steps taken)."""
    got = {s: [] for s in sids}
    steps = 0
    while any(len(got[s]) < want for s in sids):
        for s, toks in eng.step().items():
            if s in got:
                got[s].extend(toks)
        steps += 1
        assert steps < max_steps, "ragged decode made no progress"
    return got, steps


def _int_stats(eng):
    """The adapter's integer host counters (the float ``*_blocked_s``
    timings differ from run to run)."""
    return {k: v for k, v in eng.host_stats.items() if isinstance(v, int)}


# ---------------------------------------------------------------------------
# (i) paged_ragged_step, port vs JAX
# ---------------------------------------------------------------------------

def _fill_caches(japp, tapp, seed):
    """The same random pages in both caches; returns the numpy copy."""
    rng = np.random.default_rng(seed)
    host = {n: (0.5 * rng.standard_normal(tapp.cache[n].shape)).astype(
        np.float32) for n in ("k", "v")}
    japp.cache = {n: jnp.asarray(host[n]) for n in host}
    for n in host:
        tapp.cache[n].copy_(torch.from_numpy(host[n]))
    return host


def _ragged_inputs(rows, width, bs, table_w):
    """rows: (offset, width, blocks, emit, tokens) -> the packed arrays of
    one ragged call (slot -1 past each row's width)."""
    b = len(rows)
    ids = np.zeros((b, width), np.int32)
    pos = np.zeros((b, width), np.int32)
    slots = np.full((b, width), -1, np.int32)
    bt = np.zeros((b, table_w), np.int32)
    wid = np.zeros((b,), np.int32)
    emit = np.zeros((b,), np.int32)
    for i, (off, w, blocks, mode, toks) in enumerate(rows):
        bt[i, :len(blocks)] = blocks
        pos[i] = off + np.arange(width)
        ids[i, :w] = toks
        p = pos[i, :w]
        slots[i, :w] = bt[i, p // bs] * bs + p % bs
        wid[i] = w
        emit[i] = mode
    return ids, pos, slots, bt, wid, emit


def _run_both(japp, tapp, host, args):
    """One ``_run_ragged`` on each side from the same cache contents."""
    japp.cache = {n: jnp.asarray(host[n]) for n in host}
    for n in host:
        tapp.cache[n].copy_(torch.from_numpy(host[n]))
    jo = japp._run_ragged(*args)
    to = tapp._run_ragged(*args)
    return ({k: np.asarray(jo[k]) for k in ("tokens", "num_emitted")},
            {k: to[k].numpy() for k in ("tokens", "num_emitted")})


def test_paged_ragged_step_matches_jax_all_emit_modes(pair):
    """One W = 8 call mixing a decode row (width 1, mode 1), an
    intermediate prefill chunk (width 5, mode 0), a verify row (width 3,
    mode 2) whose first draft matches and second does not, and a final
    chunk (width 4, mode 1): tokens and num_emitted are identical and the
    written caches agree within 1e-5."""
    japp, tapp = pair
    host = _fill_caches(japp, tapp, seed=3)
    bs = 8
    rng = np.random.default_rng(4)

    def rows(drafts):
        return [(13, 1, [1, 2], 1, [int(rng.integers(1, 500))]),
                (8, 5, [3, 4], 0, rng.integers(1, 500, 5).tolist()),
                (20, 3, [5, 6, 7], 2, [77] + drafts),
                (4, 4, [8], 1, rng.integers(1, 500, 4).tolist())]

    state = rng.bit_generator.state
    # probe: the argmax at the verify row's column 0, then at column 1
    probe = _ragged_inputs(rows([0, 0]), 8, bs, 4)
    want, _ = _run_both(japp, tapp, host, probe)
    t0 = int(want["tokens"][2, 0])
    rng.bit_generator.state = state
    probe = _ragged_inputs(rows([t0, 0]), 8, bs, 4)
    want, _ = _run_both(japp, tapp, host, probe)
    t1 = int(want["tokens"][2, 1])
    rng.bit_generator.state = state
    args = _ragged_inputs(rows([t0, (t1 + 1) % 512]), 8, bs, 4)
    want, got = _run_both(japp, tapp, host, args)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["num_emitted"], want["num_emitted"])
    assert got["num_emitted"].tolist() == [1, 0, 2, 1]
    assert got["tokens"][2, :2].tolist() == [t0, t1]
    for n in ("k", "v"):
        np.testing.assert_allclose(tapp.cache[n].numpy(),
                                   np.asarray(japp.cache[n]), **CACHE_TOL)
    # row 0 wrote position 13 (block 2, offset 5); its pad columns 14-15
    # (slot -1) left offsets 6-7 of that block as they were
    assert not np.array_equal(tapp.cache["k"][:, 2, 5].numpy(),
                              host["k"][:, 2, 5])
    np.testing.assert_array_equal(tapp.cache["k"][:, 2, 6:].numpy(),
                                  host["k"][:, 2, 6:])


def test_paged_ragged_step_full_logits_only_with_verify_rows(pair,
                                                            monkeypatch):
    """The lm_head runs on one column per row unless a row verifies: the
    emit-1 path never allocates the (B, W, vocab) logits."""
    japp, tapp = pair
    host = _fill_caches(japp, tapp, seed=5)
    shapes = []
    lm_head = model_base._lm_head

    def spy(spec, params, hidden):
        shapes.append(tuple(hidden.shape[:2]))
        return lm_head(spec, params, hidden)
    monkeypatch.setattr(model_base, "_lm_head", spy)
    rows = [(13, 1, [1, 2], 1, [5]), (8, 5, [3, 4], 1, [1, 2, 3, 4, 5])]
    args = _ragged_inputs(rows, 8, 8, 4)
    _run_both(japp, tapp, host, args)
    assert shapes == [(2, 1)]
    rows[1] = (8, 5, [3, 4], 2, [1, 2, 3, 4, 5])
    _run_both(japp, tapp, host, _ragged_inputs(rows, 8, 8, 4))
    assert shapes[1:] == [(2, 1), (2, 8)]


def test_paged_ragged_step_w1_takes_the_kernel_branch(monkeypatch):
    """An all-decode call (W = 1) at head_dim 64: the JAX Pallas kernel in
    interpret mode and the port's kernel wrapper (plain twin on the CPU)
    give identical tokens, caches within 1e-5, and every layer went
    through the wrapper once."""
    japp, tapp = make_pair(HF_HD64, seed=9)
    assert model_base.use_decode_kernel(tapp.spec, 1, torch.float32)
    host = _fill_caches(japp, tapp, seed=6)
    calls = []
    wrapper = decode_attention.paged_decode_attention

    def counted(*a, **k):
        calls.append(1)
        return wrapper(*a, **k)
    monkeypatch.setattr(decode_attention, "paged_decode_attention", counted)
    rows = [(13, 1, [1, 2], 1, [7]), (30, 1, [3, 4, 5, 6], 1, [9]),
            (0, 1, [8], 1, [11])]
    args = _ragged_inputs(rows, 1, 8, 4)
    want, got = _run_both(japp, tapp, host, args)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["num_emitted"], [1, 1, 1])
    assert len(calls) == tapp.spec.num_layers
    for n in ("k", "v"):
        np.testing.assert_allclose(tapp.cache[n].numpy(),
                                   np.asarray(japp.cache[n]), **CACHE_TOL)


# ---------------------------------------------------------------------------
# (ii) adapter streams, cold then warm prefix cache
# ---------------------------------------------------------------------------

def test_ragged_adapter_streams_match_jax_cold_then_warm(pair):
    """Deferred admission + unified dispatches: streams identical to the
    JAX ragged adapter's, cold and over the warm prefix cache; one
    dispatch and one blocking fetch per step, no standalone prefill
    dispatch, and the rows by kind equal JAX's counters."""
    japp, tapp = pair
    japp.init_cache()
    tapp.init_cache()
    for _ in range(2):                       # cold, then warm prefixes
        outs = []
        for cls, app in ((JPagedEngineAdapter, japp),
                         (PagedEngineAdapter, tapp)):
            eng = cls(app, ragged=True)
            assert eng.add_requests([0, 1], [P_A, P_B]) == {}
            got, steps = _collect(eng, [0, 1], 8)
            eng.release([0, 1])
            outs.append((got, steps, _int_stats(eng)))
        (jgot, jsteps, jst), (tgot, tsteps, tst) = outs
        assert tgot == jgot and tsteps == jsteps
        assert tst["ragged_dispatches"] == tst["blocking_fetches"] == tsteps
        assert tst["prefill_dispatches"] == 0
        assert tst["prefill_blocking_fetches"] == 0
        assert tst == {k: jst[k] for k in tst}
        assert tapp.kv_mgr.tables == {}


# ---------------------------------------------------------------------------
# (iii) mixed load: one dispatch and one fetch per step
# ---------------------------------------------------------------------------

def test_mixed_load_one_dispatch_per_step(pair):
    """A decode row plus a cold 2-chunk prompt: every step is exactly one
    ragged dispatch and one blocking fetch with no prefill dispatch, both
    chunk steps also carry the decode row, and the late stream equals
    JAX's."""
    japp, tapp = pair
    p_mix = np.random.default_rng(41).integers(1, 500, size=24).tolist()
    streams = []
    for cls, app in ((JPagedEngineAdapter, japp),
                     (PagedEngineAdapter, tapp)):
        eng = cls(app, ragged=True)
        eng.add_requests([0], [P_A])
        _collect(eng, [0], 3)
        eng.add_requests([1], [p_mix])
        late, kinds = [], []
        while len(late) < 5:
            before = _int_stats(eng)
            res = eng.step()
            delta = {k: eng.host_stats[k] - before[k] for k in before}
            assert delta["ragged_dispatches"] == 1
            assert delta["blocking_fetches"] == 1
            assert delta["prefill_dispatches"] == 0
            kinds.append((delta["ragged_rows_decode"],
                          delta["ragged_rows_prefill"]))
            late.extend(res.get(1, []))
        eng.release([0, 1])
        streams.append((late, kinds))
    assert streams[1] == streams[0]
    assert streams[1][1][:2] == [(1, 1), (1, 1)]


# ---------------------------------------------------------------------------
# (iv) the ragged_step fault: rollback, retry, requeue
# ---------------------------------------------------------------------------

def _fault_run(eng, faults):
    eng.add_requests([0], [P_A])
    got0, _ = _collect(eng, [0], 3)
    mgr = eng.app.kv_mgr
    free_before = int(mgr.allocator.num_free)
    eng.add_requests([1], [P_LONG])
    pos_before = eng.seqs[0].position
    with faults.inject("ragged_step") as fp:
        with pytest.raises(Exception) as ei:
            eng.step()
    assert fp.trips == 1
    err = ei.value
    assert eng.seqs[0].position == pos_before
    assert 1 not in eng._chunks
    recs = eng.take_preempted()
    assert int(mgr.allocator.num_free) == free_before
    more, _ = _collect(eng, [0], 3)
    eng.add_requests([recs[0].seq_id], [list(recs[0].tokens)])
    replay, _ = _collect(eng, [1], 3)
    eng.release([0, 1])
    return (err, [(r.seq_id, r.reason, list(r.tokens), r.n_generated)
                  for r in recs], got0[0] + more[0], replay[1])


def test_ragged_step_fault_rolls_back_and_retry_heals(pair):
    """An armed ragged_step fault raises StepFailure(phase="ragged",
    retry_safe): the live row keeps its position and the retry continues
    its exact stream, the packed prefill row comes back as
    Preempted(reason="ragged_rollback") whose replay matches, and the free
    pool is restored — all as the JAX adapter does."""
    japp, tapp = pair
    jres = _fault_run(JPagedEngineAdapter(japp, ragged=True), JFAULTS)
    tres = _fault_run(PagedEngineAdapter(tapp, ragged=True), FAULTS)
    err = tres[0]
    assert isinstance(err, StepFailure)
    assert err.phase == "ragged" and err.retry_safe
    assert tres[1] == jres[1]
    assert tres[1][0][:2] == (1, "ragged_rollback")
    assert tres[2] == jres[2] and tres[3] == jres[3]


# ---------------------------------------------------------------------------
# (v) pending-admission deadlines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("targeted", [False, True])
def test_pending_deadline_targeted_raises_untargeted_skipped(pair,
                                                             targeted):
    """tests/test_ragged_dispatch.py:301: an expired pending admission is
    skipped by a step scoped to the healthy row (no prefill row packed)
    and raises DeadlineExceeded when the step targets it."""
    _, tapp = pair
    eng = PagedEngineAdapter(tapp, ragged=True)
    eng.add_requests([0], [P_A])
    _collect(eng, [0], 2)
    eng.add_requests([1], [P_LONG], deadline_s=[0.0])   # expired at birth
    before = dict(eng.host_stats)
    if targeted:
        with pytest.raises(DeadlineExceeded) as ei:
            eng.step()
        assert list(ei.value.seq_ids) == [1]
        assert eng.host_stats["ragged_dispatches"] \
            == before["ragged_dispatches"]
    else:
        res = eng.step([0])
        assert 0 in res
        assert eng.host_stats["ragged_rows_prefill"] \
            == before["ragged_rows_prefill"]
    eng.release([0, 1])


# ---------------------------------------------------------------------------
# (vi) configuration guards
# ---------------------------------------------------------------------------

def test_ragged_refuses_unseeded_sampling(pair):
    """do_sample without stream_seed is refused at construction, as the
    JAX adapter refuses it; token_room stays a ragged-only hook."""
    japp, tapp = pair
    for app, cfg_cls in ((tapp, OnDeviceSamplingConfig),
                         (japp, JOnDeviceSamplingConfig)):
        orig = app.tpu_config
        app.tpu_config = dataclasses.replace(
            orig, on_device_sampling_config=cfg_cls(do_sample=True))
        try:
            cls = (PagedEngineAdapter if app is tapp
                   else JPagedEngineAdapter)
            with pytest.raises(Exception) as ei:
                cls(app, ragged=True)
            assert type(ei.value).__name__ == "ConfigurationError"
        finally:
            app.tpu_config = orig
    with pytest.raises(ConfigurationError):
        PagedEngineAdapter(tapp).step(token_room={0: 1})


def test_ragged_shed_routes_two_phase_with_same_stream(pair):
    """set_ragged_shed(True) — the explicit degradation API — runs the
    two-phase chunk-then-decode template: same greedy stream, standalone
    prefill dispatches instead of ragged ones."""
    _, tapp = pair
    ref = PagedEngineAdapter(tapp, ragged=True)
    ref.add_requests([0], [P_B])
    want, _ = _collect(ref, [0], 5)
    ref.release([0])
    eng = PagedEngineAdapter(tapp, ragged=True)
    eng.set_ragged_shed(True)
    assert eng.ragged_shed
    eng.add_requests([0], [P_B])
    got = []
    while len(got) < 5:
        got.extend(eng.step().values())
    eng.release([0])
    assert got == want[0]
    assert eng.host_stats["ragged_dispatches"] == 0
    assert eng.host_stats["prefill_dispatches"] >= 1


def test_ragged_step_many_is_a_token_budget(pair):
    """step_many(n) on a ragged adapter runs unified steps until each row
    has delivered n tokens, one dispatch each, as the JAX adapter does."""
    japp, tapp = pair
    outs = []
    for cls, app in ((JPagedEngineAdapter, japp),
                     (PagedEngineAdapter, tapp)):
        eng = cls(app, ragged=True)
        eng.add_requests([0, 1], [P_A, P_LONG])
        first = eng.step_many(2)
        more = eng.step_many(4)
        eng.release([0, 1])
        outs.append((first, more, eng.host_stats["ragged_dispatches"]))
    assert outs[1] == outs[0]
    assert [len(t) for t in outs[1][1].values()] == [4, 4]


@pytest.mark.cuda
def test_cuda_ragged_step_launches_the_kernel_only_at_w1():
    """On the card: an all-decode ragged call (W = 1) launches the paged
    kernel once per layer and matches the CPU run; a mixed call (W = 8)
    launches none (the gather path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    _, cpu = make_pair(HF_HD64, seed=9)
    card = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**TCFG), **HF_HD64),
        LlamaFamily, device="cuda")
    card.params = {k: ({n: t.cuda() for n, t in v.items()}
                       if isinstance(v, dict) else v.cuda())
                   for k, v in cpu.params.items()}
    card.init_cache()
    rng = np.random.default_rng(6)
    host = {n: (0.5 * rng.standard_normal(cpu.cache[n].shape)).astype(
        np.float32) for n in ("k", "v")}
    for app in (cpu, card):
        for n in host:
            app.cache[n].copy_(torch.from_numpy(host[n]))
    kernel = decode_attention.paged_decode_attention
    for width, rows, want in (
            (1, [(13, 1, [1, 2], 1, [7]), (30, 1, [3, 4, 5, 6], 1, [9])],
             cpu.spec.num_layers),
            (8, [(13, 1, [1, 2], 1, [7]), (8, 5, [3, 4], 1, [1, 2, 3, 4, 5])],
             0)):
        args = _ragged_inputs(rows, width, 8, 4)
        before = kernel.launches
        got = card._run_ragged(*args)
        torch.cuda.synchronize()
        assert kernel.launches - before == want
        ref = cpu._run_ragged(*args)
        np.testing.assert_array_equal(got["tokens"].cpu().numpy(),
                                      ref["tokens"].numpy())
        for n in ("k", "v"):
            np.testing.assert_allclose(card.cache[n].cpu().numpy(),
                                       cpu.cache[n].numpy(), atol=1e-4,
                                       rtol=1e-4)
