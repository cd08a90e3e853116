"""Multi-LoRA serving of the port (``serving/lora_pool.py`` and the
per-row adapter slots of the paged adapter, its ragged dispatch and its
speculative path) against the JAX package's, case for case with
tests/test_lora_serving.py.

Geometry: the reference test's tiny Llama (hidden 64, 2 layers, 4 q / 2
kv heads of 16, vocab 512, block 8, ctx bucket 16, batch 4), fp32,
``max_loras`` 3 (two usable slots), rank 4, q_proj / v_proj. The JAX app
draws its weights (``init_random_weights(7)``) and the port holds the
same tree through ``params_from_numpy``; both pools register the same
numpy adapters. Greedy and seeded coupled-sampled streams are identical
to the JAX engine's and to the port's per-adapter single runs; the pools'
``stats`` equal the reference pool's after the same operations."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    LoraServingConfig as JLora, OnDeviceSamplingConfig as JSampling,
    TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.resilience import FAULTS as JFAULTS
from neuronx_distributed_inference_tpu.serving import (
    LoraAdapterPool as JPool, PagedEngineAdapter as JAdapter)
from neuronx_distributed_inference_tpu_torch import telemetry
from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, OnDeviceSamplingConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, CapacityError, ConfigurationError, StepFailure)
from neuronx_distributed_inference_tpu_torch.resilience.controller import (
    DEGRADE_ACTIONS, DegradationController)
from neuronx_distributed_inference_tpu_torch.serving import (
    LoraAdapterPool, PagedEngineAdapter)
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    precompile
from neuronx_distributed_inference_tpu_torch.telemetry import \
    metrics as tmetrics
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

HF = dict(model_type="llama", hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
          hidden_act="silu", tie_word_embeddings=False,
          torch_dtype="float32")
TCFG = dict(batch_size=4, seq_len=64, dtype="float32", enable_bucketing=True,
            context_encoding_buckets=[16], is_block_kv_layout=True,
            pa_block_size=8, pa_num_blocks=40, is_prefix_caching=True)
LORA = dict(max_loras=3, max_lora_rank=4, target_modules=["q_proj",
                                                          "v_proj"])
SAMPLING = dict(do_sample=True, top_k=8, top_p=0.95, temperature=1.3,
                stream_seed=11)

RNG = np.random.default_rng(41)
P_A = RNG.integers(1, 500, size=9).tolist()
P_B = RNG.integers(1, 500, size=12).tolist()
P_C = RNG.integers(1, 500, size=7).tolist()
WANT = 6


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def make_pair(lora=True, sampling=None):
    """(JAX app, port app) on the reference test's config, the port
    holding the JAX weights."""
    jkw, kw = dict(TCFG), dict(TCFG)
    if lora:
        jkw["lora_config"] = JLora(**LORA)
        kw["lora_config"] = LoraServingConfig(**LORA)
    if sampling is not None:
        jkw["on_device_sampling_config"] = JSampling(**sampling)
        kw["on_device_sampling_config"] = OnDeviceSamplingConfig(**sampling)
    japp = JPagedApp(None, JLlamaConfig(JTpuConfig(**jkw), **HF),
                     JLlamaFamily)
    japp.init_random_weights(7).init_cache()
    tapp = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**kw), **HF), LlamaFamily,
        device="cpu")
    import jax
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    return japp, tapp.init_cache()


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def base_pair():
    """The same weights without lora_config: the off-knob reference."""
    return make_pair(lora=False)


def adapter_arrays(app, seed):
    """A synthetic adapter in the ``register_arrays`` layout (the
    reference test's ``_adapter_arrays``)."""
    lw = app.params["layers"]
    rng = np.random.default_rng(seed)
    arrays = {}
    for mod in app.spec.lora.target_modules:
        sa = tuple(lw[f"lora_A_{mod}"].shape)        # (L, slots, in, r)
        sb = tuple(lw[f"lora_B_{mod}"].shape)        # (L, slots, r, out)
        arrays[mod] = (
            (rng.standard_normal((sa[0], sa[2], sa[3])) * 0.3).astype(
                np.float32),
            (rng.standard_normal((sb[0], sb[2], sb[3])) * 0.3).astype(
                np.float32))
    return arrays


def pool_of(cls, app, n=3, **kw):
    pool = cls(app, **kw)
    for i in range(n):
        pool.register_arrays(f"l{i}", adapter_arrays(app, 100 + i))
    return pool


def pools(pair, n=3, **kw):
    japp, tapp = pair
    return pool_of(JPool, japp, n, **kw), pool_of(LoraAdapterPool, tapp, n,
                                                  **kw)


def collect(eng, sids, want=WANT, cap=80, first=None):
    """Step ``eng`` until every stream holds ``want`` tokens; ``first``:
    the first tokens ``add_requests`` returned (a non-deferred
    admission)."""
    got = {s: [int(first[s])] if first and s in first else [] for s in sids}
    steps = 0
    while any(len(got[s]) < want for s in sids):
        for s, toks in eng.step().items():
            if s in got:
                got[s].extend(toks if isinstance(toks, list) else [toks])
        steps += 1
        assert steps < cap, "no progress"
    return {s: v[:want] for s, v in got.items()}, steps


def serve(cls, app, pool, sids, prompts_, meta, want=WANT, **kw):
    if cls is JAdapter:
        # the reference's prefix cache is not keyed by adapter (ROADMAP
        # C6): a fresh cache keeps it from reading other adapters' KV
        app.init_cache()
    ad = cls(app, lora_pool=pool, **kw)
    base = dict(ad.host_stats)
    first = ad.add_requests(sids, prompts_, meta=meta)
    toks, steps = collect(ad, sids, want, first=first)
    delta = {k: ad.host_stats[k] - base.get(k, 0) for k in ad.host_stats
             if isinstance(ad.host_stats[k], int)}
    ad.release(sids)
    return toks, steps, delta, ad


# ---------------------------------------------------------------------------
# mixed adapters in one dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "twophase"])
def test_mixed_adapters_match_jax_and_single_runs(pair, ragged):
    """Three streams under l0, l1 and the base model in one engine: equal
    to the JAX engine's, and (ragged) one materialized dispatch a step,
    each stream equal to its per-adapter single run."""
    japp, tapp = pair
    jpool, tpool = pools(pair)
    meta = [{"adapter": "l0"}, {"adapter": "l1"}, None]
    sids = [0, 1, 2]
    prompts_ = [P_A, P_B, P_C]
    want, _, _, _ = serve(JAdapter, japp, jpool, sids, prompts_,
                          [dict(m) if m else None for m in meta],
                          ragged=ragged)
    got, steps, delta, _ = serve(PagedEngineAdapter, tapp, tpool, sids,
                                 prompts_,
                                 [dict(m) if m else None for m in meta],
                                 ragged=ragged)
    assert got == want
    assert got[0] != got[1]
    assert delta["lora_rows"] == 2
    assert _stats(tpool) == _stats(jpool)
    if ragged:
        assert delta["dispatches"] + delta["prefill_dispatches"] == steps
        assert delta["blocking_fetches"] == delta["ragged_dispatches"]
    # per-adapter single runs on the same app (prefix caching must not
    # perturb the tokens either)
    for name, prompt, toks in (("l0", P_A, got[0]), ("l1", P_B, got[1]),
                               (None, P_C, got[2])):
        single, _, _, _ = serve(PagedEngineAdapter, tapp,
                                pool_of(LoraAdapterPool, tapp), [5],
                                [prompt],
                                [{"adapter": name}] if name else None,
                                ragged=ragged)
        assert single[5] == toks, name


def test_step_many_and_engine_under_adapters(pair):
    """The fused paged loop (``step_many`` on the two-phase adapter) and
    ``ServingEngine.submit(adapter=)`` on the ragged adapter, each equal to
    the JAX package's."""
    japp, tapp = pair
    outs = []
    for cls, app, pool_cls in ((JAdapter, japp, JPool),
                               (PagedEngineAdapter, tapp, LoraAdapterPool)):
        if cls is JAdapter:
            app.init_cache()           # see serve()
        ad = cls(app, lora_pool=pool_of(pool_cls, app))
        first = ad.add_requests([0, 1], [P_A, P_B],
                                meta=[{"adapter": "l2"}, {"adapter": "l0"}])
        many = ad.step_many(4)
        ad.release([0, 1])
        outs.append(({s: [int(first[s])] + list(many[s]) for s in (0, 1)}))
    assert outs[0] == outs[1]
    streams = []
    for cls, app, pool_cls in ((JAdapter, japp, JPool),
                               (PagedEngineAdapter, tapp, LoraAdapterPool)):
        if cls is JAdapter:
            from neuronx_distributed_inference_tpu.serving.engine import \
                ServingEngine as JEngine
            app.init_cache()
            eng = JEngine(cls(app, ragged=True,
                              lora_pool=pool_of(pool_cls, app)))
        else:
            eng = ServingEngine(cls(app, ragged=True,
                                    lora_pool=pool_of(pool_cls, app)))
        st = [eng.submit(P_A, 5, adapter="l1"), eng.submit(P_C, 5),
              eng.submit(P_B, 5, adapter="l0")]
        eng.run_until_drained()
        streams.append([s.tokens for s in st])
    assert streams[0] == streams[1]


def test_base_rows_match_no_lora_build(pair, base_pair):
    """Adapter-less rows on a LoRA build equal a LoRA-free build's stream
    (slot 0 adds exactly nothing); the off-knob guards hold."""
    _, tapp = pair
    _, base = base_pair
    lora_toks, _, _, _ = serve(PagedEngineAdapter, tapp,
                               pool_of(LoraAdapterPool, tapp), [0], [P_C],
                               None, ragged=True)
    ad = PagedEngineAdapter(base, ragged=True)
    ad.add_requests([0], [P_C])
    base_toks, _ = collect(ad, (0,))
    ad.release([0])
    assert lora_toks[0] == base_toks[0]
    assert tapp._lora_adapter_ids(None) is None
    with pytest.raises(ValueError, match="without"):
        base._lora_adapter_ids(np.zeros((4,), np.int32))
    with pytest.raises(ConfigurationError, match="lora_config"):
        LoraAdapterPool(base)


def test_sampled_mixed_adapters_match_jax_and_single_runs():
    """Coupled-sampled streams (seeded, keyed by absolute position) under
    mixed adapters equal the JAX engine's and their single-adapter
    runs."""
    spair = make_pair(sampling=SAMPLING)
    japp, tapp = spair
    meta = [{"adapter": "l0", "sampling_seed": 5},
            {"adapter": "l1", "sampling_seed": 9}]
    want, _, _, _ = serve(JAdapter, japp, pool_of(JPool, japp, 2), [0, 1],
                          [P_A, P_B], [dict(m) for m in meta], want=4,
                          ragged=True)
    got, _, _, _ = serve(PagedEngineAdapter, tapp,
                         pool_of(LoraAdapterPool, tapp, 2), [0, 1],
                         [P_A, P_B], [dict(m) for m in meta], want=4,
                         ragged=True)
    assert got == want
    for i, (m, prompt) in enumerate(zip(meta, (P_A, P_B))):
        single, _, _, _ = serve(PagedEngineAdapter, tapp,
                                pool_of(LoraAdapterPool, tapp, 2), [5],
                                [prompt], [dict(m)], want=4, ragged=True)
        assert single[5] == got[i], m


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "twophase"])
def test_spec_verify_rows_under_adapter(pair, ragged):
    """Self-draft speculation (2 drafts) under a non-base adapter: the
    draft loop and the verify windows carry the row's slot, and the
    stream equals the plain ragged stream under that adapter and the JAX
    engine's speculative stream."""
    japp, tapp = pair
    want, _, _, _ = serve(JAdapter, japp, pool_of(JPool, japp), [0], [P_A],
                          [{"adapter": "l2"}], ragged=ragged, speculation=2)
    got, _, delta, _ = serve(PagedEngineAdapter, tapp,
                             pool_of(LoraAdapterPool, tapp), [0], [P_A],
                             [{"adapter": "l2"}], ragged=ragged,
                             speculation=2)
    plain, _, _, _ = serve(PagedEngineAdapter, tapp,
                           pool_of(LoraAdapterPool, tapp), [3], [P_A],
                           [{"adapter": "l2"}], ragged=True)
    assert got[0] == want[0] == plain[3]
    assert delta["spec_draft_dispatches"] > 0


# ---------------------------------------------------------------------------
# pool semantics, step for step against the reference pool
# ---------------------------------------------------------------------------

def _stats(pool):
    return {k: v for k, v in pool.stats.items() if k != "swap_s"}


def test_pool_lru_pins_capacity_and_restore(pair):
    jpool, tpool = pools(pair)
    assert tpool.n_slots == jpool.n_slots == 2

    def both(op, *a):
        rj, rt = getattr(jpool, op)(*a), getattr(tpool, op)(*a)
        assert rj == rt and _stats(jpool) == _stats(tpool), op
        return rt
    s0, s1 = both("acquire", "l0"), both("acquire", "l1")
    assert {s0, s1} == {1, 2} and tpool.resident("l0")
    with pytest.raises(CapacityError, match="pinned"):
        tpool.acquire("l2")
    with pytest.raises(Exception):
        jpool.acquire("l2")
    both("release", "l0")
    # the unpinned LRU victim (l0) is evicted and spilled to the host
    assert both("acquire", "l2") == s0 and not tpool.resident("l0")
    assert tpool.stats["evictions"] == 1 and tpool.stats["spills"] == 1
    both("release", "l1")
    both("acquire", "l0")
    assert tpool.stats["restores"] == 1
    # the restored factors are the registered ones
    slot = tpool.slot_of("l0")
    want = adapter_arrays(pair[1], 100)["q_proj"][1]
    np.testing.assert_array_equal(
        pair[1].params["layers"]["lora_B_q_proj"][:, slot].numpy(), want)
    assert both("acquire", "l0") == tpool.slot_of("l0")
    assert tpool.pins("l0") == jpool.pins("l0") == 2
    both("release", "zzz")                       # non-resident: a no-op
    assert tpool.debug_state()["resident"] == jpool.debug_state()[
        "resident"]
    with pytest.raises(ConfigurationError, match="unknown adapter"):
        tpool.acquire("never-registered")
    with pytest.raises(ConfigurationError):
        LoraAdapterPool(pair[1], host_cache_adapters=0)


def test_swap_rollback_and_spill_best_effort(pair):
    """adapter_swap: a failed swap restores every slot's factors (equal
    to before), frees the claimed slot and raises a retry-safe
    StepFailure; a retry heals. adapter_spill: a failure is counted, the
    eviction proceeds and the re-acquire cold-loads. Stats as the
    reference pool's."""
    jpool, tpool = pools(pair)
    lw = pair[1].params["layers"]
    tpool.acquire("l1")
    jpool.acquire("l1")
    tpool.release("l1")
    jpool.release("l1")
    before = {k: v.clone() for k, v in lw.items() if k.startswith("lora_")}
    with FAULTS.inject("adapter_swap", nth=1, times=1):
        with pytest.raises(StepFailure) as ei:
            tpool.acquire("l0")
    with JFAULTS.inject("adapter_swap", nth=1, times=1):
        with pytest.raises(Exception):
            jpool.acquire("l0")
    assert ei.value.retry_safe and ei.value.phase == "adapter_swap"
    for k, v in before.items():
        assert torch.equal(lw[k], v), k
    # a write that fails half-way (the claimed slot held l1's factors) is
    # rolled back from the clones, not from views of the written storage
    for app, pool in zip(pair, (jpool, tpool)):
        write = app.write_lora_slot

        def half(slot, arrays, write=write):
            write(slot, dict(list(arrays.items())[:1]))
            raise RuntimeError("the device write failed half-way")
        app.write_lora_slot = half
        try:
            with pytest.raises(Exception):
                pool.acquire("l0")
        finally:
            del app.write_lora_slot
    for k, v in before.items():
        assert torch.equal(lw[k], v), k
    assert not tpool.resident("l0") and tpool.stats["swap_errors"] == 2
    assert sorted(tpool.debug_state()["free_slots"]) == sorted(
        jpool.debug_state()["free_slots"])
    assert _stats(tpool) == _stats(jpool)
    for p in (jpool, tpool):
        p.acquire("l0")                          # the retry heals
        p.release("l0")
        p.acquire("l2")                          # evicts l1 (LRU)
        p.release("l2")
    with FAULTS.inject("adapter_spill", nth=1, times=1):
        tpool.acquire("l1")                      # evicts l0, spill trips
    with JFAULTS.inject("adapter_spill", nth=1, times=1):
        jpool.acquire("l1")
    assert tpool.stats["spill_errors"] == 1
    assert "l0" not in tpool.debug_state()["host_cached"]
    cold = tpool.stats["cold_loads"]
    for p in (jpool, tpool):
        p.release("l1")
        p.acquire("l0")                          # not host-cached: cold
    assert tpool.stats["cold_loads"] == cold + 1
    assert _stats(tpool) == _stats(jpool)


def test_pool_metrics_and_trace(pair):
    reg = telemetry.MetricsRegistry()
    rec = telemetry.enable_recorder()
    try:
        pool = pool_of(LoraAdapterPool, pair[1], telemetry=reg)
        pool.acquire("l0")
        pool.acquire("l0")
        assert tmetrics.lora_swaps_counter(reg).get(adapter="l0") == 1.0
        assert tmetrics.lora_residency_hits_counter(reg).get() == 1.0
        assert tmetrics.lora_swap_bytes_counter(reg).get() == \
            pool.stats["swap_bytes"] > 0
        pool.release("l0")
        pool.release("l0")
        pool.acquire("l1")
        pool.release("l1")
        pool.acquire("l2")                       # evicts l0: a spill
        names = [e["name"] for e in rec.events()]
        assert "lora.swap" in names and "lora.spill" in names
        pool.release("l2")
    finally:
        telemetry.disable_recorder()


def test_pool_requires_lora_build():
    class _Spec:
        lora = None

    class _Fake:
        spec = _Spec()

    with pytest.raises(ConfigurationError, match="lora_config"):
        LoraAdapterPool(_Fake())


# ---------------------------------------------------------------------------
# the adapter's surfaces: pins, affinity, the shed actuator, warm-up
# ---------------------------------------------------------------------------

def test_release_preemption_and_rollback_unpin(pair):
    """Release, preemption and a failed admission each unpin the row's
    adapter; the debug state shows the rows' slots."""
    _, tapp = pair
    pool = pool_of(LoraAdapterPool, tapp)
    ad = PagedEngineAdapter(tapp, ragged=True, lora_pool=pool)
    ad.add_requests([0, 1], [P_A, P_B], meta=[{"adapter": "l0"},
                                             {"adapter": "l1"}])
    state = ad.debug_state()["lora"]
    assert state["rows"] == {0: pool.slot_of("l0"), 1: pool.slot_of("l1")}
    ad.preempt(0)
    assert pool.pins("l0") == 0 and pool.pins("l1") == 1
    ad.release([1])
    assert pool.pins("l1") == 0
    # every slot pinned: the admission's acquire fails and rolls back
    pool.acquire("l0")
    pool.acquire("l1")
    with pytest.raises(CapacityError):
        ad.add_requests([2], [P_C], meta=[{"adapter": "l2"}])
    assert 2 not in ad._chunks and pool.pins("l2") == 0
    pool.release("l0")
    pool.release("l1")
    ad.take_preempted()
    # a failed chunk dispatch of a deferred admission unpins its rows too
    ad2 = PagedEngineAdapter(tapp, lora_pool=pool, prefill_budget_tokens=8)
    ad2.add_requests([3], [P_B], meta=[{"adapter": "l2"}])
    assert pool.pins("l2") == 1
    with FAULTS.inject("prefill_chunk", nth=1, times=1):
        with pytest.raises(StepFailure):
            ad2.step()
    assert 3 not in ad2._chunks and pool.pins("l2") == 0


def test_prefix_warmth_adapter_affinity(pair):
    _, tapp = pair
    pool = pool_of(LoraAdapterPool, tapp)
    ad = PagedEngineAdapter(tapp, ragged=True, lora_pool=pool)
    cold = ad.prefix_warmth(P_A, adapter="l0")
    assert cold == ad.prefix_warmth(P_A)        # not resident: no bonus
    pool.acquire("l0")
    lru_before = list(pool._lru)
    assert ad.prefix_warmth(P_A, adapter="l0") == (cold
                                                   + ad.prefill_chunk_tokens)
    assert list(pool._lru) == lru_before        # a read-only probe
    pool.release("l0")


def _jax_alone(japp, prompt, name):
    """The JAX adapter's stream of ``prompt`` served alone under ``name``
    on a fresh cache (the reference's prefix cache is not keyed by
    adapter, so it must not see the prompt's earlier blocks)."""
    want, _, _, _ = serve(JAdapter, japp, pool_of(JPool, japp), [0],
                          [prompt], [{"adapter": name}] if name else None,
                          ragged=True)
    return want[0]


def test_idle_engine_drains_more_adapters_than_slots(pair):
    """Three adapters and a base row submitted together to an idle engine
    over two usable slots: the first pass admits the base row and two
    adapters, requeues the third until a slot is released, and the
    engine drains (the reference requeues the whole batch, which then
    never fits). Every stream equals the JAX adapter's run of its request
    alone."""
    japp, tapp = pair
    names = ["l0", "l1", "l2", None]
    prompts_ = [P_A, P_B, P_C, P_B]
    eng = ServingEngine(PagedEngineAdapter(
        tapp, ragged=True, lora_pool=pool_of(LoraAdapterPool, tapp)))
    st = [eng.submit(p, WANT, adapter=n) for p, n in zip(prompts_, names)]
    eng.run_pass()
    ad = eng.adapter
    assert len(ad.seqs) + len(ad.pending_prefill_ids) == 3
    assert eng.queue.depth == 1 and eng.stats["admission_retries"] == 1
    eng.run_until_drained(max_passes=200)
    assert all(s.finish_reason == "length" for s in st)
    for s, n, p in zip(st, names, prompts_):
        assert s.tokens == _jax_alone(japp, p, n), n


def test_prefix_cache_keyed_by_adapter(pair):
    """One prompt served under l0, l1, the base model, then l0 and the
    base model again, on one adapter with prefix caching: an admission
    reuses only blocks written under its own adapter (ROADMAP C6), and
    each stream equals the JAX adapter's run of the prompt alone. The
    app's ``generate(adapter_ids=)`` keys the cache the same way, and a
    slot rewrite retires its blocks. Control: with every salt b"" (the
    reference's keying) l1 reuses l0's blocks and its stream parts from
    its own."""
    japp, tapp = pair
    # two full blocks: a hit serves 15 tokens (one is always recomputed)
    prompt = np.random.default_rng(43).integers(1, 500, size=16).tolist()
    pool = pool_of(LoraAdapterPool, tapp)
    order = ["l0", "l1", None, "l0", None]

    def run(names, base_sid):
        ad = PagedEngineAdapter(tapp, ragged=True, lora_pool=pool)
        hits, out = [], []
        for sid, name in enumerate(names, start=base_sid):
            ad.add_requests([sid], [prompt],
                            meta=[{"adapter": name}] if name else None)
            hits.append(ad._chunks[sid].done)
            toks, _ = collect(ad, (sid,))
            ad.release([sid])
            out.append(toks[sid])
        return hits, out
    hits, streams = run(order, 0)
    assert hits == [0, 0, 0, 15, 15]
    for name, got in zip(order[:3], streams[:3]):
        assert got == _jax_alone(japp, prompt, name), name
    assert streams[3] == streams[0] and streams[4] == streams[2]
    assert len({tuple(x) for x in streams[:3]}) == 3
    slot = pool.acquire("l0")
    try:
        ids = np.asarray([prompt])
        out = tapp.generate(ids, max_new_tokens=WANT,
                            adapter_ids=np.asarray([slot]))
        assert int(out["cached_tokens"][0]) == 15
        assert out["generated"][0].tolist() == streams[0]
        tapp.write_lora_slot(slot, adapter_arrays(tapp, 100))  # the same
        out = tapp.generate(ids, max_new_tokens=WANT,
                            adapter_ids=np.asarray([slot]))
        assert int(out["cached_tokens"][0]) == 0
        assert out["generated"][0].tolist() == streams[0]
    finally:
        pool.release("l0")
    # the control: the reference's keying serves l0's KV to l1
    ctl_prompt = prompt[::-1]
    salt = tapp.lora_kv_salt
    tapp.lora_kv_salt = lambda s: b""
    try:
        prompt, want_l1 = ctl_prompt, _jax_alone(japp, ctl_prompt, "l1")
        hits, ctl = run(["l0", "l1"], 10)
    finally:
        tapp.lora_kv_salt = salt
    assert hits == [0, 15] and ctl[1] != want_l1


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "twophase"])
def test_base_only_passes_run_the_lora_free_step(pair, ragged):
    """A pass whose rows are all base rows carries no adapter ids (the
    LoRA-free step, whose tokens equal slot 0's); a pass with an adapter
    row carries them on every dispatch."""
    _, tapp = pair
    calls = []
    spied = ("_run_ragged", "_run_paged", "_run_paged_loop")
    for name in spied:
        def spy(*a, _run=getattr(tapp, name), **k):
            calls.append(k.get("adapter_ids") is not None)
            return _run(*a, **k)
        setattr(tapp, name, spy)
    try:
        pool = pool_of(LoraAdapterPool, tapp)
        base, _, _, _ = serve(PagedEngineAdapter, tapp, pool, [0, 1],
                              [P_A, P_C], None, ragged=ragged)
        assert calls and not any(calls)
        del calls[:]
        mixed, _, _, _ = serve(PagedEngineAdapter, tapp, pool, [2, 3],
                               [P_A, P_C], [{"adapter": "l1"}, None],
                               ragged=ragged)
        assert calls and all(calls)
    finally:
        for name in spied:
            delattr(tapp, name)
    assert mixed[3] == base[1] and mixed[2] != base[0]


def test_shed_adapters_admits_base_model(pair):
    """set_adapter_shed(True): a tagged admission takes no acquire, is
    annotated lora_shed=True and streams the base model; the controller
    drives the actuator on the real adapter."""
    _, tapp = pair
    pool = pool_of(LoraAdapterPool, tapp)
    ad = PagedEngineAdapter(tapp, ragged=True, lora_pool=pool)
    ad.add_requests([0], [P_B])
    base_toks, _ = collect(ad, (0,))
    ad.release([0])
    ad.set_adapter_shed(True)
    assert ad.adapter_shed
    meta = {"adapter": "l0"}
    ad.add_requests([1], [P_B], meta=[meta])
    shed_toks, _ = collect(ad, (1,))
    ad.release([1])
    assert shed_toks[1] == base_toks[0]
    assert meta["lora_shed"] is True
    assert pool.stats["misses"] == 0 and pool.stats["swaps"] == 0
    assert ad.host_stats["lora_shed_requests"] == 1
    ad.set_adapter_shed(False)
    assert "shed_adapters" in DEGRADE_ACTIONS

    class _Queue:
        def set_weight_scale(self, tenant, scale):
            pass

    class _Engine:
        adapter = ad
        queue = _Queue()
        slo = None

    ctl = DegradationController(enter_burn=2.0, exit_burn=1.0,
                                shed_adapters=True)
    ctl._active[("shed_adapters", "tA")] = 0.0
    ctl._apply(_Engine())
    assert ad.adapter_shed
    del ctl._active[("shed_adapters", "tA")]
    ctl._apply(_Engine())
    assert not ad.adapter_shed


def test_warmup_lists_lora_signatures(pair):
    """``precompile`` of a LoRA build lists every signature twice, the
    ``*_lora`` kinds with ids (on the CPU nothing is captured: the T = 1
    ones run eagerly once), then a multi-LoRA pass raises no incident."""
    _, tapp = pair
    rep = precompile(tapp, bt_widths=[tapp._bt_buckets[-1]],
                     spec_widths=[3])
    kinds = {g["kind"] for g in rep["graphs"]}
    for k in ("ragged", "paged", "spec_draft", "spec_verify"):
        assert {k, k + "_lora"} <= kinds, k
    try:
        serve(PagedEngineAdapter, tapp, pool_of(LoraAdapterPool, tapp),
              [0, 1], [P_A, P_C], [{"adapter": "l1"}, None], want=3,
              ragged=True)
        assert tapp.warmup_state()["incidents"] == []
    finally:
        tapp.declare_steady_state(False)
