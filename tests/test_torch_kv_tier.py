"""The KV cache's host tier in the port (``serving/fleet/kv_tier.py``,
``serving/fleet/handoff.py`` and the spill / restore of
``PagedEngineAdapter``) against the JAX package's, case for case with
tests/test_fleet.py.

Geometry: the reference test's tiny Llama (hidden 64, 2 layers, 4 q / 2
kv heads of 16, vocab 512, block 8, ctx bucket 16, batch 4, 40 blocks),
fp32, built with the LoRA config of tests/test_torch_lora_serving.py
(``max_loras`` 3, rank 4, q_proj / v_proj) so that base and adapter rows
share one app. The JAX app draws its weights (``init_random_weights(7)``)
and the port holds them through ``params_from_numpy``. Token streams are
identical (fp32, greedy), stats and counts exact, payload bytes exact.

LoRA keying: a pooled adapter's rows key the tier and the records by the
adapter's name, so KV spilled under one adapter is never restored for
another or for a base row, in one engine, across engines whose slots
coincide, or through a record; the reference's keying (every chain from
b"") is the control that must serve the wrong KV."""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.serving import (
    PagedEngineAdapter as JAdapter)
from neuronx_distributed_inference_tpu.serving.engine import \
    ServingEngine as JServingEngine
from neuronx_distributed_inference_tpu.serving.fleet import (
    HostKVSpillTier as JTier, admit_handoff as jadmit,
    capture_handoff as jcapture, handoff_from_json as jfrom_json,
    handoff_to_json as jto_json)
from neuronx_distributed_inference_tpu.serving.warmup import \
    memory_ledger as jmemory_ledger
from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, ConfigurationError, HandoffError, StepFailure)
from neuronx_distributed_inference_tpu_torch.serving import (
    LoraAdapterPool, PagedEngineAdapter)
from neuronx_distributed_inference_tpu_torch.serving import \
    adapter as adapter_mod
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.serving.fleet import (
    HANDOFF_SCHEMA, HostKVSpillTier, admit_handoff, capture_handoff,
    handoff_from_json, handoff_to_json)
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    memory_ledger
from test_torch_lora_serving import (HF, LORA, TCFG, adapter_arrays,
                                     collect, make_pair)

WANT = 6
P = np.random.default_rng(31).integers(1, 500, size=17).tolist()  # 2 + 1
CHUNK = 16


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def golden(pair):
    """The JAX engine's greedy stream of ``P`` (two-phase, fresh cache)."""
    japp, _ = pair
    japp.init_cache()
    ad = JAdapter(japp)
    toks = [ad.add_requests([0], [P])[0]]
    while len(toks) < WANT:
        toks.append(ad.step([0])[0])
    ad.release([0])
    return toks


def port_app(tapp, share=True):
    """A second port app on the same config: the same weight tensors
    (``share``), or a copy (its own LoRA slots)."""
    app = PagedCausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(
            **dict(TCFG, lora_config=LoraServingConfig(**LORA))), **HF),
        LlamaFamily, device="cpu")
    app.params = (tapp.params if share else
                  jax.tree.map(lambda t: t.clone(), tapp.params))
    return app.init_cache()


def evict_lru(mgr, seed=991):
    """Drive every LRU-resident block through the eviction hook with one
    pool-sized cold admission (aborted: its hashes are purged); token
    values above every prompt's, so the cold chain never hits."""
    cold = np.random.default_rng(seed).integers(
        600, 5000, size=(mgr.spec.num_blocks - 1) * mgr.spec.block_size)
    mgr.begin_sequence(999, cold.tolist())
    mgr.abort_sequence(999)
    assert not getattr(mgr.allocator, "_lru", []), "LRU not drained"


def ragged(app, tier=None, pool=None):
    return PagedEngineAdapter(app, ragged=True, kv_spill_tier=tier,
                              lora_pool=pool, prefill_chunk_tokens=CHUNK)


def run(ad, sid, prompt, name=None, want=WANT):
    """Admit one request, collect ``want`` tokens, release."""
    first = ad.add_requests([sid], [prompt],
                            meta=[{"adapter": name}] if name else None)
    toks, _ = collect(ad, [sid], want, first=first)
    ad.release([sid])
    return toks[sid]


def pool_of(app, names=("l0", "l1")):
    pool = LoraAdapterPool(app)
    for i, n in enumerate(names):
        pool.register_arrays(n, adapter_arrays(app, 100 + i))
    return pool


# ---------------------------------------------------------------------------
# the tier itself
# ---------------------------------------------------------------------------

def test_tier_bounds_and_eviction_order_match_reference():
    """Bounded, oldest-touched first, hits refresh recency, seed rides the
    bound: the port's tier and the reference's end in equal stats,
    membership and bytes after the same operations."""
    tiers = (HostKVSpillTier(max_blocks=2), JTier(max_blocks=2))

    def payload(t, x):
        a = np.full((2, 8, 2, 16), x, np.float32)
        return torch.from_numpy(a) if isinstance(t, HostKVSpillTier) else a
    for t in tiers:
        t.spill(b"h1", payload(t, 1), payload(t, 1))
        t.spill(b"h2", payload(t, 2), payload(t, 2))
        assert t.get(b"h1") is not None
        t.spill(b"h3", payload(t, 3), payload(t, 3))
        assert t.get(b"h2") is None
        t.spill(b"h1", payload(t, 1), payload(t, 1))   # recency touch only
        t.seed({b"h4": {"k": payload(t, 4), "v": payload(t, 4)}})
    port, ref = tiers
    assert port.stats == ref.stats
    assert port.stats["spilled"] == 3 and port.stats["evicted"] == 2
    assert [port.contains(h) for h in (b"h1", b"h2", b"h3", b"h4")] == \
        [ref.contains(h) for h in (b"h1", b"h2", b"h3", b"h4")]
    assert port.nbytes == ref.nbytes == 2 * 2 * 2048 and len(port) == 2
    with pytest.raises(ConfigurationError):
        HostKVSpillTier(max_blocks=0)


# ---------------------------------------------------------------------------
# spill and restore on the ragged engine
# ---------------------------------------------------------------------------

def test_spill_restore_on_the_ragged_engine_matches_jax(pair, golden):
    """Serve, evict the LRU (spill), serve again (restore) on both
    packages' ragged engines with a tier: streams equal the JAX engine's
    and the recomputed run; the tier's stats, the spill counts, the
    warmth, the ``prefill_real_tokens`` deltas, ``memory_ledger``'s spill
    section and ``ServingEngine.seq_id_of`` equal the reference's."""
    japp, tapp = pair
    japp.init_cache()
    tapp.init_cache()
    out = {}
    for name, app, tier_cls, adapter_cls, eng_cls, ledger in (
            ("jax", japp, JTier, JAdapter, JServingEngine, jmemory_ledger),
            ("port", tapp, HostKVSpillTier, PagedEngineAdapter,
             ServingEngine, memory_ledger)):
        tier = tier_cls(max_blocks=16)
        ad = adapter_cls(app, ragged=True, kv_spill_tier=tier,
                         prefill_chunk_tokens=CHUNK)
        eng = eng_cls(ad)
        st = eng.submit(P, WANT, request_id="r0")
        eng.run_pass()
        sid = eng.seq_id_of("r0")
        eng.run_until_drained()
        first = list(st.tokens)
        evict_lru(app.kv_mgr)
        warm = ad.prefix_warmth(P)
        real = ad.host_stats["prefill_real_tokens"]
        st = eng.submit(P, WANT)
        eng.run_until_drained()
        led = ledger(ad)
        out[name] = dict(
            sid=(sid, eng.seq_id_of("r0"), eng.seq_id_of("nope")),
            first=first, second=list(st.tokens), warm=warm,
            real=ad.host_stats["prefill_real_tokens"] - real,
            stats=dict(tier.stats), spill=led["spill"],
            spilled_bytes=led["kv"]["bytes"]["spilled"],
            counts=(ad.host_stats["kv_spilled_blocks"],
                    ad.host_stats["kv_restored_blocks"]))
        assert not app.kv_mgr.tables
    port, ref = out["port"], out["jax"]
    assert port == ref
    assert port["first"] == port["second"] == golden
    assert port["warm"] == 16 and port["real"] == 1
    assert port["sid"][0] is not None and port["sid"][1:] == (None, None)
    assert port["counts"] == (2, 2) and port["stats"]["restored"] == 2
    assert port["spill"]["bytes"] == 2 * 2 * 2 * 8 * 2 * 16 * 4
    assert tapp.kv_mgr.allocator_kind == "python"       # the hook's swap


def test_kv_restore_fault_rolls_back_and_retry_heals(pair, golden):
    """``kv_restore`` fires before the write: the admission rolls back
    exactly (typed, retry-safe, free pool as before, nothing admitted),
    and the same admission then restores and matches."""
    _, tapp = pair
    tapp.init_cache()
    tier = HostKVSpillTier(max_blocks=16)
    ad = ragged(tapp, tier)
    assert run(ad, 0, P) == golden
    evict_lru(tapp.kv_mgr, seed=992)
    free = tapp.kv_mgr.allocator.num_free
    with FAULTS.inject("kv_restore") as fp:
        with pytest.raises(StepFailure) as ei:
            ad.add_requests([1], [P])
    assert fp.trips == 1 and ei.value.retry_safe
    assert tapp.kv_mgr.allocator.num_free == free
    assert not tapp.kv_mgr.tables and not ad.pending_prefill_ids
    assert run(ad, 1, P) == golden
    assert tier.stats["restored"] == 2


def test_kv_spill_fault_degrades_to_recompute(pair, golden):
    """A failing spill is counted and dropped; the eviction succeeds and
    the next admission recomputes, with the same stream."""
    _, tapp = pair
    tapp.init_cache()
    tier = HostKVSpillTier(max_blocks=16)
    ad = ragged(tapp, tier)
    assert run(ad, 0, P) == golden
    with FAULTS.inject("kv_spill", times=99):
        evict_lru(tapp.kv_mgr, seed=993)
    assert tier.stats["spill_errors"] == 2 and len(tier) == 0
    assert ad.prefix_warmth(P) == 0
    assert run(ad, 1, P) == golden
    assert tier.stats["restored"] == 0


# ---------------------------------------------------------------------------
# the handoff
# ---------------------------------------------------------------------------

def _capture(side, app):
    """A prefill-role adapter of ``side`` admits ``P`` and hands it off
    after its first token: (first token, JSON wire string)."""
    if side == "jax":
        app.init_cache()
        ad = JAdapter(app)
        t0 = ad.add_requests([5], [P])[5]
        return t0, json.dumps(jto_json(jcapture(ad, 5, now=0.0)))
    app.init_cache()
    ad = PagedEngineAdapter(app)
    t0 = ad.add_requests([5], [P])[5]
    return t0, json.dumps(handoff_to_json(capture_handoff(ad, 5, now=0.0)))


@pytest.mark.parametrize("route", ["port-port", "jax-port", "port-jax"])
def test_handoff_streams_and_records(pair, golden, route):
    """Capture after the first token, cross the JSON wire, admit on the
    decode side (the port's ragged engine, or the reference's two-phase
    adapter), decode: the stream equals the single-engine golden, only
    the uncovered suffix recomputes (18 tokens, 16 restored), and the
    records of both packages carry the same hashes and ``Preempted``
    payload."""
    japp, tapp = pair
    src, dst = route.split("-")
    t0, wire = _capture(src, japp if src == "jax" else tapp)
    assert t0 == golden[0]
    other = _capture("port" if src == "jax" else "jax",
                     tapp if src == "jax" else japp)[1]
    a, b = json.loads(wire), json.loads(other)
    assert [x["hash"] for x in a["kv_blocks"]] == \
        [x["hash"] for x in b["kv_blocks"]]
    assert {k: v for k, v in a.items() if k != "kv_blocks"} == \
        {k: v for k, v in b.items() if k != "kv_blocks"}
    if dst == "jax":
        japp.init_cache()
        tier = JTier(max_blocks=16)
        ad = JAdapter(japp, kv_spill_tier=tier)
        real = ad.host_stats["prefill_real_tokens"]
        toks = [t0, jadmit(ad, jfrom_json(json.loads(wire)), 0)[0]]
        while len(toks) < WANT:
            toks.append(ad.step([0])[0])
        ad.release([0])
    else:
        dapp = port_app(tapp)
        tier = HostKVSpillTier(max_blocks=16)
        ad = ragged(dapp, tier)
        real = ad.host_stats["prefill_real_tokens"]
        assert admit_handoff(ad, handoff_from_json(json.loads(wire)),
                             0) == {}
        got, _ = collect(ad, [0], WANT - 1)
        ad.release([0])
        toks = [t0] + got[0]
    assert toks == golden
    assert tier.stats["restored"] == 2 and tier.stats["seeded"] == 2
    assert ad.host_stats["prefill_real_tokens"] - real == 2


def _wire_pair(dtype):
    """One record as each package holds it (port: torch payloads; JAX:
    numpy / ml_dtypes), the same bytes."""
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((2, 2, 8, 2, 16)).astype(np.float32)
    if dtype == "float32":
        arr = raw
    else:
        arr = raw.astype(getattr(ml_dtypes, dtype))
    ten = torch.from_numpy(arr.view(np.uint8).copy()).view(
        getattr(torch, dtype))
    meta = {"schema": HANDOFF_SCHEMA, "preempted": {"schema": "x"},
            "block_size": 8}
    tail = {"kind": "handoff", "delivered_tokens": 1, "trace": None}
    port = dict(meta, kv_blocks=[{"hash": bytes([i] * 16), "k": ten[0, i],
                                  "v": ten[1, i]} for i in range(2)], **tail)
    ref = dict(meta, kv_blocks=[{"hash": bytes([i] * 16), "k": arr[0, i],
                                 "v": arr[1, i]} for i in range(2)], **tail)
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_handoff_json_is_the_reference_wire_form(dtype):
    """The JSON of a record is byte-identical to the reference's for fp32,
    bf16 and fp8 payloads, and each package decodes the other's to the
    same bytes."""
    port, ref = _wire_pair(dtype)
    wire = json.dumps(handoff_to_json(port))
    assert wire == json.dumps(jto_json(ref))
    back = handoff_from_json(json.loads(wire))
    jback = jfrom_json(json.loads(wire))
    for pb, jb, ob in zip(back["kv_blocks"], jback["kv_blocks"],
                          port["kv_blocks"]):
        assert pb["hash"] == jb["hash"] == ob["hash"]
        for name in ("k", "v"):
            assert pb[name].dtype == ob[name].dtype
            assert tuple(pb[name].shape) == jb[name].shape
            raw = ob[name].contiguous().view(torch.uint8).numpy().tobytes()
            assert pb[name].view(torch.uint8).numpy().tobytes() == raw
            assert jb[name].tobytes() == raw


def test_handoff_refusals_leave_both_sides_unchanged(pair):
    """Capture: unknown or mid-prefill seq, the ``handoff`` fault (the
    sequence keeps running). Admit: no tier, bad schema, another
    block_size, another dtype, another block shape, the ``handoff`` fault
    and malformed JSON, each a HandoffError with the decode pool exact."""
    _, tapp = pair
    tapp.init_cache()
    pre = PagedEngineAdapter(tapp)
    pre.add_requests([5], [P])
    with pytest.raises(HandoffError):
        capture_handoff(pre, 99)
    with FAULTS.inject("handoff"):
        with pytest.raises(HandoffError):
            capture_handoff(pre, 5)
    assert 5 in pre.seqs
    rec = capture_handoff(pre, 5)
    assert 5 not in pre.seqs and not tapp.kv_mgr.tables
    dapp = port_app(tapp)
    free = dapp.kv_mgr.allocator.num_free
    with pytest.raises(HandoffError):
        admit_handoff(PagedEngineAdapter(dapp), rec, 0)       # no tier
    ad = ragged(dapp, HostKVSpillTier(max_blocks=16))

    def blocks(fn):
        return dict(rec, kv_blocks=[dict(b, k=fn(b["k"]), v=fn(b["v"]))
                                    for b in rec["kv_blocks"]])
    bad = [dict(rec, schema="bogus"), dict(rec, block_size=16),
           blocks(lambda t: t.to(torch.bfloat16)),
           blocks(lambda t: t[:, :4]),
           blocks(lambda t: t.numpy())]
    for r in bad:
        with pytest.raises(HandoffError):
            admit_handoff(ad, r, 0)
    with FAULTS.inject("handoff"):
        with pytest.raises(HandoffError):
            admit_handoff(ad, rec, 0)
    with pytest.raises(HandoffError):
        handoff_from_json({"kv_blocks": [{"dtype": "nope"}]})
    assert dapp.kv_mgr.allocator.num_free == free
    assert len(ad._kv_tier) == 0 and not dapp.kv_mgr.tables


# ---------------------------------------------------------------------------
# LoRA keying through the tier and the records
# ---------------------------------------------------------------------------

def test_lora_kv_never_restores_for_another_adapter(pair, monkeypatch):
    """One engine: ``P`` spilled under l0 is not restored for l1 or a base
    row (each stream equals its run alone), and is restored for l0. The
    control (the reference's keying, every chain from b"") restores l0's
    KV for l1, whose stream then parts from its own."""
    _, tapp = pair
    alone = {}
    for name in ("l0", "l1", None):
        tapp.init_cache()
        alone[name] = run(ragged(tapp, pool=pool_of(tapp)), 0, P, name)
    assert len({tuple(v) for v in alone.values()}) == 3

    def served():
        tapp.init_cache()
        tier = HostKVSpillTier(max_blocks=16)
        ad = ragged(tapp, tier, pool_of(tapp))
        got, restored = {}, {}
        for sid, name in enumerate(("l0", "l1", None, "l0")):
            if sid:
                evict_lru(tapp.kv_mgr, seed=900 + sid)
            before = tier.stats["restored"]
            got[sid] = run(ad, sid, P, name)
            restored[sid] = tier.stats["restored"] - before
        return got, restored
    got, restored = served()
    assert restored == {0: 0, 1: 0, 2: 0, 3: 2}
    assert [got[i] for i in range(4)] == [alone["l0"], alone["l1"],
                                          alone[None], alone["l0"]]
    monkeypatch.setattr(adapter_mod, "adapter_tier_salt", lambda n: b"")
    got, restored = served()
    assert restored[1] == 2 and got[1] != alone["l1"]


def test_lora_slots_coinciding_across_engines(pair, monkeypatch):
    """Engine X serves l0 and engine Y l1 from the same slot number (the
    same prefix-cache salt on both), over one shared tier: Y's l1 row
    restores nothing of X's l0 KV, through the tier or through a record
    whose adapter names l1, and its streams equal l1's own. With the
    reference's keying the same record serves l0's KV to Y's l1 row.
    A slot written outside the pool keeps its rows off the tier and out
    of records."""
    # two fresh apps, each with its own slots and its own write counts
    tapp, yapp = (port_app(pair[1], share=False) for _ in range(2))
    px, py = pool_of(tapp), pool_of(yapp)
    assert px.acquire("l0") == py.acquire("l1")
    px.release("l0")
    py.release("l1")
    assert tapp.lora_kv_salt(px.slot_of("l0")) == \
        yapp.lora_kv_salt(py.slot_of("l1"))

    def record():
        """X hands ``P`` off under l0; the record is retagged l1."""
        tapp.init_cache()
        pre = PagedEngineAdapter(tapp, lora_pool=px)
        t0 = pre.add_requests([3], [P], meta=[{"adapter": "l0"}])[3]
        rec = handoff_from_json(json.loads(json.dumps(handoff_to_json(
            capture_handoff(pre, 3)))))
        rec["preempted"]["meta"] = {"adapter": "l1"}
        return rec, t0
    rec, t0 = record()
    # l1's own streams of P and of the record's tokens, on a cold cache
    alone = run(ragged(yapp, pool=py), 0, P, "l1")
    yapp.init_cache()
    want = run(ragged(yapp, pool=py), 0, P + [t0], "l1")
    yapp.init_cache()
    tapp.init_cache()
    tier = HostKVSpillTier(max_blocks=32)
    adx, ady = ragged(tapp, tier, px), ragged(yapp, tier, py)
    run(adx, 0, P, "l0")
    evict_lru(tapp.kv_mgr)
    assert tier.stats["spilled"] == 2
    assert run(ady, 0, P, "l1") == alone
    assert tier.stats["restored"] == 0

    def admitted(rec, sid):
        yapp.init_cache()
        ad = ragged(yapp, HostKVSpillTier(max_blocks=32), py)
        admit_handoff(ad, rec, sid)
        toks, _ = collect(ad, [sid], WANT)
        ad.release([sid])
        return toks[sid], ad._kv_tier.stats["restored"]
    assert admitted(rec, 1) == (want, 0)
    monkeypatch.setattr(adapter_mod, "adapter_tier_salt", lambda n: b"")
    toks, restored = admitted(record()[0], 2)
    assert restored == 2 and toks != want
    monkeypatch.undo()
    # a hot update of l0's slot: its rows are keyed to this engine now
    tapp.init_cache()
    adx = ragged(tapp, HostKVSpillTier(max_blocks=32), px)
    adx.add_requests([4], [P], meta=[{"adapter": "l0"}])
    tapp.write_lora_slot(px.slot_of("l0"), adapter_arrays(tapp, 100))
    assert not px.portable("l0") and adx.tier_salt(4) is None
    collect(adx, [4], 1)
    with pytest.raises(HandoffError):
        capture_handoff(adx, 4)
    adx.release([4])
    evict_lru(tapp.kv_mgr)
    assert adx._kv_tier.stats["spilled"] == 0
