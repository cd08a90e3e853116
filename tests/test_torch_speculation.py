"""Fused draft / target speculation of the port (``models/speculation.py``)
against the JAX package's (the pins of tests/test_speculation.py).

Geometry: tiny fp32 Llamas (hidden 256, 4 q / 2 kv heads of head_dim 64,
so the port's draft steps take its contiguous decode kernel's plain twin;
the draft hidden 128, 2 q / 1 kv heads), batch 2, seq_len 96, k 4. The JAX
apps' ``init_random_weights`` trees are carried into the port with
``utils.jax_params.params_from_numpy``. Tolerances: logits atol=2e-3,
rtol=1e-3 (the suite's HF tolerance), caches atol=1e-4; tokens, accept
counts and streams exact. With a separate draft the acceptance counts of
a whole run may differ between the packages (a draft's near-tie rounds
either way: the port's draft steps take the kernel's twin, the
reference's the XLA path), so those runs are held to equal streams and
counts to a single step from equal caches; self-speculation's counts are
held to the reference's step for step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import (
    SpeculationConfig as JSpeculationConfig, TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models import model_base as jmb
from neuronx_distributed_inference_tpu.models import speculation as jspec
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu_torch.config import (
    SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models import speculation
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import (attention,
                                                         decode_attention)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
CACHE_TOL = dict(atol=1e-4, rtol=1e-4)
K = 4
TARGET = tiny_llama_hf_config(hidden_size=256, num_attention_heads=4,
                              num_key_value_heads=2, intermediate_size=512,
                              num_hidden_layers=2)
DRAFT = tiny_llama_hf_config(hidden_size=128, num_attention_heads=2,
                             num_key_value_heads=1, intermediate_size=256,
                             num_hidden_layers=2)
TCFG = dict(batch_size=2, seq_len=96, dtype="float32",
            enable_bucketing=False)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def make_pair(hf, k=0, seed=7, spec_cfg=None, **over):
    """(JAX app, port app) on the same config and weights; ``k`` > 0 adds
    the speculation config of fused speculation, ``spec_cfg`` (a dict of
    ``SpeculationConfig`` fields) any other."""
    jkw, kw = dict(TCFG, **over), dict(TCFG, **over)
    if k:
        spec_cfg = dict(speculation_length=k)
    if spec_cfg:
        jkw["speculation_config"] = JSpeculationConfig(**spec_cfg)
        kw["speculation_config"] = SpeculationConfig(**spec_cfg)
    japp = JApp(None, JLlamaConfig(JTpuConfig(**jkw), **hf), JLlamaFamily)
    japp.init_random_weights(seed).init_cache()
    tapp = CausalLMApplication(None, LlamaInferenceConfig(TpuConfig(**kw),
                                                          **hf),
                               LlamaFamily, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    tapp.init_cache()
    return japp, tapp


@pytest.fixture(scope="module")
def apps():
    """target (k 4), draft and plain target pairs; each test re-inits the
    caches it uses."""
    return {"target": make_pair(TARGET, K), "draft": make_pair(DRAFT,
                                                               seed=3),
            "plain": make_pair(TARGET), "self_draft": make_pair(TARGET)}


def _fresh(*pairs):
    for pair in pairs:
        for app in pair:
            app.init_cache()


def _ids(seed, b=2, s=10):
    return np.random.default_rng(seed).integers(1, 500, size=(b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def golden(apps):
    """Plain greedy streams of the port (held to JAX's) for the prompt
    seeds the tests use."""
    jp, tp = apps["plain"]
    out = {}
    for seed, n in ((0, 24), (2, 16)):
        _fresh(apps["plain"])
        want = jp.generate(_ids(seed), max_new_tokens=n)["generated"]
        got = tp.generate(_ids(seed), max_new_tokens=n)["generated"]
        np.testing.assert_array_equal(got, np.asarray(want))
        out[seed] = got
    return out


def test_speculation_mask_matches_jax():
    pos = np.array([[3, 4, 5, 6], [10, 11, 12, 13]], np.int32)
    for window in (0, 4):
        want = np.asarray(jattn.speculation_mask(pos, 16, window))
        got = attention.speculation_mask(torch.as_tensor(pos), 16,
                                         window).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, attention.decode_mask(torch.as_tensor(pos), 16,
                                       window).numpy())


def test_fused_step_matches_jax_from_equal_caches(apps):
    """One fused step after equal prefills: the drafts' tokens, the accept
    counts, the verify's logits and both caches equal JAX's."""
    (jt, tt), (jd, td) = apps["target"], apps["draft"]
    _fresh(apps["target"], apps["draft"])
    ids = _ids(5)
    lens = np.full((2,), ids.shape[1], np.int32)
    jfirst = np.asarray(jt._run_prefill(ids, lens)["tokens"])
    jd._run_prefill(ids, lens)
    tfirst = tt._run_prefill(ids, lens)["tokens"].numpy()
    td._run_prefill(ids, lens)
    np.testing.assert_array_equal(tfirst, jfirst)
    for a, b in ((tt, jt), (td, jd)):
        for name in ("k", "v"):
            np.testing.assert_allclose(a.cache[name].numpy(),
                                       np.asarray(b.cache[name]),
                                       **CACHE_TOL)
    pos = lens.copy()
    sid = np.arange(2, dtype=np.int32)
    jcache_before = jt.cache
    want = jspec.fused_speculation_step(
        jd.spec, jt.spec, jt.tpu_config, jd.params, jt.params, jd.cache,
        jt.cache, jfirst.astype(np.int32), pos, sid,
        jax.random.PRNGKey(0))
    got = speculation.fused_speculation_step(
        td.spec, tt.spec, tt.tpu_config, td.params, tt.params, td.cache,
        tt.cache, torch.as_tensor(tfirst), torch.as_tensor(pos),
        torch.as_tensor(sid), td._inv_freq, tt._inv_freq)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["num_accepted"].numpy(),
                                  np.asarray(want["num_accepted"]))
    # the reference returns no logits: its verify on the same candidates
    # (its step returned new caches; jd.cache / jt.cache are the old ones)
    drafts = np.asarray(jspec.draft_k_tokens(
        jd.spec, jt.tpu_config, jd.params, jd.cache,
        jfirst.astype(np.int32), pos, sid, K)[0])
    cand = np.concatenate([jfirst[:, None].astype(np.int32), drafts], 1)
    jlog = jmb.token_generation_multi(
        jt.spec, jt.tpu_config, jt.params, jcache_before, cand,
        pos[:, None] + np.arange(K + 1, dtype=np.int32), sid)["logits_all"]
    np.testing.assert_allclose(got["logits_all"].numpy(), np.asarray(jlog),
                               **LOGIT_TOL)
    for a, b in ((tt.cache, want["target_cache"]),
                 (td.cache, want["draft_cache"])):
        for name in ("k", "v"):
            np.testing.assert_allclose(a[name].numpy(),
                                       np.asarray(b[name]), **CACHE_TOL)


def test_speculative_decoder_matches_jax_and_greedy(apps, golden):
    (jt, tt), (jd, td) = apps["target"], apps["draft"]
    _fresh(apps["target"], apps["draft"])
    want = jspec.SpeculativeDecoder(jt, jd).generate(_ids(0),
                                                      max_new_tokens=24)
    got = speculation.SpeculativeDecoder(tt, td).generate(_ids(0),
                                                           max_new_tokens=24)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    np.testing.assert_array_equal(got["generated"], golden[0])
    assert got["mean_tokens_per_step"] >= 1.0
    np.testing.assert_array_equal(got["sequences"][:, :10], _ids(0))


def test_self_speculation_accepts_everything(apps, golden):
    """Draft == target (fp32): while the draft cache holds every accepted
    position, every draft is accepted, so the first fused step of each row
    emits k + 1, in both packages. After a fully accepted step the
    reference's draft loop leaves the k-th draft's KV unwritten (the k
    draft steps write the last token and drafts 1 .. k - 1), so later
    steps accept less; the stream stays greedy's, and every step's accept
    counts equal the reference's."""
    (jt, tt), (js, ts) = apps["target"], apps["self_draft"]
    _fresh(apps["target"], apps["self_draft"])
    counts = []
    orig = speculation._host_loop

    def spy(*a, **kw):
        step_fn = a[7]

        def wrapped(positions):
            toks, n = step_fn(positions)
            counts.append(n.copy())
            return toks, n
        return orig(*a[:7], wrapped, *a[8:], **kw)
    speculation._host_loop = spy
    try:
        got = speculation.SpeculativeDecoder(tt, ts).generate(
            _ids(0), max_new_tokens=24)
    finally:
        speculation._host_loop = orig
    jdec = jspec.SpeculativeDecoder(jt, js)
    jcounts = []
    jbuild = jdec._build_step

    def jspy():
        step = jbuild()

        def wrapped(*a):
            res = step(*a)
            jcounts.append(np.asarray(res["num_accepted"]).copy())
            return res
        return wrapped
    jdec._build_step = jspy
    want = jdec.generate(_ids(0), max_new_tokens=24)
    np.testing.assert_array_equal(got["generated"], golden[0])
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    np.testing.assert_array_equal(counts[0], [K + 1, K + 1])
    # the accept counts are the reference's, step for step
    np.testing.assert_array_equal(np.stack(counts), np.stack(jcounts))
    assert got["mean_tokens_per_step"] == want["mean_tokens_per_step"] > 1.0


def test_speculation_with_eos_stops(apps, golden):
    (jt, tt), (jd, td) = apps["target"], apps["draft"]
    _fresh(apps["target"], apps["draft"])
    eos = int(golden[2][0, 3])
    got = speculation.SpeculativeDecoder(tt, td).generate(
        _ids(2), max_new_tokens=16, eos_token_id=eos)
    want = jspec.SpeculativeDecoder(jt, jd).generate(
        _ids(2), max_new_tokens=16, eos_token_id=eos)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    row = got["generated"][0].tolist()
    first = row.index(eos)
    assert row[:first + 1] == golden[2][0, :first + 1].tolist()
    assert all(t == eos for t in row[first:])


def test_rejected_slots_are_never_read(apps, golden, monkeypatch):
    """A draft with a zero lm-head always proposes token 0 (never the
    target's choice here), so 0 of 4 drafts are accepted at every step.
    After each step the slots past the accepted prefix (the rejected
    candidates in the target cache, the draft's own writes) are poisoned
    with 1e4: a read with any weight would wreck the next logits. The next
    step must rewrite them before reading, and the decode kernel's
    ``lens`` must be the step's position (``_decode_inputs``). The stream
    stays greedy's."""
    (jt, tt), (jd, td) = apps["target"], apps["draft"]
    _fresh(apps["target"], apps["draft"])
    assert (golden[0] != 0).all()
    saved = td.params
    params = dict(saved)
    params["lm_head"] = torch.zeros_like(params["lm_head"])
    td.params = params
    lens_seen = []
    orig_inputs = model_base._decode_inputs

    def spy_inputs(*a, **kw):
        ai = orig_inputs(*a, **kw)
        if ai["use_kernel"]:
            lens_seen.append((ai["lens"].clone(), a[3][:, 0].clone()))
        return ai
    monkeypatch.setattr(model_base, "_decode_inputs", spy_inputs)
    dec = speculation.SpeculativeDecoder(tt, td)
    orig_step = dec._step

    def poisoned(last, positions, seq_ids):
        toks, n = orig_step(last, positions, seq_ids)
        for i, p in enumerate(positions):
            hi = int(p) + K + 1
            lo = int(p) + int(n[i])
            for cache in (tt.cache, td.cache):
                cache["k"][:, i, :, :, lo:hi] = 1e4
                cache["v"][:, i, :, lo:hi] = 1e4
        assert (n == 1).all()
        return toks, n
    dec._step = poisoned
    try:
        got = dec.generate(_ids(0), max_new_tokens=12)
    finally:
        td.params = saved
    np.testing.assert_array_equal(got["generated"], golden[0][:, :12])
    assert got["mean_tokens_per_step"] == 1.0
    assert lens_seen and decode_attention.supports(td.spec, 1)
    for lens, pos in lens_seen:
        np.testing.assert_array_equal(lens.numpy(), pos.numpy())


def test_params_from_numpy_carries_medusa_and_eagle_leaves():
    """The EAGLE draft tree (``fc``, ``fc_norm``) and a target tree with
    Medusa heads cross into the port leaf for leaf, and the port's specs
    name the same leaves with the same shapes."""
    jt, _ = make_pair(TARGET)
    jspec_m = dataclasses.replace(jt.spec, medusa_heads=3)
    tree = jmb.init_param_tree(jmb.decoder_param_specs(jspec_m),
                               jax.random.PRNGKey(1))
    draft = jmb.spec_from_config(jt.config, tp_degree=1, num_layers=1)
    etree = jspec.init_eagle_draft_params(draft, jax.random.PRNGKey(2),
                                          input_norm=True)
    _, tt = make_pair(TARGET)
    tspec_m = dataclasses.replace(tt.spec, medusa_heads=3)
    tdraft = dataclasses.replace(tt.spec, num_layers=1)
    for jtree, tspecs in ((tree, model_base.decoder_param_specs(tspec_m)),
                          (etree, speculation.eagle_draft_param_specs(
                              tdraft, input_norm=True))):
        host = jax.tree.map(np.asarray, jtree)
        got = params_from_numpy(host, device="cpu")
        assert set(got) == set(host) == set(tspecs)
        for name in ("medusa_blocks", "medusa_bias", "medusa_lm", "fc",
                     "fc_norm"):
            if name in host:
                np.testing.assert_array_equal(got[name].numpy(), host[name])
                assert tuple(got[name].shape) == tspecs[name].shape
