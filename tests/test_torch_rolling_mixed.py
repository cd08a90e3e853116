"""The rolling and mixed per-layer KV caches and windowed context encoding
of the port against the JAX package's, on the same weights.

Mirrors tests/test_kv_cache.py::test_rolling_window_write,
tests/test_rolling_window.py, tests/test_long_context.py (windowed
equality) and tests/test_gpt_oss.py's mixed-cache cases:

  * the cache helpers (rolling write, ``fold_rolling_prefill``,
    ``init_mixed_cache``, ``mixed_layer_map``, ``rolling_decode_mask``)
    equal JAX's bit for bit;
  * ``cache_layout`` picks the rolling and mixed caches as the
    reference's ``spec_from_config`` does over a grid of configs;
  * a tiny Mistral (window 8) on the rolling cache equals its full-cache
    twin and the JAX rolling app: fp32 logits at atol=2e-3, rtol=1e-3
    (the suite's HF tolerance), identical greedy streams, also through
    ``ContinuousBatchingAdapter`` past ``seq_len``;
  * windowed context encoding equals one-shot prefill and JAX's windowed
    path, at two window sizes;
  * the tiny GPT-OSS of tests/test_torch_gpt_oss.py (window 8, seq_len 48)
    on the mixed cache equals the uniform cache and JAX, through
    ``generate`` and the continuous-batching adapter;
  * the contiguous decode kernel's plain twin over the mixed cache's
    global stack (a sink, window 0, GQA group 8, head_dim 64) equals the
    JAX Pallas kernel in interpret mode.

The ``cuda`` tests hold the two kernels to their twins at the geometries
the card runs them at (gpt-oss-20b's global stack, Mistral-7B-v0.1's
rolling prefill at window 4096); they skip without a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import (
    SpeculationConfig as JSpeculationConfig, TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.gpt_oss import \
    GptOssFamily as JGptOssFamily
from neuronx_distributed_inference_tpu.models.mistral import (
    MistralFamily as JMistralFamily, MistralInferenceConfig as JMistralConfig)
from neuronx_distributed_inference_tpu.modules import kv_cache as jkv
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.ops import decode_attention as jda
from neuronx_distributed_inference_tpu.serving import \
    ContinuousBatchingAdapter as JCbAdapter
from neuronx_distributed_inference_tpu_torch.config import (
    SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.gpt_oss import \
    TpuGptOssForCausalLM
from neuronx_distributed_inference_tpu_torch.models.mistral import (
    MistralFamily, MistralInferenceConfig)
from neuronx_distributed_inference_tpu_torch.modules import kv_cache as tkv
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from neuronx_distributed_inference_tpu_torch.ops import flash_attention
from neuronx_distributed_inference_tpu_torch.serving import \
    ContinuousBatchingAdapter
from neuronx_distributed_inference_tpu_torch.serving.warmup import (
    memory_ledger, precompile)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_gpt_oss import _configs, _save_checkpoint

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
WINDOW = 8
MISTRAL = dict(model_type="mistral", hidden_size=64, intermediate_size=128,
               num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=256,
               sliding_window=WINDOW)


# ---------------------------------------------------------------------------
# the cache helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_transposed", [True, False])
@pytest.mark.parametrize("positions", [[[11], [3], [-1]],              # decode
                                       [[0, 9, 17], [8, 23, -3],
                                        [5, 6, 7]]])                 # scatter
def test_rolling_window_write(k_transposed, positions):
    """The rolling write lands position p at slot p % w (11 % 8 = 3; a
    negative position wraps as the reference's modulo does), single-token
    and multi-token writes alike, equal to JAX's bit for bit."""
    rng = np.random.default_rng(0)
    L, B, H, D = 2, 3, 2, 4
    shape = (L, B, H, D, WINDOW) if k_transposed else (L, B, H, WINDOW, D)
    cache = rng.standard_normal(shape).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    new = rng.standard_normal((B, pos.shape[1], H, D)).astype(np.float32)
    rows = np.asarray([1, 2, 0], np.int32)
    want = np.asarray(jkv.write_tokens_at_layer(
        jnp.asarray(cache), jnp.asarray(new), 1, jnp.asarray(rows),
        jnp.asarray(pos), window=WINDOW, k_transposed=k_transposed))
    got = torch.from_numpy(cache.copy())
    tkv.write_tokens_at_layer(got, torch.from_numpy(new), 1,
                              torch.from_numpy(rows), torch.from_numpy(pos),
                              window=WINDOW, k_transposed=k_transposed)
    np.testing.assert_array_equal(got.numpy(), want)
    if pos.shape[1] == 1:
        slot = (got.numpy()[1, 1, :, :, 3] if k_transposed
                else got.numpy()[1, 1, :, 3])
        np.testing.assert_array_equal(slot, new[0, 0])


@pytest.mark.parametrize("k_transposed", [True, False])
def test_fold_rolling_prefill_matches_jax(k_transposed):
    """A full-length scratch folded into W rolling slots: each slot holds
    the latest position congruent to it, unreached slots zero."""
    rng = np.random.default_rng(1)
    L, B, H, D, S = 2, 3, 2, 4, 24
    shape = (L, B, H, D, S) if k_transposed else (L, B, H, S, D)
    scratch = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray([5, 24, 13], np.int32)
    want = np.asarray(jkv.fold_rolling_prefill(
        jnp.asarray(scratch), jnp.asarray(lens), WINDOW,
        k_transposed=k_transposed))
    got = tkv.fold_rolling_prefill(torch.from_numpy(scratch),
                                   torch.from_numpy(lens), WINDOW,
                                   k_transposed=k_transposed)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_mixed_cache_and_layer_map_match_jax():
    """The mixed cache's four stacks and the per-stack layer index equal
    the reference's, for gpt-oss's alternating pattern and lopsided
    ones."""
    kw = dict(num_layers=5, batch_size=2, max_seq_len=32, num_kv_heads=2,
              head_dim=4)
    for pattern in ((True, False) * 2 + (True,), (False,) * 5,
                    (True, True, False, True, True)):
        want = jkv.init_mixed_cache(jkv.KVCacheSpec(**kw), pattern, WINDOW)
        got = tkv.init_mixed_cache(tkv.KVCacheSpec(**kw), pattern, WINDOW,
                                   torch.device("cpu"))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        assert all(not v.any() for v in got.values())
        assert tkv.mixed_layer_map(pattern) == jkv.mixed_layer_map(pattern)
        assert tkv.cache_len_of(got) == jkv.cache_len_of(want) == 32
    spec = tkv.KVCacheSpec(window=WINDOW, **kw)
    assert spec.cache_len == WINDOW and spec.k_shape[-1] == WINDOW


def test_rolling_decode_mask_matches_jax():
    pos = np.asarray([[0], [5], [8], [30]], np.int32)
    want = np.asarray(jattn.rolling_decode_mask(jnp.asarray(pos), WINDOW))
    got = tattn.rolling_decode_mask(torch.from_numpy(pos), WINDOW)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the spec's decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rolling", [None, True, False])
def test_cache_layout_matches_reference_grid(rolling):
    """(rolling_window, mixed_kv) over seq_len x window x layer pattern x
    paged x speculation x windowed encoding equal the reference's
    ``spec_from_config``, and both raise where ``rolling_kv_cache=True``
    meets a blocker. Where the port's ``spec_from_config`` builds the
    config (no speculation), its spec carries the same decisions."""
    seen = set()
    for seq_len in (32, 64):
        for window in (0, 16, 64):
            for pattern in (False, True):
                for paged in (False, True):
                    for spec_len in (0, 3):
                        for wcte in (None, 16):
                            hf = tiny_llama_hf_config(**dict(
                                MISTRAL, num_hidden_layers=2,
                                sliding_window=window or None))
                            if pattern:
                                hf["layer_types"] = [
                                    "sliding_attention", "full_attention"]
                            kw = dict(batch_size=1, seq_len=seq_len,
                                      rolling_kv_cache=rolling,
                                      is_block_kv_layout=paged,
                                      windowed_context_encoding=wcte)
                            jkw = dict(kw)
                            if spec_len:
                                kw["speculation_config"] = \
                                    SpeculationConfig(speculation_length=3)
                                jkw["speculation_config"] = \
                                    JSpeculationConfig(speculation_length=3)
                            seen.add(_one_layout(hf, kw, jkw, window,
                                                 pattern))
    # the grid reaches every outcome the rule has: True never builds the
    # mixed cache (a layer pattern is a blocker), False never rolls
    want = {None: {(False, False), (True, False), (False, True)},
            True: {(False, False), (True, False), "raises"},
            False: {(False, False), (False, True)}}[rolling]
    assert seen == want


def _one_layout(hf, kw, jkw, window, pattern):
    tcfg = TpuConfig(**kw)
    try:
        jspec = JMistralFamily.build_spec(JMistralConfig(JTpuConfig(**jkw),
                                                         **hf))
    except ValueError as e:
        assert "rolling_kv_cache" in str(e)
        with pytest.raises(ValueError, match="rolling_kv_cache"):
            model_base.cache_layout(tcfg, window,
                                    (True, False) if pattern else None)
        with pytest.raises(ValueError, match="rolling_kv_cache"):
            MistralFamily.build_spec(MistralInferenceConfig(tcfg, **hf))
        return "raises"
    want = (jspec.rolling_window, jspec.mixed_kv)
    got = model_base.cache_layout(tcfg, jspec.sliding_window,
                                  jspec.layer_pattern)
    assert got == want, (kw, got, want)
    if not kw.get("speculation_config"):
        spec = MistralFamily.build_spec(MistralInferenceConfig(tcfg, **hf))
        assert (spec.rolling_window, spec.mixed_kv) == want
    return want


def test_rolling_rejected_for_speculation():
    """tests/test_rolling_window.py:79-89: ``rolling_kv_cache=True`` with
    speculation raises ValueError naming the knob."""
    hf = tiny_llama_hf_config(**MISTRAL)
    tcfg = TpuConfig(batch_size=2, seq_len=64, dtype="float32",
                     rolling_kv_cache=True,
                     speculation_config=SpeculationConfig(
                         speculation_length=3))
    with pytest.raises(ValueError, match="rolling_kv_cache"):
        MistralFamily.build_spec(MistralInferenceConfig(tcfg, **hf))


# ---------------------------------------------------------------------------
# the rolling cache
# ---------------------------------------------------------------------------

def _mistral_pair(layers=3, **tcfg):
    """(JAX app, port app) of the tiny Mistral on the same weights."""
    hf = tiny_llama_hf_config(**dict(MISTRAL, num_hidden_layers=layers))
    kw = dict(batch_size=2, seq_len=64, dtype="float32",
              enable_bucketing=False)
    kw.update(tcfg)
    japp = JApp(None, JMistralConfig(JTpuConfig(**kw), **hf),
                JMistralFamily).init_random_weights(5).init_cache()
    tapp = CausalLMApplication(None, MistralInferenceConfig(
        TpuConfig(**kw), **hf), MistralFamily, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    return japp, tapp.init_cache()


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)


@pytest.mark.parametrize("prompt_len", [12, 20])
def test_rolling_cache_matches_full_and_jax(prompt_len):
    """tests/test_rolling_window.py: the rolling cache keeps w = 8 slots
    a row; prompts of 12 and 20 tokens (longer than w: only the last w
    positions land) and 24 new tokens roll it several times. Logits of
    every step equal JAX's rolling app; the greedy stream equals the
    port's full-cache app's."""
    japp, tapp = _mistral_pair(output_logits=True)
    assert tapp.spec.rolling_window and japp.spec.rolling_window
    assert tapp.cache["k"].shape[-1] == tapp.cache["v"].shape[3] == WINDOW
    assert tapp._kv_bucket(40) is None
    ids = np.random.default_rng(prompt_len).integers(
        1, 250, size=(2, prompt_len)).astype(np.int32)
    want = japp.generate(ids, max_new_tokens=24, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=24, return_logits=True)
    _assert_same_run(got, want)
    _, full = _mistral_pair(rolling_kv_cache=False)
    full.params = tapp.params
    assert not full.spec.rolling_window
    np.testing.assert_array_equal(
        full.generate(ids, max_new_tokens=24)["generated"], got["generated"])


def _staggered(eng, p1, p2, steps=20):
    """Two requests joining at different times on rows 2 and 0; row 2
    decodes past seq_len (32): the rolling cache never overflows."""
    got1 = [eng.add_requests([2], [p1])[2]]
    for _ in range(3):
        got1.append(eng.step()[2])
    got2 = [eng.add_requests([0], [p2])[0]]
    for _ in range(steps):
        res = eng.step()
        got1.append(res[2])
        got2.append(res[0])
    eng.release([0, 2])
    return got1, got2


def test_rolling_continuous_batching_matches_jax():
    """``ContinuousBatchingAdapter`` over the rolling cache (gather path,
    rows by seq_id): streams equal the JAX adapter's, past ``seq_len``
    (the adapter's position limit is off for a rolling cache)."""
    japp, tapp = _mistral_pair(batch_size=4, seq_len=32,
                               is_continuous_batching=True,
                               enable_bucketing=True,
                               context_encoding_buckets=[16])
    rng = np.random.default_rng(2)
    p1 = rng.integers(1, 250, size=13).tolist()
    p2 = rng.integers(1, 250, size=9).tolist()
    teng = ContinuousBatchingAdapter(tapp)
    assert teng._pos_limit is None
    got = _staggered(teng, p1, p2)
    assert 13 + 23 > 32 and len(got[0]) == 24
    assert got == _staggered(JCbAdapter(japp), p1, p2)


# ---------------------------------------------------------------------------
# windowed context encoding
# ---------------------------------------------------------------------------

def _llama_prompts(lens, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 250, size=n)
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("wcte", [16, 32])
def test_windowed_cte_matches_one_shot_and_jax(wcte):
    """tests/test_long_context.py:35-59: a 50-token prompt and a 41-token
    one prefilled in windows of 16 or 32 (padded positions pushed past the
    cache) give the one-shot prefill's stream and JAX's windowed stream;
    the window count is ceil(50 / w)."""
    kw = dict(seq_len=96, rolling_kv_cache=False)
    ids, mask = _llama_prompts((50, 41), wcte)
    japp, tapp = _mistral_pair(windowed_context_encoding=wcte, **kw)
    assert not tapp.spec.mixed_kv and not tapp.spec.rolling_window
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=12)
    windows = [k for k in tapp._jit_seen if k[0] == "windowed_cte"]
    assert windows == [("windowed_cte", wcte, (2,))]
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=12)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    _, one_shot = _mistral_pair(**kw)
    one_shot.params = tapp.params
    np.testing.assert_array_equal(
        one_shot.generate(ids, attention_mask=mask,
                          max_new_tokens=12)["generated"], got["generated"])


def test_windowed_cte_refusals():
    """As the reference: no logits output from a windowed prefill; a
    rolling cache cannot take it (slot != position); the multi-token step
    refuses the mixed cache. The warm-up plan lists the windowed step as
    eager."""
    _, tapp = _mistral_pair(seq_len=96, rolling_kv_cache=False,
                            windowed_context_encoding=16)
    plan = {(g["kind"], g["bucket"]): g["outcome"]
            for g in precompile(tapp, declare_steady=False)["graphs"]}
    assert plan[("windowed_cte", 16)] == "eager"
    ids = np.ones((2, 40), np.int64)
    with pytest.raises(NotImplementedError, match="logits"):
        tapp.generate(ids, max_new_tokens=2, return_logits=True)
    _, roll = _mistral_pair(seq_len=96, windowed_context_encoding=16)
    assert roll.spec.rolling_window
    with pytest.raises(NotImplementedError, match="rolling"):
        roll.generate(ids, max_new_tokens=2)
    spec = dataclasses.replace(roll.spec, rolling_window=False,
                               mixed_kv=True)
    with pytest.raises(NotImplementedError, match="mixed"):
        model_base.token_generation_multi(spec, roll.tpu_config, roll.params,
                                          roll.cache, None, None, None)


# ---------------------------------------------------------------------------
# the mixed per-layer cache (tiny GPT-OSS)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oss_ckpt(tmp_path_factory):
    return _save_checkpoint(tmp_path_factory.mktemp("oss_hd16"), 16)


def _oss_pair(ckpt, **tcfg):
    jcfg, tcfg_ = _configs(ckpt, **tcfg)
    japp = JApp(ckpt, jcfg, JGptOssFamily).load_weights().init_cache()
    tapp = TpuGptOssForCausalLM(ckpt, tcfg_, device="cpu")
    return japp, tapp.load_weights().init_cache()


def _nbytes(cache):
    return sum(x.numel() * x.element_size() for x in cache.values())


def test_mixed_per_layer_kv_cache_halves_bytes(oss_ckpt):
    """tests/test_gpt_oss.py:119-149: at seq_len 48 > window 8 the local
    layers' rows roll at 8 slots (cache ~42% smaller); logits of every
    step equal JAX's mixed app and the stream equals the uniform cache's,
    with a ragged batch (one row padded)."""
    kw = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
    japp, tapp = _oss_pair(oss_ckpt, **kw)
    assert tapp.spec.mixed_kv and japp.spec.mixed_kv
    assert set(tapp.cache) == {"k", "v", "k_l", "v_l"}
    uniform = TpuGptOssForCausalLM(oss_ckpt, _configs(oss_ckpt, **kw)[1],
                                   device="cpu")
    uniform.spec = dataclasses.replace(uniform.spec, mixed_kv=False)
    uniform.params = tapp.params
    uniform.init_cache()
    assert _nbytes(tapp.cache) < 0.62 * _nbytes(uniform.cache)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 250, size=(2, 11)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    ids[1, 9:] = 0
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=12,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=12,
                        return_logits=True)
    _assert_same_run(got, want)
    np.testing.assert_array_equal(
        uniform.generate(ids, attention_mask=mask,
                         max_new_tokens=12)["generated"], got["generated"])


def test_mixed_kv_continuous_batching_serving(oss_ckpt):
    """tests/test_gpt_oss.py:152-: interleaved requests through
    ``ContinuousBatchingAdapter`` on the mixed cache (the prefill folds
    into the real rows, decode gathers both stacks by seq_id) give the
    JAX adapter's streams; the precompile plan covers the app and the
    memory ledger counts the local stacks."""
    kw = dict(batch_size=4, seq_len=48, dtype="float32",
              is_continuous_batching=True, enable_bucketing=True,
              context_encoding_buckets=[16])
    japp, tapp = _oss_pair(oss_ckpt, **kw)
    assert tapp.spec.mixed_kv
    rng = np.random.default_rng(3)
    p1 = rng.integers(1, 250, size=9).tolist()
    p2 = rng.integers(1, 250, size=12).tolist()
    report = precompile(tapp)
    assert report["n_graphs"] >= 2 and not report["n_compiles"]
    tapp.reset()
    teng = ContinuousBatchingAdapter(tapp)
    got = _staggered(teng, p1, p2, steps=6)
    assert got == _staggered(JCbAdapter(japp), p1, p2, steps=6)
    ledger = memory_ledger(teng)
    stacks = ledger["kv"]["stacks"]
    assert set(stacks) == {"k", "v", "k_l", "v_l"}
    assert stacks["k_l"] * 6 == stacks["k"]        # 8 of 48 slots
    assert ledger["kv"]["pool_bytes"] == sum(stacks.values())


def test_decode_kernel_twin_over_the_mixed_global_stack_matches_jax():
    """The contiguous decode kernel's wrapper (its plain twin on the CPU)
    over a mixed cache's global stack, at gpt-oss's heads (GQA group 8,
    head_dim 64, a sink, window 0), at the stack index of a global
    layer, against the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, s, layers = 2, 16, 2, 64, 256, 2
    k = rng.standard_normal((layers, b, hkv, d, s)).astype(np.float32)
    v = rng.standard_normal((layers, b, hkv, s, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    nk = rng.standard_normal((b, hkv, d)).astype(np.float32)
    nv = rng.standard_normal((b, hkv, d)).astype(np.float32)
    sink = rng.standard_normal((hq,)).astype(np.float32)
    lens = np.asarray([37, 201], np.int32)
    lmap = tkv.mixed_layer_map((True, False, True, False))
    want = np.asarray(jda.decode_attention_stacked(
        *(jnp.asarray(x) for x in (q, k, v, nk, nv)), jnp.asarray(lmap[3]),
        jnp.asarray(lens), scale=d ** -0.5, window=jnp.asarray(0),
        sink=jnp.asarray(sink), interpret=True))
    got = decode_attention.decode_attention_stacked(
        *(torch.from_numpy(x) for x in (q, k, v, nk, nv)), lmap[3],
        torch.from_numpy(lens), scale=d ** -0.5, window=0,
        sink=torch.from_numpy(sink))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the kernels at the geometries of the long-context phase
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_decode_kernel_gpt_oss_20b_global_stack():
    """The contiguous decode kernel over gpt-oss-20b's global stack (12
    layers, B 4, S 32768, Hq 64 over Hkv 8, D 64, a sink, window 0, lens
    300-2100) against its twin, bf16, within one bf16 ulp of the largest
    output. The sinks (7 +- 1) hold a tenth to two thirds of each row's
    softmax mass, so the kernel without them must fall outside that."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, d, s = 4, 64, 8, 64, 32768

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    k, v = rnd(12, b, hkv, d, s), rnd(12, b, hkv, s, d)
    args = (rnd(b, hq, d), k, v, rnd(b, hkv, d), rnd(b, hkv, d), 11,
            torch.tensor([300, 900, 1500, 2100], dtype=torch.int32,
                         device=dev))
    kw = dict(scale=d ** -0.5, window=0,
              sink=7.0 + torch.randn((hq,), generator=gen, device=dev))
    got = decode_attention.decode_attention_stacked(*args, **kw)
    want = decode_attention.decode_attention_stacked_plain(*args, **kw)
    tol = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= tol
    no_sink = decode_attention.decode_attention_stacked(
        *args, **dict(kw, sink=None))
    assert float((no_sink.float() - want.float()).abs().max()) > tol


@pytest.mark.cuda
def test_cuda_flash_mistral_7b_window_4096():
    """The flash kernel at Mistral-7B-v0.1's heads (Hq 32 over Hkv 8, D
    128) at window 4096 over S 8192, B 2, against its twin row by row,
    bf16, within one bf16 ulp of the largest value."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, hq, hkv, d = 2, 8192, 32, 8, 128
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(scale=d ** -0.5, window=4096)
    got = flash_attention.flash_attention(q, k, v, **kw)
    tol = 2.0 ** (np.floor(np.log2(float(v.float().abs().max()))) - 7)
    for i in range(b):
        want = flash_attention.flash_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
        assert float((got[i:i + 1].float() - want.float()).abs().max()) \
            <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rolling", "mixed"])
def test_cuda_graph_replays_recompute_rolling_slots(layout, tmp_path):
    """On the card the T = 1 decode step replays a captured graph: its
    rolling write slots and masks come from each replay's positions, so
    a stream that rolls the window many times equals the eager app's
    (``cuda_graphs=False``), fp32 with TF32 off."""
    dev = _card()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        apps = []
        for graphs in (True, False):
            if layout == "rolling":
                hf = tiny_llama_hf_config(**MISTRAL)
                app = CausalLMApplication(None, MistralInferenceConfig(
                    TpuConfig(batch_size=2, seq_len=64, dtype="float32"),
                    **hf), MistralFamily, device=dev, cuda_graphs=graphs)
            else:
                ckpt = _save_checkpoint(tmp_path / "oss", 64)
                app = CausalLMApplication(ckpt, _configs(
                    ckpt, batch_size=2, seq_len=48, dtype="float32")[1],
                    device=dev, cuda_graphs=graphs)
            app.init_cache()
            if apps:
                app.params = apps[0].params
            else:
                app.init_random_weights(3)
            apps.append(app)
        assert apps[0].spec.rolling_window or apps[0].spec.mixed_kv
        ids = np.random.default_rng(6).integers(1, 250, size=(2, 12))
        got, want = (a.generate(ids, max_new_tokens=30)["generated"]
                     for a in apps)
        assert len(apps[0].graphs) >= 1
        np.testing.assert_array_equal(got, want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
