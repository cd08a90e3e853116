"""The contiguous-cache application of the port against the JAX package's,
on the same weights.

Tiny Mistral geometries with a sliding window of 64 and prompts of 150-200
tokens, so the window bites in prefill and in decode: with
``attn_kernel_enabled=True`` and ``rolling_kv_cache=False`` both sides
take the flash prefill kernel (ctx bucket 256) and the contiguous decode
kernel (default admission for a windowed model) — the JAX Pallas kernels
in interpret mode, the port's wrappers on their plain twins. A tiny Llama
with defaults runs neither kernel and covers the gather path, ``kv_view``
buckets and the chunked side-buffer decode loop. The JAX app's
``init_random_weights(7)`` parameters are carried across with
``utils.jax_params.params_from_numpy``. fp32 logits agree at atol=2e-3,
rtol=1e-3 (the suite's HF tolerance, tests/test_llama_golden.py); greedy
tokens and served streams are identical."""

import jax
import numpy as np
import pytest

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.models.mistral import (
    MistralFamily as JMistralFamily, MistralInferenceConfig as JMistralConfig)
from neuronx_distributed_inference_tpu.serving import \
    ContinuousBatchingAdapter as JCbAdapter
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig, TpuLlamaForCausalLM)
from neuronx_distributed_inference_tpu_torch.models.mistral import (
    MistralFamily, MistralInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import (decode_attention,
                                                         flash_attention)
from neuronx_distributed_inference_tpu_torch.resilience.errors import (
    ConfigurationError, ServingError)
from neuronx_distributed_inference_tpu_torch.serving import \
    ContinuousBatchingAdapter
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
MISTRAL = dict(model_type="mistral", hidden_size=256, num_hidden_layers=2,
               intermediate_size=512, sliding_window=64)
GEOMETRIES = {"hd64": dict(MISTRAL, num_attention_heads=4,
                           num_key_value_heads=2),
              "hd128": dict(MISTRAL, num_attention_heads=2,
                            num_key_value_heads=1)}
LLAMA = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=512, num_hidden_layers=2)
FAMILIES = {"mistral": (JMistralFamily, JMistralConfig, MistralFamily,
                        MistralInferenceConfig),
            "llama": (JLlamaFamily, JLlamaConfig, LlamaFamily,
                      LlamaInferenceConfig)}


def _mistral_tcfg(**over):
    kw = dict(batch_size=2, seq_len=256, dtype="float32", output_logits=True,
              attn_kernel_enabled=True, rolling_kv_cache=False)
    kw.update(over)
    return kw


def _pair(hf_over, tcfg):
    """(JAX app, port app) on the same config and the same weights."""
    hf = tiny_llama_hf_config(**hf_over)
    jfam, jcfg, tfam, tcfg_cls = FAMILIES[hf.get("model_type", "llama")]
    japp = JApp(None, jcfg(JTpuConfig(**tcfg), **hf), jfam)
    japp.init_random_weights(7).init_cache()
    tapp = CausalLMApplication(None, tcfg_cls(TpuConfig(**tcfg), **hf),
                               tfam, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    tapp.init_cache()
    return japp, tapp


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 500, size=n)
        mask[i, :n] = 1
    return ids, mask


class _CountCalls:
    def __init__(self, monkeypatch, owner, name):
        self.n = 0
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            self.n += 1
            return fn(*a, **k)
        monkeypatch.setattr(owner, name, wrapped)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_mistral_kernel_path_logits_match_jax(monkeypatch, geom):
    """Prefill (flash kernel) then 5 decode steps (decode kernel) with
    the window biting: every step's fp32 logits and the greedy tokens
    agree with JAX, and every layer of every step went through the port's
    kernel wrappers."""
    japp, tapp = _pair(GEOMETRIES[geom], _mistral_tcfg())
    assert tapp.spec.sliding_window == 64 and tapp.spec.flash_prefill
    flash = _CountCalls(monkeypatch, flash_attention, "flash_attention")
    dec = _CountCalls(monkeypatch, decode_attention,
                      "decode_attention_stacked")
    ids, mask = _prompts([190, 153])
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert len(got["logits"]) == len(want["logits"]) == 6
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)
    layers = tapp.spec.num_layers
    assert flash.n == layers and dec.n == layers * 5


@pytest.mark.parametrize("chunk", [1, 4])
def test_mistral_greedy_generate_token_identical(chunk):
    """Greedy streams equal JAX's; a windowed model keeps the per-step
    decode path inside the fused loop."""
    japp, tapp = _pair(GEOMETRIES["hd64"],
                       _mistral_tcfg(output_logits=False,
                                     decode_chunk_tokens=chunk))
    ids, mask = _prompts([170, 200], seed=1)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=9)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=9)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])


def _llama_tcfg(**over):
    kw = dict(batch_size=2, seq_len=128, dtype="float32",
              token_generation_buckets=[32, 64, 128],
              context_encoding_buckets=[16, 32])
    kw.update(over)
    return kw


@pytest.mark.parametrize("chunk", [1, 4])
def test_llama_gather_path_and_side_buffer_match_jax(monkeypatch, chunk):
    """A plain Llama runs neither kernel: prefill ``mha``, decode
    ``mha_hl`` over ``kv_view``-cut reads (buckets 32/64/128 are crossed),
    and with ``decode_chunk_tokens=4`` the chunked side-buffer branch
    (``mha_decode_merged`` + ``commit_chunk``). Logits (per step) and
    greedy streams (fused loop) match JAX."""
    japp, tapp = _pair(LLAMA, _llama_tcfg(output_logits=chunk == 1,
                                          decode_chunk_tokens=chunk))
    flash = _CountCalls(monkeypatch, flash_attention, "flash_attention")
    dec = _CountCalls(monkeypatch, decode_attention,
                      "decode_attention_stacked")
    merged = _CountCalls(monkeypatch, model_base.attn_ops,
                         "mha_decode_merged")
    ids, mask = _prompts([25, 9], seed=2)
    kw = dict(attention_mask=mask, max_new_tokens=40,
              return_logits=chunk == 1)
    want = japp.generate(ids, **kw)
    got = tapp.generate(ids, **kw)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    if chunk == 1:
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL)
    assert flash.n == 0 and dec.n == 0
    assert (merged.n > 0) == (chunk == 4)
    # a second request on the same cache rows after reset
    japp.reset()
    tapp.reset()
    ids2, mask2 = _prompts([31, 12], seed=3)
    np.testing.assert_array_equal(
        tapp.generate(ids2, attention_mask=mask2,
                      max_new_tokens=7)["generated"],
        japp.generate(ids2, attention_mask=mask2,
                      max_new_tokens=7)["generated"])


def test_warmup_repad_shim_and_eos_match_jax():
    """``warmup`` runs every bucket (its writes are overwritten or masked
    by the next request); b below the batch pads by repeating row 0, b
    above splits; eos fills after the first hit, checked one chunk late
    as JAX does."""
    japp, tapp = _pair(LLAMA, _llama_tcfg(decode_chunk_tokens=3))
    tapp.warmup()
    for lens in ([12], [12, 30, 7]):
        ids, mask = _prompts(lens, seed=4)
        want = japp.generate(ids, attention_mask=mask, max_new_tokens=5)
        got = tapp.generate(ids, attention_mask=mask, max_new_tokens=5)
        np.testing.assert_array_equal(got["generated"], want["generated"])
        np.testing.assert_array_equal(got["seq_lens"], want["seq_lens"])
    eos = int(want["generated"][0, 2])
    ids, mask = _prompts([12, 30], seed=4)
    a = japp.generate(ids, attention_mask=mask, max_new_tokens=12,
                      eos_token_id=eos)
    b = tapp.generate(ids, attention_mask=mask, max_new_tokens=12,
                      eos_token_id=eos)
    np.testing.assert_array_equal(b["generated"], a["generated"])


def _cb_pair():
    tcfg = dict(batch_size=4, seq_len=128, dtype="float32",
                context_encoding_buckets=[16, 32],
                is_continuous_batching=True)
    japp, tapp = _pair(LLAMA, tcfg)
    return JCbAdapter(japp), ContinuousBatchingAdapter(tapp)


def _staggered(eng, p1, p2):
    """tests/test_serving_adapter.py:35-67: two requests joining at
    different times on rows 2 and 0, then only row 0 steps; then a fused
    ``step_many`` on row 2."""
    got1 = [eng.add_requests([2], [p1])[2]]
    for _ in range(3):
        got1.append(eng.step()[2])
    got2 = [eng.add_requests([0], [p2])[0]]
    for _ in range(4):
        res = eng.step()
        got1.append(res[2])
        got2.append(res[0])
    for _ in range(3):
        got2.append(eng.step([0])[0])
    many = eng.step_many(3, [2])[2]
    eng.release([0, 2])
    return got1, got2, many, eng.free_slots


def test_continuous_batching_streams_match_jax():
    """Decode under continuous batching gathers the live cache rows (no
    decode kernel: the rows are not the identity); prefill writes rows by
    seq_id. Streams equal the JAX adapter's."""
    jeng, teng = _cb_pair()
    rng = np.random.default_rng(0)
    p1 = rng.integers(1, 500, size=9).tolist()
    p2 = rng.integers(1, 500, size=12).tolist()
    assert _staggered(teng, p1, p2) == _staggered(jeng, p1, p2)
    # the integer counters (the *_blocked_s timings differ per run)
    counters = {k: v for k, v in teng.host_stats.items()
                if isinstance(v, int)}
    assert counters == {k: jeng.host_stats[k] for k in counters}


def test_continuous_adapter_rejects_misuse():
    """tests/test_serving_adapter.py:69-83, plus the admission errors."""
    hf = tiny_llama_hf_config(**LLAMA)
    app = CausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(batch_size=2, seq_len=64,
                                             dtype="float32"), **hf),
        LlamaFamily, device="cpu")
    app.init_random_weights(7).init_cache()
    with pytest.raises(ValueError) as ei:
        ContinuousBatchingAdapter(app)     # needs continuous batching
    assert isinstance(ei.value, ConfigurationError)
    assert isinstance(ei.value, ServingError)
    _, teng = _cb_pair()
    with pytest.raises(ServingError):
        teng.add_requests([7], [[1, 2, 3]])            # row out of range
    # a static app rejects non-identity rows (its steps skip the row
    # gather and take the identity write)
    with pytest.raises(ValueError, match="is_continuous_batching"):
        app._run_decode(np.zeros((2, 1), np.int32),
                        np.ones((2, 1), np.int32), seq_ids=[1, 0])
    with pytest.raises(ValueError, match="is_continuous_batching"):
        app._run_prefill(np.zeros((2, 16), np.int32),
                         np.ones((2,), np.int32), seq_ids=[1, 0])


def test_tpu_llama_for_causal_lm_builds_the_contiguous_app():
    """The README's Quick start: ``TpuLlamaForCausalLM`` builds
    ``CausalLMApplication`` (as the JAX entry does), on a config without
    the paged layout."""
    hf = tiny_llama_hf_config(**LLAMA)
    app = TpuLlamaForCausalLM(None, LlamaInferenceConfig(
        TpuConfig(batch_size=1, seq_len=64, dtype="float32"), **hf),
        device="cpu")
    assert type(app) is CausalLMApplication
    out = app.init_random_weights(0).generate(
        np.asarray([[5, 6, 7]]), max_new_tokens=3)
    assert out["generated"].shape == (1, 3)


@pytest.mark.parametrize("case", ["auto_rolling", "rolling_true",
                                  "layer_types", "windowed_cte"])
def test_unported_mistral_configs_raise(case):
    """The port refuses what the JAX package would run on a cache or path
    it does not have: the rolling cache (picked automatically for a window
    below seq_len, or asked for), a per-layer pattern (the mixed cache)
    and windowed context encoding."""
    hf = tiny_llama_hf_config(**GEOMETRIES["hd64"])
    tcfg = _mistral_tcfg()
    if case == "auto_rolling":
        tcfg.pop("rolling_kv_cache")
    elif case == "rolling_true":
        tcfg["rolling_kv_cache"] = True
    elif case == "layer_types":
        hf["layer_types"] = ["sliding_attention", "full_attention"]
    else:
        tcfg["windowed_context_encoding"] = 64
    with pytest.raises(ConfigurationError):
        CausalLMApplication(None, MistralInferenceConfig(TpuConfig(**tcfg),
                                                         **hf),
                            MistralFamily, device="cpu")
    # a window that covers seq_len never rolls, as in JAX
    tcfg = _mistral_tcfg(seq_len=64)
    tcfg.pop("rolling_kv_cache")
    app = CausalLMApplication(None, MistralInferenceConfig(
        TpuConfig(**tcfg), **dict(hf, layer_types=None)), MistralFamily,
        device="cpu")
    assert app.spec.sliding_window == 64
