"""The slice end to end: the port's paged Llama application and serving
adapter against the JAX package's, on the same weights.

Geometry: the ``hd64_ckpt`` tiny Llama of tests/test_decode_attention.py
(head_dim 64), so both sides take their decode-kernel branch: the JAX
Pallas kernel in interpret mode, the port's kernel wrapper on its plain
twin. The JAX app's ``init_random_weights(7)`` parameters are carried
across with ``utils.jax_params.params_from_numpy``. fp32 logits agree at
atol=2e-3, rtol=1e-3 (the suite's HF tolerance, tests/test_llama_golden.py);
greedy tokens and served streams are identical."""

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.models.mistral import (
    MistralFamily as JMistralFamily, MistralInferenceConfig as JMistralConfig)
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.models.mistral import (
    MistralFamily, MistralInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
HD64 = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=512, num_hidden_layers=2)
LLAMA3 = dict(HD64, vocab_size=500, tie_word_embeddings=True,
              rope_theta=500000.0,
              rope_scaling={"rope_type": "llama3", "factor": 32.0,
                            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                            "original_max_position_embeddings": 8192})
VARIANTS = {"hd64": HD64, "llama3_tied_padded_vocab": LLAMA3}


def _tcfg(**over):
    kw = dict(batch_size=2, seq_len=128, dtype="float32",
              is_block_kv_layout=True, pa_block_size=16,
              is_prefix_caching=True, context_encoding_buckets=[32, 64])
    kw.update(over)
    return kw


FAMILIES = {"llama": (JLlamaFamily, JLlamaConfig, LlamaFamily,
                      LlamaInferenceConfig),
            "mistral": (JMistralFamily, JMistralConfig, MistralFamily,
                        MistralInferenceConfig)}


def _pair(hf_over, **tcfg_over):
    """(JAX app, port app) on the same config and the same weights."""
    hf = tiny_llama_hf_config(**hf_over)
    jfam, jcfg, tfam, tcfg_cls = FAMILIES[hf["model_type"]]
    japp = JPagedApp(None, jcfg(JTpuConfig(**_tcfg(**tcfg_over)), **hf),
                     jfam)
    japp.init_random_weights(7).init_cache()
    tapp = PagedCausalLMApplication(
        None, tcfg_cls(TpuConfig(**_tcfg(**tcfg_over)), **hf), tfam,
        device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    tapp.init_cache()
    return japp, tapp


def _prompts(b, lens, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, max(lens)), np.int64)
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


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_logits_match_jax(monkeypatch, variant):
    """Prefill then 5 single decode steps through ``_run_paged``: every
    step's fp32 logits and tokens agree, and every decode step of every
    layer went through the port's decode-kernel wrapper."""
    japp, tapp = _pair(VARIANTS[variant], output_logits=True)
    assert model_base.use_decode_kernel(tapp.spec, 1, torch.float32)
    calls = _CountCalls(monkeypatch, decode_attention,
                        "paged_decode_attention")
    ids, mask = _prompts(2, [20, 13])
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert len(got["logits"]) == len(want["logits"]) == 6
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)
    assert got["logits"][0].shape[-1] == tapp.spec.vocab_size
    assert calls.n == tapp.spec.num_layers * 5


@pytest.mark.parametrize("kernel", [None, False])
def test_paged_mistral_honours_the_window(monkeypatch, kernel):
    """A paged Mistral app (window 64, prompts longer than it): the
    prefill gather path masks with the window, and decode passes it to the
    paged kernel (or masks with it on the gather path). Logits and greedy
    tokens match the JAX paged app, which never rolls a paged cache."""
    hf = dict(HD64, model_type="mistral", sliding_window=64)
    japp, tapp = _pair(hf, output_logits=True, seq_len=256,
                       context_encoding_buckets=[128],
                       attn_block_tkg_kernel_enabled=kernel)
    assert tapp.spec.sliding_window == 64
    calls = _CountCalls(monkeypatch, decode_attention,
                        "paged_decode_attention")
    ids, mask = _prompts(2, [120, 75], seed=6)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=5,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=5,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)
    assert calls.n == (0 if kernel is False else tapp.spec.num_layers * 4)


def test_gather_path_when_kernel_disabled(monkeypatch):
    """``attn_block_tkg_kernel_enabled=False`` selects the gather + mha
    path on both sides; the logits still agree with the JAX app's."""
    japp, tapp = _pair(HD64, output_logits=True,
                       attn_block_tkg_kernel_enabled=False)
    assert not model_base.use_decode_kernel(tapp.spec, 1, torch.float32)
    calls = _CountCalls(monkeypatch, decode_attention,
                        "paged_decode_attention")
    ids, mask = _prompts(2, [9, 30], seed=1)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=4,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=4,
                        return_logits=True)
    assert calls.n == 0
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL)


@pytest.mark.parametrize("chunk", [1, 4])
def test_greedy_generate_token_identical(monkeypatch, chunk):
    """Greedy tokens equal JAX's, per step (chunk 1) and through the fused
    decode loop with on-device slot advance (chunk 4)."""
    japp, tapp = _pair(HD64, decode_chunk_tokens=chunk)
    loops = _CountCalls(monkeypatch, model_base, "paged_decode_loop")
    ids, mask = _prompts(2, [17, 40], seed=2)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=11)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=11)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    assert loops.n == (0 if chunk == 1 else 2)        # 10 steps = 4+4+1+1


def test_prefix_cache_hit_on_second_generate():
    japp, tapp = _pair(HD64)
    ids, mask = _prompts(2, [40, 35], seed=3)
    first = [app.generate(ids, attention_mask=mask, max_new_tokens=3)
             for app in (japp, tapp)]
    ids2 = ids.copy()
    ids2[1, 20:] = (ids2[1, 20:] + 7) % 499 + 1    # row 1 shares 16+ tokens
    second = [app.generate(ids2, attention_mask=mask, max_new_tokens=5)
              for app in (japp, tapp)]
    for a, b in (first, second):
        np.testing.assert_array_equal(b["cached_tokens"], a["cached_tokens"])
        np.testing.assert_array_equal(b["generated"], a["generated"])
    assert second[1]["cached_tokens"].tolist() == [32, 16]


def test_repad_shim_matches_jax():
    """b below the batch bucket repeats row 0; b above splits."""
    japp, tapp = _pair(HD64, batch_size=2)
    for lens in ([12], [12, 30, 7]):
        ids, mask = _prompts(len(lens), lens, seed=4)
        want = japp.generate(ids, attention_mask=mask, max_new_tokens=4)
        got = tapp.generate(ids, attention_mask=mask, max_new_tokens=4)
        np.testing.assert_array_equal(got["generated"], want["generated"])
        japp.reset()
        tapp.reset()


def test_warmup_writes_nothing_then_generate_matches_jax():
    """``warmup`` dispatches every shape over a table of null blocks: its
    single steps write nothing (every slot is -1, and none wraps onto a
    live slot); its fused decode loop lands in the null block 0, as the
    reference's does, which nothing reads unmasked. Every real block stays
    bit-identical, and a generate after it still equals JAX's."""
    japp, tapp = _pair(HD64, decode_chunk_tokens=4)
    ids, mask = _prompts(2, [10, 21], seed=7)
    first = tapp.generate(ids, attention_mask=mask, max_new_tokens=3)
    before = {k: v.clone() for k, v in tapp.cache.items()}
    tapp.warmup()
    for k in before:
        assert torch.equal(tapp.cache[k][:, 1:], before[k][:, 1:]), k
    tapp.reset()
    japp.generate(ids, attention_mask=mask, max_new_tokens=3)
    japp.reset()
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=9)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=9)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    np.testing.assert_array_equal(got["cached_tokens"], want["cached_tokens"])
    np.testing.assert_array_equal(first["generated"],
                                  got["generated"][:, :3])


def _adapter_pair():
    kw = dict(batch_size=4, seq_len=64, context_encoding_buckets=[16],
              pa_block_size=8)
    japp, tapp = _pair(HD64, **kw)
    return JPagedEngineAdapter(japp), PagedEngineAdapter(tapp)


def _staggered(eng, p1, p2):
    """tests/test_serving_adapter.py:85-115: two requests, the second
    admitted after three steps of the first, then only row 1 steps."""
    got1 = [eng.add_requests([0], [p1])[0]]
    for _ in range(3):
        got1.append(eng.step()[0])
    got2 = [eng.add_requests([1], [p2])[1]]
    for _ in range(4):
        res = eng.step()
        got1.append(res[0])
        got2.append(res[1])
    for _ in range(3):
        got2.append(eng.step([1])[1])
    many = eng.step_many(3, [0])[0]
    eng.release([0, 1])
    return got1, got2, many


def test_adapter_staggered_streams_match_jax():
    jeng, teng = _adapter_pair()
    rng = np.random.default_rng(0)
    p1 = rng.integers(1, 500, size=9).tolist()
    p2 = rng.integers(1, 500, size=12).tolist()
    assert _staggered(teng, p1, p2) == _staggered(jeng, p1, p2)
    assert teng.app.kv_mgr.tables == {} and jeng.app.kv_mgr.tables == {}
    assert teng.host_stats == {k: jeng.host_stats[k]
                               for k in teng.host_stats}


def test_adapter_chunked_prefill_and_preemption_match_jax():
    """A prompt longer than the chunk width prefills in packed chunks; a
    pool too small for three rows preempts (lifo) on both sides alike."""
    kw = dict(batch_size=4, seq_len=64, context_encoding_buckets=[8, 16],
              pa_block_size=8, pa_num_blocks=9)
    japp, tapp = _pair(HD64, **kw)
    outs = []
    for eng in (JPagedEngineAdapter(japp, prefill_chunk_tokens=8),
                PagedEngineAdapter(tapp, prefill_chunk_tokens=8)):
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 500, size=n).tolist()
                   for n in (21, 18, 23)]
        log = [eng.add_requests([0, 1], prompts[:2])]
        for _ in range(6):
            log.append(eng.step())
        log.append(eng.add_requests([2], prompts[2:]))
        for _ in range(8):
            log.append(eng.step())
        log.append([(p.seq_id, p.n_generated, p.reason)
                    for p in eng.take_preempted()])
        outs.append(log)
    assert outs[1] == outs[0]
    assert any(outs[0][-1]), "the pool never ran dry: nothing preempted"
