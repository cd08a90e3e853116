"""The HF ``generate()`` adapter of the port (utils/hf_adapter.py) against
the JAX package's, on the same weights: the five cases of
tests/test_hf_adapter.py (right padding, left padding, a list of eos ids,
a ``GenerationConfig`` with dict output, the sampling path), each held to
the JAX adapter's sequences (greedy: identical) and to the port app's own
``generate``, plus assisted decoding (``assistant_model``) held to plain
greedy decode and the JAX adapter's assisted sequences. The tiny Llama of
``conftest.tiny_llama_hf_config`` in fp32 on the CPU; the JAX app's
``init_random_weights(3)`` parameters are carried across with
``utils.jax_params.params_from_numpy``."""

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import (
    SpeculationConfig as JSpeculationConfig, TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.utils.hf_adapter import \
    HuggingFaceGenerationAdapter as JAdapter
from neuronx_distributed_inference_tpu_torch.config import (
    SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.models.speculation import \
    SpeculativeDecoder
from neuronx_distributed_inference_tpu_torch.utils.hf_adapter import \
    HuggingFaceGenerationAdapter
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

HF = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=512)
TCFG = dict(batch_size=2, seq_len=64, dtype="float32",
            enable_bucketing=False)


@pytest.fixture(scope="module")
def apps():
    """(JAX app, port app) of the tiny Llama on the same weights (the
    configuration of tests/test_hf_adapter.py:30-36)."""
    hf = tiny_llama_hf_config(**HF)
    kw = TCFG
    japp = JApp(None, JLlamaConfig(JTpuConfig(**kw), **hf), JLlamaFamily)
    japp.init_random_weights(3).init_cache()
    tapp = CausalLMApplication(None, LlamaInferenceConfig(TpuConfig(**kw),
                                                          **hf),
                               LlamaFamily, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    return japp, tapp.init_cache()


def _both(apps, ids, **kw):
    """The port adapter's and the JAX adapter's output for one call (each
    app reset after)."""
    japp, tapp = apps
    got = HuggingFaceGenerationAdapter(tapp).generate(ids, **kw)
    tapp.reset()
    want = JAdapter(japp).generate(ids, **kw)
    japp.reset()
    return got, want


def test_right_padded_matches_app_generate(apps):
    ids = np.random.default_rng(0).integers(1, 512, size=(2, 8),
                                            dtype=np.int64)
    got, want = _both(apps, torch.tensor(ids), max_new_tokens=6)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    assert got.device == apps[1].device
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    direct = apps[1].generate(ids, max_new_tokens=6)["sequences"]
    apps[1].reset()
    np.testing.assert_array_equal(got.numpy(), direct)


def test_left_padding_normalized(apps):
    """A left-padded batch: ``sequences[:, :s]`` is the caller's input
    block unchanged and ``sequences[:, s:]`` exactly the new tokens of
    each row run right-padded."""
    rng = np.random.default_rng(1)
    p0 = rng.integers(1, 512, size=5, dtype=np.int64)
    p1 = rng.integers(1, 512, size=8, dtype=np.int64)
    s = 8
    ids = np.zeros((2, s), np.int64)
    mask = np.zeros((2, s), np.int64)
    ids[0, s - 5:] = p0
    mask[0, s - 5:] = 1
    ids[1], mask[1] = p1, 1
    got, want = _both(apps, torch.tensor(ids),
                      attention_mask=torch.tensor(mask), max_new_tokens=5,
                      pad_token_id=0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert HuggingFaceGenerationAdapter._normalize_padding(ids, mask)[3]
    r_ids = np.zeros((2, s), np.int64)
    r_mask = np.zeros((2, s), np.int64)
    r_ids[0, :5], r_mask[0, :5] = p0, 1
    r_ids[1], r_mask[1] = p1, 1
    direct = apps[1].generate(r_ids, attention_mask=r_mask,
                              max_new_tokens=5)
    apps[1].reset()
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :s], ids)
    np.testing.assert_array_equal(got[0, s:], direct["generated"][0])
    np.testing.assert_array_equal(got[1, s:], direct["generated"][1])


def test_multi_eos_token_ids(apps):
    """A LIST of eos ids: generation stops on any of them and pads with
    ``pad_token_id`` after the first hit."""
    ids = np.random.default_rng(5).integers(1, 512, size=(1, 6),
                                            dtype=np.int64)
    free, _ = _both(apps, torch.tensor(ids), max_new_tokens=8,
                    pad_token_id=0)
    stop = int(free[0, 6 + 1])
    got, want = _both(apps, torch.tensor(ids), max_new_tokens=8,
                      eos_token_id=[999999, stop], pad_token_id=0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    row = got.numpy()[0, 6:]
    assert row[1] == stop
    assert (row[2:] == 0).all()


def test_generation_config_and_dict_output(apps):
    """Defaults from a ``GenerationConfig``-like object, and from a dict
    passed per call; ``return_dict_in_generate`` gives ``{"sequences"}``."""
    ids = np.random.default_rng(2).integers(1, 512, size=(2, 6),
                                            dtype=np.int64)

    class GC:
        max_new_tokens = 4
        do_sample = False
        eos_token_id = None
        pad_token_id = 0

    japp, tapp = apps
    got = HuggingFaceGenerationAdapter(tapp, generation_config=GC()).generate(
        torch.tensor(ids), return_dict_in_generate=True)
    tapp.reset()
    want = JAdapter(japp, generation_config=GC()).generate(
        torch.tensor(ids), return_dict_in_generate=True)
    japp.reset()
    assert set(got) == {"sequences"} and got["sequences"].shape == (2, 10)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  want["sequences"].numpy())
    per_call = HuggingFaceGenerationAdapter(tapp).generate(
        ids, generation_config={"max_new_tokens": 3})
    tapp.reset()
    np.testing.assert_array_equal(per_call.numpy(),
                                  got["sequences"].numpy()[:, :9])


def test_sampling_path_runs(apps):
    """do_sample with top_k / temperature: the port draws from its own
    generator (its stream differs from JAX's key), so shape and range."""
    ids = np.random.default_rng(3).integers(1, 512, size=(2, 6),
                                            dtype=np.int64)
    seqs = HuggingFaceGenerationAdapter(apps[1]).generate(
        torch.tensor(ids), max_new_tokens=4, do_sample=True, top_k=5,
        temperature=0.7)
    apps[1].reset()
    assert seqs.shape == (2, 10)
    assert ((seqs >= 0) & (seqs < 512)).all()
    np.testing.assert_array_equal(seqs.numpy()[:, :6], ids)


def test_assisted_decoding_is_refused(apps):
    """``assistant_model`` runs fused speculation (ROADMAP A6, ported;
    the name is that of the refusal the port raised before): the adapter's
    application, with ``speculation_length`` 3, is the target and the
    assistant (an adapter, an application or a prebuilt
    ``SpeculativeDecoder``) the draft. On ragged right-padded prompts the
    sequences equal plain greedy ``generate``'s and the JAX adapter's
    assisted ones; the dict output carries the tokens per step."""
    japp, tapp = apps
    hf = tiny_llama_hf_config(**HF)
    jtarget = JApp(None, JLlamaConfig(JTpuConfig(
        **TCFG, speculation_config=JSpeculationConfig(speculation_length=3)),
        **hf), JLlamaFamily)
    jtarget.params = japp.params
    jtarget.init_cache()
    target = CausalLMApplication(None, LlamaInferenceConfig(TpuConfig(
        **TCFG, speculation_config=SpeculationConfig(speculation_length=3)),
        **hf), LlamaFamily, device="cpu")
    target.params = tapp.params
    target.init_cache()
    ids = np.random.default_rng(4).integers(1, 512, size=(2, 9),
                                            dtype=np.int64)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    plain = tapp.generate(ids, attention_mask=mask,
                          max_new_tokens=10)["generated"]
    tapp.reset()
    want = JAdapter(jtarget).generate(
        ids, attention_mask=mask, max_new_tokens=10, assistant_model=japp)
    japp.reset()
    for assistant in (tapp, HuggingFaceGenerationAdapter(tapp),
                      SpeculativeDecoder(target, tapp)):
        got = HuggingFaceGenerationAdapter(target).generate(
            torch.tensor(ids), attention_mask=torch.tensor(mask),
            max_new_tokens=10, assistant_model=assistant,
            return_dict_in_generate=True)
        tapp.reset()
        target.reset()
        np.testing.assert_array_equal(got["sequences"].numpy(),
                                      want.numpy())
        np.testing.assert_array_equal(got["sequences"].numpy()[:, 9:],
                                      plain)
        assert got["mean_tokens_per_step"] >= 1.0
