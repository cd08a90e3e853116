"""The HF ``generate()`` adapter of the port (utils/hf_adapter.py) against
the JAX package's, on the same weights: the five cases of
tests/test_hf_adapter.py (right padding, left padding, a list of eos ids,
a ``GenerationConfig`` with dict output, the sampling path), each held to
the JAX adapter's sequences (greedy: identical) and to the port app's own
``generate``, plus the assisted-decoding refusal. The tiny Llama of
``conftest.tiny_llama_hf_config`` in fp32 on the CPU; the JAX app's
``init_random_weights(3)`` parameters are carried across with
``utils.jax_params.params_from_numpy``."""

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.utils.hf_adapter import \
    HuggingFaceGenerationAdapter as JAdapter
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.utils.hf_adapter import \
    HuggingFaceGenerationAdapter
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

HF = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=512)


@pytest.fixture(scope="module")
def apps():
    """(JAX app, port app) of the tiny Llama on the same weights (the
    configuration of tests/test_hf_adapter.py:30-36)."""
    hf = tiny_llama_hf_config(**HF)
    kw = dict(batch_size=2, seq_len=64, dtype="float32",
              enable_bucketing=False)
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
    """``assistant_model`` needs the fused SpeculativeDecoder (ROADMAP
    A6), which the port does not run yet."""
    with pytest.raises(ConfigurationError, match="A6"):
        HuggingFaceGenerationAdapter(apps[1]).generate(
            torch.ones((1, 4), dtype=torch.long), max_new_tokens=2,
            assistant_model=apps[1])
