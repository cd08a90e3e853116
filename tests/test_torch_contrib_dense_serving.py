"""The contrib hub's dense families of the port on the paged app and the
ragged engine, against the JAX package's: GPT-NeoX and BLOOM at head_dim
64 (the kernels' width; test_torch_contrib_dense.py's reference configs
widened to hidden 256, two layers) and GPT-2 (learned positions over the
paged positions). fp32 logits at atol=2e-3, rtol=1e-3 with greedy tokens
identical; three requests through a batch of two on the ragged engine
give the JAX engine's streams. GPT-NeoX's T = 1 steps reach the paged
kernel's wrapper on every layer (its plain twin on the CPU; the
reference's Pallas kernel in interpret mode); BLOOM's ALiBi layers never
do, in either package."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from test_torch_contrib_dense import (VARIANTS, _no_tf32,  # noqa: F401
                                      assert_logits_close, make_apps,
                                      save_ckpts)
from test_torch_dense_families import ids_of
from test_torch_serving_engine import _serve

NAMES = ("bloom_d64", "gpt2", "gpt_neox_d64")
PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
RNG = np.random.default_rng(41)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (11, 23, 30)]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_paged_logits_and_ragged_streams_match_jax(ckpts, name,
                                                   monkeypatch):
    """The paged app's ``generate`` gives JAX's logits and greedy tokens;
    the ragged engine (prefill chunks of 16) gives the JAX engine's
    streams. The paged kernel's wrapper is called at every layer of
    GPT-NeoX (group 1) and never for BLOOM or GPT-2 (head_dim 16)."""
    calls = set()
    orig = decode_attention.paged_decode_attention

    def spy(*a, **k):
        calls.add((int(a[5]), a[0].shape[1] // a[3].shape[1]))
        return orig(*a, **k)
    monkeypatch.setattr(decode_attention, "paged_decode_attention", spy)
    japp, tapp = make_apps(ckpts[name], name, PAGED, paged=True)
    ids, mask = ids_of([20, 13], seed=5)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    jserved = _serve(japp, "jax", True, subs, chunk=16)
    served = _serve(tapp, "port", True, subs, chunk=16)
    assert served[:3] == jserved[:3]
    assert [len(t) for t in served[0]] == [6, 5, 4]
    assert calls == ({(0, 1), (1, 1)} if name == "gpt_neox_d64" else set())
