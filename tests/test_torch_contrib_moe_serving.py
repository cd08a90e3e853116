"""The contrib hub's MoE families of the port on the paged app and the
ragged engine, against the JAX package's: the tiny checkpoints of
test_torch_contrib_moe.py (the reference tests' configs, weights redrawn
from a seed; GLM-4-MoE at G 12 and GraniteMoE at G 3, head_dim 64, take
the paged kernel's branch), fp32 logits at atol=2e-3, rtol=1e-3 with
greedy tokens identical, and the ragged engine's streams equal to the
JAX engine's."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from test_torch_contrib_moe import (GROUPS, NAMES, VARIANTS, _no_tf32,  # noqa: F401
                                    assert_logits_close, ckpts, make_apps)
from test_torch_dense_families import ids_of
from test_torch_serving_engine import _serve

PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
RNG = np.random.default_rng(41)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (11, 23, 30)]


@pytest.mark.parametrize("name", NAMES)
def test_paged_logits_and_ragged_streams_match_jax(ckpts, name,
                                                   monkeypatch):
    """The paged app's ``generate`` gives JAX's logits and greedy tokens;
    three requests through a batch of two on the ragged engine (prefill
    chunks of 16) give the JAX engine's streams. At head_dim 64 every
    layer's T = 1 step reaches the paged kernel's wrapper at the variant's
    group (12 or 3)."""
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
    g = GROUPS.get(name)
    layers = VARIANTS[name][2]["num_hidden_layers"]
    assert calls == ({(i, g) for i in range(layers)} if g else set())
