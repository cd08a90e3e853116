"""The contiguous KV cache writes and reads of the port against the JAX
package's (modules/kv_cache.py), bit for bit: the same random cache and
tokens from a numpy seed go through both; the port writes in place, JAX
returns a new array. Exact equality: the writes only move values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import kv_cache as jkv
from neuronx_distributed_inference_tpu_torch.modules import kv_cache as tkv

L, B, H, D, S = 2, 3, 2, 8, 16


def _cache(rng, k_transposed):
    shape = (L, B, H, D, S) if k_transposed else (L, B, H, S, D)
    return rng.standard_normal(shape).astype(np.float32)


def _both(fn_j, fn_t, cache, *args, **kw):
    want = np.asarray(fn_j(jnp.asarray(cache),
                           *(jnp.asarray(a) if isinstance(a, np.ndarray)
                             else a for a in args), **kw))
    t = torch.from_numpy(cache.copy())
    out = fn_t(t, *(torch.from_numpy(a) if isinstance(a, np.ndarray)
                    else a for a in args), **kw)
    assert out is t                      # written in place
    return t.numpy(), want


@pytest.mark.parametrize("k_transposed", [True, False])
@pytest.mark.parametrize("seq_ids,identity", [((0, 1, 2), True),
                                              ((2, 0), False)])
def test_write_prefill_at_layer(k_transposed, seq_ids, identity):
    rng = np.random.default_rng(0)
    cache = _cache(rng, k_transposed)
    b = len(seq_ids)
    new = rng.standard_normal((b, 10, H, D)).astype(np.float32)
    got, want = _both(jkv.write_prefill_at_layer, tkv.write_prefill_at_layer,
                      cache, new, 1, np.asarray(seq_ids, np.int32),
                      identity_seq_ids=identity, k_transposed=k_transposed)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, cache)


@pytest.mark.parametrize("k_transposed", [True, False])
@pytest.mark.parametrize("positions", [[[-1], [S], [5]],          # decode
                                       [[-1, 0, S], [3, -S - 1, 15],
                                        [S - 1, 4, -2]]])        # scatter
def test_write_tokens_at_layer_drop_semantics(k_transposed, positions):
    """A single-token write drops -1 and S (the decode path writes the old
    value back); a multi-token write wraps [-S, 0) onto S + p and drops
    the rest (the scatter's index normalisation, mode="drop")."""
    rng = np.random.default_rng(1)
    cache = _cache(rng, k_transposed)
    pos = np.asarray(positions, np.int32)
    new = rng.standard_normal((B, pos.shape[1], H, D)).astype(np.float32)
    got, want = _both(jkv.write_tokens_at_layer, tkv.write_tokens_at_layer,
                      cache, new, 0, np.asarray([2, 0, 1], np.int32), pos,
                      k_transposed=k_transposed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k_transposed", [True, False])
def test_commit_chunk_keeps_a_straddling_row(k_transposed):
    """Rows whose chunk fits are written; a row whose chunk would cross
    the end (start 14, C 4) and a negative start keep their old values."""
    rng = np.random.default_rng(2)
    cache = _cache(rng, k_transposed)
    c = 4
    shape = (L, B, H, D, c) if k_transposed else (L, B, H, c, D)
    side = rng.standard_normal(shape).astype(np.float32)
    for starts in ([0, 5, 12], [14, 3, -1]):
        got, want = _both(jkv.commit_chunk, tkv.commit_chunk, cache, side,
                          np.asarray([1, 2, 0], np.int32),
                          np.asarray(starts, np.int32),
                          k_transposed=k_transposed)
        np.testing.assert_array_equal(got, want)


def test_reads_match_jax():
    rng = np.random.default_rng(3)
    cache = _cache(rng, False)
    ids = np.asarray([2, 0], np.int32)
    hl = tkv.read_layer_hl(torch.from_numpy(cache), 1)
    np.testing.assert_array_equal(
        hl.numpy(), np.asarray(jkv.read_layer_hl(jnp.asarray(cache), 1)))
    np.testing.assert_array_equal(
        tkv.read_layer(torch.from_numpy(cache), 1).numpy(),
        np.asarray(jkv.read_layer(jnp.asarray(cache), 1)))
    np.testing.assert_array_equal(
        tkv.gather_cache_rows(hl, torch.from_numpy(ids)).numpy(),
        np.asarray(jkv.gather_cache_rows(jnp.asarray(cache[1]),
                                         jnp.asarray(ids))))


def test_init_cache_layout():
    spec = tkv.KVCacheSpec(num_layers=L, batch_size=B, max_seq_len=S,
                           num_kv_heads=H, head_dim=D, dtype=torch.float32)
    jspec = jkv.KVCacheSpec(num_layers=L, batch_size=B, max_seq_len=S,
                            num_kv_heads=H, head_dim=D, dtype=jnp.float32)
    mgr = tkv.KVCacheManager(spec, torch.device("cpu"))
    assert tuple(mgr.cache["k"].shape) == jspec.k_shape
    assert tuple(mgr.cache["v"].shape) == jspec.v_shape
    assert tkv.cache_len_of(mgr.cache) == S
    assert mgr.nbytes == 2 * L * B * H * D * S * 4
    mgr.cache["k"].fill_(1.0)
    mgr.reset()
    assert not mgr.cache["k"].any()
