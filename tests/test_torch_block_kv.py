"""The port's paged KV cache against the JAX package's: the host allocator
and manager run the same scripted sequence and end in the same state; the
device ops write, read and gather the same values (exactly: they move
data, no arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import block_kv_cache as jbkv
from neuronx_distributed_inference_tpu.resilience.errors import \
    CapacityError as JCapacityError
from neuronx_distributed_inference_tpu_torch.modules import \
    block_kv_cache as tbkv
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    CapacityError as TCapacityError

BS = 8


def _prompts():
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 1000, size=32).tolist()
    return {
        "a": shared + rng.integers(1, 1000, size=8).tolist(),   # 5 blocks
        "b": shared + rng.integers(1, 1000, size=13).tolist(),  # hit 4
        "c": rng.integers(1, 1000, size=20).tolist(),
        "big": rng.integers(1, 1000, size=56).tolist(),
    }


def _alloc_state(a):
    return dict(free_list=list(a.free_list), lru=list(a._lru),
                hash_to_block=dict(a.hash_to_block),
                refs={k: (m.ref_count, m.content_hash)
                      for k, m in a.meta.items()})


def _run_allocator_script(alloc, capacity_error):
    """allocate / extend / prefix-hit / free / re-admit / evict /
    invalidate; returns every observable result in order."""
    p = _prompts()
    log = []
    blocks_a, hit = alloc.allocate(p["a"])
    log.append(("a", list(blocks_a), hit))
    alloc.extend(blocks_a, 45)
    log.append(("a+", list(blocks_a)))
    blocks_b, hit = alloc.allocate(p["b"])
    log.append(("b", list(blocks_b), hit))
    log.append(("probe", alloc.probe(p["a"])))
    alloc.free(blocks_a)
    log.append(("free_a", alloc.num_free))
    blocks_a2, hit = alloc.allocate(p["a"])          # re-admit: full hits
    log.append(("a2", list(blocks_a2), hit))
    blocks_c, hit = alloc.allocate(p["c"])
    log.append(("c", list(blocks_c), hit))
    alloc.invalidate(blocks_c[1:])
    alloc.free(blocks_c[:1])
    alloc.free(blocks_b)
    try:
        alloc.allocate(p["big"] * 3)                  # pool too small
        log.append(("big", "fit"))
    except capacity_error:
        log.append(("big", "capacity"))
    blocks_big, hit = alloc.allocate(p["big"])       # evicts LRU blocks
    log.append(("big2", list(blocks_big), hit))
    log.append(("probe_b", alloc.probe(p["b"])))
    return log


def test_block_allocators_end_in_equal_state():
    ja = jbkv.BlockAllocator(20, BS, True)
    ta = tbkv.BlockAllocator(20, BS, True)
    jlog = _run_allocator_script(ja, JCapacityError)
    tlog = _run_allocator_script(ta, TCapacityError)
    assert tlog == jlog
    assert _alloc_state(ta) == _alloc_state(ja)


def _run_manager_script(mgr, capacity_error):
    p = _prompts()
    log = []
    log.append(mgr.begin_sequence(0, p["a"]))
    log.append(mgr.begin_sequence(1, p["b"]))
    for _ in range(9):
        mgr.grow(0)
    mgr.grow(1, 4)
    mgr.shrink(1, 2)
    log.append(mgr.block_table_array([0, 1], 8).tolist())
    mgr.end_sequence(0)
    log.append(mgr.begin_sequence(2, p["a"]))          # prefix re-admit
    log.append(mgr.begin_sequence(3, p["c"]))
    mgr.abort_sequence(3)                               # never written
    log.append(mgr.probe_cached_tokens(p["c"]))
    try:
        mgr.begin_sequence(4, p["big"] * 4)
    except capacity_error:
        log.append("capacity")
    out = np.zeros((3, 8), np.int32)
    counts = [0, 0, 0]
    mgr.fill_block_table(out, [1, 2, 9], counts)
    log.append((out.tolist(), counts))
    log.append((dict(mgr.tables), dict(mgr.lens), dict(mgr._hit_blocks),
                mgr.max_blocks_per_seq))
    return log


def test_block_kv_managers_end_in_equal_state(monkeypatch):
    # the JAX manager prefers its C++ allocator; compare against the
    # Python one that the port copies
    monkeypatch.setenv("NXDI_TPU_NATIVE", "0")
    kw = dict(num_layers=2, num_blocks=24, block_size=BS, num_kv_heads=2,
              head_dim=16)
    jm = jbkv.BlockKVCacheManager(jbkv.BlockKVSpec(dtype=jnp.float32, **kw))
    tm = tbkv.BlockKVCacheManager(
        tbkv.BlockKVSpec(dtype=torch.float32, **kw), torch.device("cpu"))
    assert isinstance(jm.allocator, jbkv.BlockAllocator)
    assert tuple(tm.cache["k"].shape) == tuple(jm.cache["k"].shape)
    assert _run_manager_script(tm, TCapacityError) == \
        _run_manager_script(jm, JCapacityError)
    assert _alloc_state(tm.allocator) == _alloc_state(jm.allocator)


def test_write_slots_negative_slot_writes_nothing(rng):
    """Slot -1 must not wrap onto the last (live) slot: both packages drop
    it, and every other slot lands where JAX puts it."""
    L, n, h, d = 2, 5, 2, 4
    cache = rng.standard_normal((L, n, BS, h, d)).astype(np.float32)
    new = rng.standard_normal((2, 3, h, d)).astype(np.float32)
    slots = np.array([[9, -1, 17], [-1, -1, n * BS - 2]], np.int32)
    for layer in range(L):
        want = np.asarray(jbkv.write_slots_at_layer(
            jnp.asarray(cache), jnp.asarray(new), layer, jnp.asarray(slots)))
        got = torch.from_numpy(cache.copy())
        tbkv.write_slots_at_layer(got, torch.from_numpy(new), layer,
                                  torch.from_numpy(slots))
        np.testing.assert_array_equal(got.numpy(), want)
        flat = got.numpy().reshape(L, n * BS, h, d)
        np.testing.assert_array_equal(
            flat[layer, -1], cache.reshape(L, n * BS, h, d)[layer, -1])
    # all-negative (the warm-up / repad rows) leaves the cache bit-identical
    got = torch.from_numpy(cache.copy())
    tbkv.write_slots_at_layer(got, torch.from_numpy(new), 1,
                              torch.full((2, 3), -1, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), cache)


def test_gather_read_and_slot_helpers_match(rng):
    L, n, h, d = 3, 9, 2, 4
    cache = rng.standard_normal((L, n, BS, h, d)).astype(np.float32)
    table = np.array([[3, 1, 0, 0], [8, 2, 5, 7]], np.int32)
    for layer in range(L):
        want = jbkv.gather_block_kv(jbkv.read_layer(jnp.asarray(cache),
                                                    layer),
                                    jnp.asarray(table))
        got = tbkv.gather_block_kv(tbkv.read_layer(torch.from_numpy(cache),
                                                   layer),
                                   torch.from_numpy(table))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = np.array([[0, 7, 8, -1], [31, 9, 16, 23]], np.int32)
    np.testing.assert_array_equal(tbkv.slots_from_table(table, pos, BS),
                                  jbkv.slots_from_table(table, pos, BS))
    real = np.abs(pos)
    a, b = np.zeros_like(real), np.zeros_like(real)
    tbkv.slots_from_table_into(a, table, real, BS)
    jbkv.slots_from_table_into(b, table, real, BS)
    np.testing.assert_array_equal(a, b)
    for unwritten in ({5}, {3, 8}, set()):
        assert tbkv.cut_cached_at_unwritten([8, 2, 5, 7], 32, BS,
                                            unwritten) == \
            jbkv.cut_cached_at_unwritten([8, 2, 5, 7], 32, BS, unwritten)


@pytest.mark.parametrize("prefix", [True, False])
def test_allocator_without_prefix_caching(prefix):
    ja = jbkv.BlockAllocator(12, BS, prefix)
    ta = tbkv.BlockAllocator(12, BS, prefix)
    p = _prompts()["a"]
    for alloc in (ja, ta):
        first, _ = alloc.allocate(p)
        alloc.free(first)
    assert ta.allocate(p) == ja.allocate(p)
    assert _alloc_state(ta) == _alloc_state(ja)
