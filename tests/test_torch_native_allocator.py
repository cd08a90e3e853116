"""The port's C++ block allocator (``native/block_allocator.cpp``, its own
copy with a salt seed) and the block manager's host side
(``modules/block_kv_cache.py``: ``NativeBlockAllocator``,
``make_block_allocator``, the eviction hook, telemetry, the
``paged_alloc`` fault point, ``set_spill_hook``) against the port's
Python allocator and the JAX package's.

A seeded random workload of allocate / extend / probe / free / invalidate
over a small pool (so it evicts and runs dry) gives identical block ids,
cached counts and failures on all three at salt b"", with and without
prefix caching; with salts, native and the port's Python allocator agree
op for op and distinct salts never share a block. Exact comparisons."""

import logging

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import block_kv_cache as jbkv
from neuronx_distributed_inference_tpu.resilience.errors import \
    CapacityError as JCapacityError
from neuronx_distributed_inference_tpu_torch import native, telemetry
from neuronx_distributed_inference_tpu_torch.modules import \
    block_kv_cache as tbkv
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, CapacityError, ConfigurationError, KVCacheStateError)
from neuronx_distributed_inference_tpu_torch.telemetry import \
    metrics as tmetrics

BS = 4
SALTS = (b"", b"lora:1:1", b"lora-adapter:l0")


@pytest.fixture
def fresh_native(monkeypatch):
    """The native module with nothing loaded (restored afterwards)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "load_error", None)
    return native


def _workload(seed, n_ops=400, salts=(b"",)):
    """A seeded op list over shared prefixes (so prompts hit, evict and
    run the pool dry). Ops name sequences by index."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 60, size=int(n)).tolist()
             for n in rng.integers(4, 24, size=6)]
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            stem = stems[rng.integers(len(stems))]
            tail = rng.integers(1, 60, size=int(rng.integers(0, 9))).tolist()
            salt = salts[rng.integers(len(salts))]
            ops.append(("allocate", stem + tail, salt))
        elif r < 0.6:
            ops.append(("extend", int(rng.integers(1, 9))))
        elif r < 0.7:
            stem = stems[rng.integers(len(stems))]
            ops.append(("probe", stem, salts[rng.integers(len(salts))]))
        elif r < 0.9:
            ops.append(("free",))
        else:
            ops.append(("invalidate",))
    return ops


def _replay(alloc, ops, oom, salted=True, seed=0):
    """Run ``ops`` on ``alloc``; returns every observable result."""
    rng = np.random.default_rng(seed)
    live = []                      # [blocks, length]
    log = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "allocate":
                args = (op[1], op[2]) if salted else (op[1],)
                blocks, cached = alloc.allocate(*args)
                live.append([blocks, len(op[1])])
                log.append(("a", list(blocks), int(cached)))
            elif kind == "extend" and live:
                seq = live[int(rng.integers(len(live)))]
                seq[1] += op[1]
                seq[0] = alloc.extend(list(seq[0]), seq[1])
                log.append(("e", list(seq[0])))
            elif kind == "probe":
                args = (op[1], op[2]) if salted else (op[1],)
                cached, blocks = alloc.probe(*args)
                log.append(("p", int(cached), list(blocks)))
            elif kind in ("free", "invalidate") and live:
                seq = live.pop(int(rng.integers(len(live))))
                getattr(alloc, kind)(seq[0])
                log.append((kind[0],))
        except oom:
            if kind == "extend":
                seq[1] -= op[1]
            log.append(("oom", kind))
        log.append(("n", int(alloc.num_free)))
    return log


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "noprefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_python_and_reference_agree(prefix, seed):
    """At salt b"": native, the port's Python allocator and the JAX
    package's Python allocator give identical block ids, cached counts,
    probes, failures and free counts."""
    ops = _workload(seed)
    nat = tbkv.NativeBlockAllocator(24, BS, prefix)
    py = tbkv.BlockAllocator(24, BS, prefix)
    ref = jbkv.BlockAllocator(24, BS, prefix)
    got = _replay(nat, ops, CapacityError, seed=seed)
    assert got == _replay(py, ops, CapacityError, seed=seed)
    assert got == _replay(ref, ops, JCapacityError, salted=False, seed=seed)
    assert any(e[0] == "oom" for e in got)          # the pool ran dry
    if prefix:
        assert any(e[0] == "a" and e[2] > 0 for e in got)   # prefix hits


def test_salted_chains_agree_and_never_share():
    """With salts, native and Python agree op for op; a prompt allocated
    under each salt in turn takes no block of another salt's."""
    ops = _workload(5, salts=SALTS)
    nat = tbkv.NativeBlockAllocator(24, BS)
    py = tbkv.BlockAllocator(24, BS)
    got = _replay(nat, ops, CapacityError, seed=5)
    assert got == _replay(py, ops, CapacityError, seed=5)
    prompt = list(range(1, 13))                      # three full blocks
    for alloc in (tbkv.NativeBlockAllocator(40, BS),
                  tbkv.BlockAllocator(40, BS)):
        seen = {}
        for salt in SALTS:
            blocks, cached = alloc.allocate(prompt, salt)
            assert cached == 0, salt                 # nothing shared
            alloc.free(blocks)
            seen[salt] = blocks
        for salt in SALTS:                           # each hits its own
            assert alloc.probe(prompt, salt) == (12, seen[salt])
            assert alloc.allocate(prompt, salt) == (seen[salt], 12)
        assert len({b for v in seen.values() for b in v}) == 9


@pytest.mark.parametrize("kind", ["native", "python"])
def test_probe_lru_eviction_oom_and_double_free(kind):
    cls = (tbkv.NativeBlockAllocator if kind == "native"
           else tbkv.BlockAllocator)
    a = cls(5, BS)                                   # 4 usable blocks
    p1, p2 = [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9, 9, 8, 8, 8, 8]
    b1, _ = a.allocate(p1)
    assert a.probe(p1) == (8, b1) and a.num_free == 2
    a.free(b1)                                       # hashed: LRU-resident
    assert a.num_free == 4 and a.probe(p1)[0] == 8
    b2, _ = a.allocate(p2)                           # takes the free list
    b3, _ = a.allocate([7] * 4)                      # evicts p1's first
    assert b3 == [b1[0]] and a.probe(p1) == (0, [])
    with pytest.raises(CapacityError):
        a.allocate(list(range(20, 32)))              # 3 blocks, 1 left
    assert a.num_free == 1                           # rolled back
    with pytest.raises(CapacityError):
        a.extend(list(b2), 16)
    a.free(b2)
    with pytest.raises(KVCacheStateError):
        a.free(b2)
    a.enable_prefix_caching = False                  # cold_prefix's switch
    assert a.probe(p2) == (0, [])
    assert a.allocate(p2)[1] == 0
    a.enable_prefix_caching = True
    assert a.enable_prefix_caching and a.probe(p2) == (0, [])


def test_make_block_allocator_prefers_native(monkeypatch, fresh_native,
                                             caplog):
    """Native by default; Python under NXDI_TPU_NATIVE=0; Python with a
    warning when the library does not build (a bad flag here). The
    library name follows the source and the flags."""
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and "libnxdi_native-" in path
    assert tbkv.make_block_allocator(8, BS).kind == "native"
    monkeypatch.setenv("NXDI_TPU_NATIVE", "0")
    assert type(tbkv.make_block_allocator(8, BS)) is tbkv.BlockAllocator
    monkeypatch.delenv("NXDI_TPU_NATIVE")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX_FLAGS", ["--no-such-flag"])
    assert native.library_path() != path
    with caplog.at_level(logging.WARNING, logger="nxdi_tpu"):
        alloc = tbkv.make_block_allocator(8, BS)
    assert alloc.kind == "python" and native.load_error
    assert "native block allocator unavailable" in caplog.text
    with pytest.raises(ImportError):
        tbkv.NativeBlockAllocator(8, BS)


def _manager(**kw):
    return tbkv.BlockKVCacheManager(
        tbkv.BlockKVSpec(num_layers=1, num_blocks=9, block_size=BS,
                         num_kv_heads=1, head_dim=2, dtype=torch.float32),
        torch.device("cpu"), **kw)


def test_set_spill_hook_swaps_only_when_nothing_is_live():
    """A native allocator is swapped for a Python one while nothing is
    live; with a live table the hook raises, the allocator unchanged. The
    hook then sees each evicted block with its salted chain hash."""
    mgr = _manager()
    assert mgr.allocator_kind == "native"
    mgr.begin_sequence(0, list(range(8)))
    with pytest.raises(ConfigurationError):
        mgr.set_spill_hook(lambda b, h: None)
    assert mgr.allocator_kind == "native"
    mgr.end_sequence(0)            # blocks LRU-resident, nothing live
    seen = []
    mgr.set_spill_hook(lambda b, h: seen.append((b, h)))
    assert mgr.allocator_kind == "python"
    blocks, _ = mgr.begin_sequence(1, list(range(8)), salt=b"s")
    mgr.end_sequence(1)
    mgr.begin_sequence(2, list(range(100, 132)))   # the whole pool
    want = tbkv._hash_block(b"s", list(range(4)))
    assert seen[0] == (blocks[0], want)
    assert [b for b, _ in seen] == blocks
    mgr.end_sequence(2)
    mgr.set_spill_hook(None)       # a Python allocator keeps its state
    assert mgr.allocator_kind == "python" and mgr.allocator.on_evict is None


def test_manager_telemetry_and_paged_alloc_fault():
    """The occupancy gauges, the failure and prefix-hit counters, and the
    ``paged_alloc`` fault point in begin_sequence and grow (state rolled
    back), as the reference's manager."""
    reg = telemetry.enable()
    try:
        mgr = _manager()
        total = reg.get(tmetrics.KV_BLOCKS_TOTAL).get()
        assert total == 8
        mgr.begin_sequence(0, list(range(8)))
        assert reg.get(tmetrics.KV_BLOCKS_IN_USE).get() == 2
        mgr.end_sequence(0)
        mgr.begin_sequence(1, list(range(9)))
        hits = tmetrics.prefix_hit_tokens_counter(reg).get()
        assert hits == 8
        with FAULTS.inject("paged_alloc"):
            with pytest.raises(CapacityError):
                mgr.begin_sequence(2, [1, 2])
        with FAULTS.inject("paged_alloc"):
            with pytest.raises(CapacityError):
                mgr.grow(1, 4)
        assert mgr.lens[1] == 9 and len(mgr.tables[1]) == 3
        assert 2 not in mgr.tables
        assert tmetrics.kv_alloc_failures_counter(reg).get() == 2
        mgr.end_sequence(1)
        assert reg.get(tmetrics.KV_BLOCKS_IN_USE).get() == 0
    finally:
        telemetry.disable()
