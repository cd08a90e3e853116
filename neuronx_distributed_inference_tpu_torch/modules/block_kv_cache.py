"""Paged (block) KV cache (counterpart:
``neuronx_distributed_inference_tpu/modules/block_kv_cache.py`` —
``BlockKVSpec``/``init_block_cache`` :47-75, the in-graph ops :81-127, the
host slot-mapping helpers :134-170, ``BlockAllocator`` with blake2b prefix
hashing :177-344, ``NativeBlockAllocator`` :346-428,
``make_block_allocator`` :431-439, ``BlockKVCacheManager`` :442-639).

Device layout: k, v : (num_layers, num_blocks, block_size, num_kv_heads,
head_dim). Block 0 is the NULL block: it is never allocated, block-table
entries 0 point at it, and slot_mapping entries < 0 write nothing.

Unlike the JAX functions, which return an updated cache, the port writes
the cache IN PLACE (the JAX application donated the buffers, so every step
was already a destructive update).

The host side is the counterpart's: the manager's telemetry (block
occupancy gauges, the ``kv_alloc_failures`` and ``prefix_hit_tokens``
counters), its ``paged_alloc`` fault point and its spill hook (the
host-RAM tier of ``serving/fleet/kv_tier.py``), and the C++ allocator
(the port's own copy, ``native/block_allocator.cpp``) preferred over the
Python one. One difference: a salt seeds every hash chain (the LoRA
adapter whose KV a block holds; b"" is the counterpart's chain), in both
allocators.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..resilience.errors import (CapacityError, ConfigurationError,
                                 KVCacheStateError)
from ..resilience.faults import FAULTS as _FAULTS
from ..telemetry import get_registry
from ..telemetry import metrics as tmetrics

logger = logging.getLogger("nxdi_tpu")


@dataclass(frozen=True)
class BlockKVSpec:
    num_layers: int
    num_blocks: int            # includes the reserved null block 0
    block_size: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.num_blocks, self.block_size,
                self.num_kv_heads, self.head_dim)

    def blocks_for(self, seq_len: int) -> int:
        return -(-seq_len // self.block_size)


def init_block_cache(spec: BlockKVSpec,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros(spec.shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(spec.shape, dtype=spec.dtype, device=device)}


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------

def write_slots_at_layer(cache: torch.Tensor, new: torch.Tensor, layer: int,
                         slot_mapping: torch.Tensor) -> None:
    """Write tokens IN PLACE into the stacked cache (L, N, Bs, H, D) at
    ``layer``: new (B, T, H, D); slot_mapping (B, T) flat slot ids
    (block * block_size + offset).

    Negative slots write nothing. A negative index would wrap onto a live
    slot, and filtering them out would sync the host with the device, so
    each one is aimed at slot 0 (the never-allocated null block) carrying
    the value slot 0 already holds. An fp8 cache is written through its
    uint8 view (``index_copy_`` has no fp8 kernel)."""
    L, n, bs, h, d = cache.shape
    flat = cache.view(L, n * bs, h, d)[layer]
    slots = slot_mapping.reshape(-1).to(device=cache.device,
                                        dtype=torch.long)
    vals = new.reshape(-1, h, d).to(cache.dtype)
    if cache.is_floating_point() and cache.element_size() == 1:
        flat, vals = flat.view(torch.uint8), vals.view(torch.uint8)
    drop = slots < 0
    slots = slots.masked_fill(drop, 0)
    vals = torch.where(drop[:, None, None], flat[0].expand_as(vals), vals)
    flat.index_copy_(0, slots, vals)


def read_layer(cache: torch.Tensor, layer: int) -> torch.Tensor:
    """One layer (N, Bs, H, D) of the stacked paged cache (a view)."""
    return cache[layer]


def gather_block_kv(cache_layer: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """Per-request contiguous KV from the block table: cache_layer
    (N, Bs, H, D); block_table (B, max_blocks) → (B, max_blocks*Bs, H, D).
    Table entries 0 read the null block (masked out by position)."""
    g = cache_layer[block_table.long()]
    b, mb, bs, h, d = g.shape
    return g.reshape(b, mb * bs, h, d)


# ---------------------------------------------------------------------------
# Host-side slot-mapping construction
# ---------------------------------------------------------------------------

def slots_from_table(block_table: np.ndarray, positions: np.ndarray,
                     block_size: int) -> np.ndarray:
    """positions (B, T) in-sequence token positions -> flat slot ids (B, T)
    using each row's block table. Negative positions stay negative (drop)."""
    blk_idx = positions // block_size
    offs = positions % block_size
    blocks = np.take_along_axis(
        np.asarray(block_table), np.maximum(blk_idx, 0), axis=1)
    slots = blocks * block_size + offs
    return np.where(positions < 0, -1, slots).astype(np.int32)


def cut_cached_at_unwritten(blocks: Sequence[int], cached_tokens: int,
                            block_size: int, unwritten) -> int:
    """Clamp a prefix-cache hit at the first block whose contents are not
    fully written yet (a sibling's or an in-flight chunked prefill's block);
    recomputing a shared block writes identical values, so the cut is
    always safe. ``unwritten`` is any container of block ids."""
    for bi in range(cached_tokens // block_size):
        if blocks[bi] in unwritten:
            return bi * block_size
    return cached_tokens


def slots_from_table_into(out: np.ndarray, block_table: np.ndarray,
                          positions: np.ndarray, block_size: int) -> None:
    """In-place :func:`slots_from_table` for the adapter's per-step scratch
    buffers (positions here are always real)."""
    np.floor_divide(positions, block_size, out=out)
    out[:] = np.take_along_axis(block_table, out, axis=1)
    out *= block_size
    out += positions % block_size


# ---------------------------------------------------------------------------
# Block allocator + prefix cache (host)
# ---------------------------------------------------------------------------

def _hash_block(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


@dataclass
class _BlockMeta:
    ref_count: int = 0
    content_hash: Optional[bytes] = None   # set only for FULL blocks


class BlockAllocator:
    """Free-list block allocator with content-hash prefix caching.

    * ``allocate(seq)`` returns (block_ids, num_cached_tokens): full prompt
      blocks whose chained content hash is already resident are reused
      (ref_count++) and need no recompute; the remainder are fresh blocks.
    * ``free(block_ids)`` decrements refs; hashed blocks stay resident until
      evicted LRU when the free list runs dry.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.num_blocks = num_blocks
        self.meta: Dict[int, _BlockMeta] = {
            i: _BlockMeta() for i in range(1, num_blocks)}
        self.free_list: List[int] = list(range(1, num_blocks))
        self.hash_to_block: Dict[bytes, int] = {}
        self._lru: List[int] = []          # hashed, ref_count==0, oldest first
        # eviction hook (the host-RAM KV spill tier, serving/fleet/): called
        # with (block_id, salted chain hash) just BEFORE an LRU-resident
        # block's hash is dropped, the last moment its device payload is
        # still named by its content
        self.on_evict = None

    kind = "python"

    @property
    def num_free(self) -> int:
        return len(self.free_list) + len(self._lru)

    def _pop_block(self) -> int:
        if self.free_list:
            return self.free_list.pop()
        if self._lru:
            blk = self._lru.pop(0)
            h = self.meta[blk].content_hash
            if h is not None:
                if self.on_evict is not None:
                    self.on_evict(blk, h)
                self.hash_to_block.pop(h, None)
            self.meta[blk] = _BlockMeta()
            return blk
        raise CapacityError("out of KV cache blocks")

    def allocate(self, token_ids: Sequence[int], salt: bytes = b""
                 ) -> Tuple[List[int], int]:
        """Allocate blocks for a prompt. Returns (block_ids, cached_tokens).
        On OOM this call's partial allocations are rolled back. ``salt``
        seeds the hash chain: prompts match only under the same salt (the
        LoRA adapter whose KV the blocks hold; b"" is the reference's
        chain)."""
        n_blocks = max(1, -(-len(token_ids) // self.block_size))
        blocks: List[int] = []
        cached_tokens = 0
        parent = salt
        matching = self.enable_prefix_caching
        for bi in range(n_blocks):
            chunk = token_ids[bi * self.block_size:(bi + 1) * self.block_size]
            full = len(chunk) == self.block_size
            h = _hash_block(parent, chunk) if (matching and full) else None
            if h is not None and h in self.hash_to_block:
                blk = self.hash_to_block[h]
                m = self.meta[blk]
                if m.ref_count == 0 and blk in self._lru:
                    self._lru.remove(blk)
                m.ref_count += 1
                blocks.append(blk)
                cached_tokens += self.block_size
                parent = h
                continue
            matching = False
            try:
                blk = self._pop_block()
            except CapacityError:
                n_hit = cached_tokens // self.block_size
                self.free(blocks[:n_hit])
                self.invalidate(blocks[n_hit:])
                raise
            m = self.meta[blk]
            m.ref_count += 1
            if self.enable_prefix_caching and full:
                hh = _hash_block(parent, chunk)
                m.content_hash = hh
                self.hash_to_block[hh] = blk
                parent = hh
            blocks.append(blk)
        return blocks, cached_tokens

    def probe(self, token_ids: Sequence[int], salt: bytes = b""
              ) -> Tuple[int, List[int]]:
        """READ-ONLY prefix-warmth probe: (cached_tokens, hit block ids)
        that :meth:`allocate` would serve from the prefix cache now."""
        if not self.enable_prefix_caching:
            return 0, []
        parent = salt
        blocks: List[int] = []
        cached = 0
        for bi in range(len(token_ids) // self.block_size):
            chunk = token_ids[bi * self.block_size:
                              (bi + 1) * self.block_size]
            parent = _hash_block(parent, chunk)
            blk = self.hash_to_block.get(parent)
            if blk is None:
                break
            blocks.append(blk)
            cached += self.block_size
        return cached, blocks

    def extend(self, blocks: List[int], new_len: int) -> List[int]:
        """Grow a running sequence's block list to cover ``new_len`` tokens.
        On OOM the blocks added by this call are rolled back."""
        need = max(1, -(-new_len // self.block_size))
        added: List[int] = []
        while len(blocks) + len(added) < need:
            try:
                blk = self._pop_block()
            except CapacityError:
                self.free(added)
                raise
            self.meta[blk].ref_count += 1
            added.append(blk)
        blocks.extend(added)
        return blocks

    def free(self, blocks: Sequence[int]):
        for blk in blocks:
            m = self.meta[blk]
            m.ref_count -= 1
            if m.ref_count < 0:
                raise KVCacheStateError(f"double free of block {blk}")
            if m.ref_count == 0:
                if m.content_hash is not None:
                    self._lru.append(blk)
                else:
                    self.free_list.append(blk)

    def invalidate(self, blocks: Sequence[int]):
        """Free blocks whose pending content was never written: drop their
        hash registration once unreferenced so the prefix cache can never
        serve them."""
        for blk in blocks:
            m = self.meta[blk]
            m.ref_count -= 1
            if m.ref_count < 0:
                raise KVCacheStateError(f"double free of block {blk}")
            if m.ref_count == 0:
                if m.content_hash is not None:
                    if self.hash_to_block.get(m.content_hash) == blk:
                        del self.hash_to_block[m.content_hash]
                    m.content_hash = None
                self.free_list.append(blk)


class NativeBlockAllocator:
    """ctypes wrapper over the C++ allocator (``native/block_allocator.cpp``):
    the interface of :class:`BlockAllocator` and its block ids. Its chain
    hashes are 64-bit FNV-1a, not blake2b, so it has no eviction hook
    (:meth:`BlockKVCacheManager.set_spill_hook` swaps it out)."""

    kind = "native"

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self._lib = native.load_library()
        if self._lib is None:
            raise ImportError("native library unavailable: "
                              f"{native.load_error or 'NXDI_TPU_NATIVE=0'}")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self._prefix = bool(enable_prefix_caching)
        self._h = self._lib.nxdi_alloc_create(num_blocks, block_size,
                                              int(self._prefix))

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.nxdi_alloc_destroy(h)
            self._h = None

    @property
    def enable_prefix_caching(self) -> bool:
        return self._prefix

    @enable_prefix_caching.setter
    def enable_prefix_caching(self, on: bool) -> None:
        self._prefix = bool(on)
        self._lib.nxdi_alloc_set_prefix_caching(self._h, int(self._prefix))

    @property
    def num_free(self) -> int:
        return self._lib.nxdi_alloc_num_free(self._h)

    @staticmethod
    def _tokens(token_ids):
        toks = np.ascontiguousarray(np.asarray(token_ids, np.int64))
        return toks, toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def allocate(self, token_ids: Sequence[int], salt: bytes = b""
                 ) -> Tuple[List[int], int]:
        toks, ptr = self._tokens(token_ids)
        max_out = max(1, -(-len(toks) // self.block_size))
        out = (ctypes.c_int * max_out)()
        cached = ctypes.c_int(0)
        n = self._lib.nxdi_alloc_allocate_salted(
            self._h, ptr, len(toks), out, max_out, ctypes.byref(cached),
            salt, len(salt))
        if n < 0:
            raise CapacityError("out of KV cache blocks")
        return list(out[:n]), int(cached.value)

    def probe(self, token_ids: Sequence[int], salt: bytes = b""
              ) -> Tuple[int, List[int]]:
        if not self._prefix:
            return 0, []
        toks, ptr = self._tokens(token_ids)
        max_out = max(1, len(toks) // self.block_size)
        out = (ctypes.c_int * max_out)()
        cached = self._lib.nxdi_alloc_probe_salted(
            self._h, ptr, len(toks), out, max_out, salt, len(salt))
        return int(cached), list(out[:cached // self.block_size])

    def extend(self, blocks: List[int], new_len: int) -> List[int]:
        need = max(1, -(-new_len // self.block_size), len(blocks))
        if need == len(blocks):        # covered: nothing to marshal
            return blocks
        buf = (ctypes.c_int * need)(*blocks)
        n = self._lib.nxdi_alloc_extend(self._h, buf, len(blocks), new_len,
                                        need)
        if n < 0:
            raise CapacityError("out of KV cache blocks")
        return list(buf[:n])

    def free(self, blocks: Sequence[int]):
        arr = (ctypes.c_int * len(blocks))(*blocks)
        if self._lib.nxdi_alloc_free(self._h, arr, len(blocks)) < 0:
            raise KVCacheStateError("double free of a KV block")

    def invalidate(self, blocks: Sequence[int]):
        arr = (ctypes.c_int * len(blocks))(*blocks)
        if self._lib.nxdi_alloc_invalidate(self._h, arr, len(blocks)) < 0:
            raise KVCacheStateError("double free of a KV block")


def make_block_allocator(num_blocks: int, block_size: int,
                         enable_prefix_caching: bool = True):
    """The C++ allocator, else the Python one: under ``NXDI_TPU_NATIVE=0``,
    or with a warning when the library did not build. The result's
    ``kind`` says which ("native" / "python")."""
    if native.native_enabled():
        if native.load_library() is not None:
            return NativeBlockAllocator(num_blocks, block_size,
                                        enable_prefix_caching)
        logger.warning("native block allocator unavailable (%s); using the "
                       "Python allocator", native.load_error)
    return BlockAllocator(num_blocks, block_size, enable_prefix_caching)


class BlockKVCacheManager:
    """Host-side owner: spec + cache tensors + allocator + per-seq block
    tables.

    Telemetry (host side, a no-op while the registry is disabled): the
    blocks in use and in total, allocation failures, prefix-hit tokens."""

    def __init__(self, spec: BlockKVSpec, device: torch.device,
                 enable_prefix_caching: bool = True):
        self.spec = spec
        self.cache = init_block_cache(spec, device)
        self.allocator = make_block_allocator(spec.num_blocks, spec.block_size,
                                              enable_prefix_caching)
        self.tables: Dict[int, List[int]] = {}     # seq_id -> block list
        self.lens: Dict[int, int] = {}
        self._hit_blocks: Dict[int, int] = {}      # leading prefix-HIT blocks
        self._tel_occupancy()

    @property
    def allocator_kind(self) -> str:
        """"native" (the C++ allocator) or "python"."""
        return self.allocator.kind

    @staticmethod
    def _tel_registry():
        reg = get_registry()
        return reg if reg.enabled else None

    def _tel_occupancy(self, reg=None):
        reg = reg if reg is not None else self._tel_registry()
        if reg is None:
            return
        usable = self.spec.num_blocks - 1          # null block excluded
        tmetrics.kv_blocks_total_gauge(reg).set(usable)
        # num_free counts the free list and unreferenced prefix-cached
        # residents; in use = blocks a live sequence still references
        tmetrics.kv_blocks_in_use_gauge(reg).set(
            usable - self.allocator.num_free)

    def begin_sequence(self, seq_id: int, token_ids: Sequence[int],
                       salt: bytes = b"") -> Tuple[List[int], int]:
        if seq_id in self.tables:      # stale table from an unreleased run
            self.end_sequence(seq_id)
        reg = self._tel_registry()
        try:
            if _FAULTS.active:
                _FAULTS.fire("paged_alloc")
            blocks, cached = self.allocator.allocate(token_ids, salt)
        except CapacityError:
            if reg is not None:
                tmetrics.kv_alloc_failures_counter(reg).inc()
            raise
        self.tables[seq_id] = blocks
        self.lens[seq_id] = len(token_ids)
        self._hit_blocks[seq_id] = cached // self.spec.block_size
        if reg is not None:
            if cached:
                tmetrics.prefix_hit_tokens_counter(reg).inc(cached)
            self._tel_occupancy(reg)
        return blocks, cached

    def grow(self, seq_id: int, n_new: int = 1) -> List[int]:
        self.lens[seq_id] += n_new
        try:
            if _FAULTS.active:
                _FAULTS.fire("paged_alloc")
            self.tables[seq_id] = self.allocator.extend(
                self.tables[seq_id], self.lens[seq_id])
        except CapacityError:
            self.lens[seq_id] -= n_new
            reg = self._tel_registry()
            if reg is not None:
                tmetrics.kv_alloc_failures_counter(reg).inc()
            raise
        self._tel_occupancy()
        return self.tables[seq_id]

    def shrink(self, seq_id: int, n_tokens: int = 1) -> List[int]:
        """Inverse of :meth:`grow`: forget the last ``n_tokens`` and free
        blocks no longer covered."""
        if seq_id not in self.tables:
            raise KVCacheStateError(f"shrink of unknown seq_id {seq_id}")
        new_len = self.lens[seq_id] - n_tokens
        if new_len < 0:
            raise KVCacheStateError(
                f"shrink below zero for seq_id {seq_id} "
                f"({self.lens[seq_id]} - {n_tokens})")
        need = max(1, self.spec.blocks_for(new_len))
        blocks = self.tables[seq_id]
        if len(blocks) > need:
            extra = blocks[need:]
            del blocks[need:]
            self.allocator.free(extra)
        self.lens[seq_id] = new_len
        self._tel_occupancy()
        return blocks

    def end_sequence(self, seq_id: int):
        self.allocator.free(self.tables.pop(seq_id))
        self.lens.pop(seq_id)
        self._hit_blocks.pop(seq_id, None)
        self._tel_occupancy()

    def abort_sequence(self, seq_id: int, unwritten=None):
        """End a sequence whose prefill never (fully) wrote its KV:
        prefix-HIT blocks are freed normally, fresh blocks invalidated so
        their never-written contents can never be served as prefix hits.
        ``unwritten`` overrides the hit/fresh split with an explicit
        container of block ids whose content never fully landed."""
        blocks = self.tables.pop(seq_id)
        n_hit = self._hit_blocks.pop(seq_id, 0)
        self.lens.pop(seq_id)
        if unwritten is None:
            self.allocator.free(blocks[:n_hit])
            self.allocator.invalidate(blocks[n_hit:])
        else:
            self.allocator.free([b for b in blocks if b not in unwritten])
            self.allocator.invalidate([b for b in blocks if b in unwritten])
        self._tel_occupancy()

    def set_spill_hook(self, hook) -> None:
        """Install ``hook(block_id, chain_hash)`` to run just before a
        prefix-cached block is LRU-evicted: the attach point of the
        host-RAM KV spill tier (``serving/fleet/kv_tier.py``).

        The hook is keyed by the Python allocator's blake2b chain hashes
        (those the tier and the handoff records use), so a native
        allocator is swapped for a fresh Python one, which is allowed only
        while nothing is live (no table, every block free): the swap may
        drop unreferenced prefix-cache residency, never a sequence's
        state. With live state it raises :class:`ConfigurationError`."""
        alloc = self.allocator
        if not isinstance(alloc, BlockAllocator):
            if self.tables or alloc.num_free != self.spec.num_blocks - 1:
                raise ConfigurationError(
                    "set_spill_hook needs the Python BlockAllocator's "
                    "eviction callback, and this manager's native "
                    "allocator holds live state: attach the spill tier "
                    "before the first admission (or set NXDI_TPU_NATIVE=0)")
            alloc = BlockAllocator(self.spec.num_blocks,
                                   self.spec.block_size,
                                   alloc.enable_prefix_caching)
            self.allocator = alloc
        alloc.on_evict = hook

    def probe_cached_tokens(self, token_ids: Sequence[int],
                            salt: bytes = b"") -> Tuple[int, List[int]]:
        return self.allocator.probe(list(token_ids), salt)

    def block_table_array(self, seq_ids: Sequence[int], max_blocks: int
                          ) -> np.ndarray:
        out = np.zeros((len(seq_ids), max_blocks), np.int32)
        for i, sid in enumerate(seq_ids):
            blks = self.tables.get(sid, [])[:max_blocks]
            out[i, :len(blks)] = blks
        return out

    def fill_block_table(self, out: np.ndarray, seq_ids: Sequence[int],
                         counts: List[int]) -> None:
        """Refresh a cached block-table array IN PLACE: rewrite only rows
        whose block count differs from the ``counts`` snapshot. Valid while
        tables only grow between calls (every path that shrinks a table
        drops its scratch)."""
        for i, sid in enumerate(seq_ids):
            blks = self.tables.get(sid, ())
            n = min(len(blks), out.shape[1])
            if n != counts[i]:
                out[i, :n] = blks[:n]
                counts[i] = n

    @property
    def max_blocks_per_seq(self) -> int:
        return max((len(b) for b in self.tables.values()), default=1)
