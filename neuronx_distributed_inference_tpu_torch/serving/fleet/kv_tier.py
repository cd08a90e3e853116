"""Host-RAM KV spill tier: the second storage tier under the device block
pool (counterpart: ``neuronx_distributed_inference_tpu/serving/fleet/
kv_tier.py`` :50-166).

With a :class:`HostKVSpillTier` attached to the paged adapter
(``PagedEngineAdapter(kv_spill_tier=...)``):

  * **spill**: the manager's eviction hook
    (:meth:`~...modules.block_kv_cache.BlockKVCacheManager.set_spill_hook`)
    copies an LRU-evicted prefix block's K/V payload device → host into
    this bounded pool, keyed by the block's content chain hash. A chain
    hash names one deterministic payload (same weights, same adapter,
    same tokens), so a stored payload can be absent, never wrong.
  * **restore**: at admission, past the device prefix hit, the adapter
    walks the prompt's full-block chain hashes through :meth:`get`;
    consecutive hits are written into the freshly allocated device blocks
    in place instead of being recomputed.

Payloads are CPU ``torch`` tensors in the cache's own dtype and bytes
(bf16 and fp8 included). The pool is bounded (``max_blocks``) with
oldest-touched-first eviction; every spill, restore and eviction flows
through the ``nxdi_kv_spill_*`` / ``nxdi_kv_restore_*`` metrics, the
always-on :attr:`stats` and ``kv.spill`` recorder events. The handoff
(``handoff.py``) rides the same pool: :meth:`seed` loads a received
record's payloads so the decode side's admission restores them.

One tier may back several adapters or replicas of the same weights. The
chain hashes carry the LoRA keying (a salt derived from a pooled
adapter's name; none for base rows), so a shared tier never serves one
adapter's KV to another's rows; rows whose salt is local to one engine
are never spilled (``serving/adapter.py``)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from ...resilience.errors import ConfigurationError
from ...resilience.faults import FAULTS as _FAULTS
from ...telemetry import get_registry
from ...telemetry import metrics as tmetrics
from ...telemetry.trace import get_recorder as _get_recorder

__all__ = ["HostKVSpillTier"]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class HostKVSpillTier:
    """Bounded host-RAM pool of spilled KV block payloads, keyed by
    content chain hash."""

    def __init__(self, max_blocks: int = 256, telemetry=None):
        if max_blocks < 1:
            raise ConfigurationError("max_blocks must be >= 1")
        self.max_blocks = max_blocks
        self._telemetry = telemetry
        # hash -> {"k": (L, Bs, H, D), "v": (L, Bs, H, D)} CPU tensors
        self._pool: "OrderedDict[bytes, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._bytes = 0
        self.stats: Dict[str, int] = {
            "spilled": 0, "restored": 0, "evicted": 0, "hits": 0,
            "misses": 0, "seeded": 0, "spill_errors": 0}

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._pool)

    @property
    def nbytes(self) -> int:
        """Host bytes held by the pooled payloads."""
        return self._bytes

    def contains(self, content_hash: bytes) -> bool:
        """Read-only membership probe (no recency touch)."""
        return content_hash in self._pool

    # -- write side --------------------------------------------------------
    def _put(self, content_hash: bytes, k, v) -> None:
        old = self._pool.pop(content_hash, None)
        if old is not None:
            self._bytes -= _nbytes(old["k"]) + _nbytes(old["v"])
        self._pool[content_hash] = {"k": k, "v": v}
        self._bytes += _nbytes(k) + _nbytes(v)

    def _evict_over_bound(self) -> int:
        evicted = 0
        while len(self._pool) > self.max_blocks:
            _, p = self._pool.popitem(last=False)
            self._bytes -= _nbytes(p["k"]) + _nbytes(p["v"])
            evicted += 1
        self.stats["evicted"] += evicted
        return evicted

    def spill(self, content_hash: bytes, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Park one evicted block's payload (CPU tensors the tier keeps).
        A hash already held only refreshes its recency; past
        ``max_blocks`` the oldest-touched payload goes. The ``kv_spill``
        fault point fires here (the adapter's hook counts a failure and
        lets the eviction proceed)."""
        if _FAULTS.active:
            _FAULTS.fire("kv_spill")
        if content_hash in self._pool:
            self._pool.move_to_end(content_hash)
            return
        self._put(content_hash, k, v)
        self.stats["spilled"] += 1
        evicted = self._evict_over_bound()
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("kv.spill", cat="fleet",
                        hash=content_hash.hex()[:16],
                        pool_blocks=len(self._pool))
        reg = self._registry()
        if reg is not None:
            tmetrics.kv_spill_blocks_counter(reg).inc()
            if evicted:
                tmetrics.kv_spill_evictions_counter(reg).inc(evicted)
            tmetrics.kv_spill_bytes_gauge(reg).set(self.nbytes)

    def seed(self, payloads: Dict[bytes, Dict[str, torch.Tensor]]) -> None:
        """Load received handoff payloads (the decode side's admission
        path); counted apart from spills, under the same bound."""
        for h, p in payloads.items():
            fresh = h not in self._pool
            self._put(h, p["k"], p["v"])
            if fresh:
                self.stats["seeded"] += 1
        evicted = self._evict_over_bound()
        reg = self._registry()
        if reg is not None:
            if evicted:
                tmetrics.kv_spill_evictions_counter(reg).inc(evicted)
            tmetrics.kv_spill_bytes_gauge(reg).set(self.nbytes)

    # -- read side ---------------------------------------------------------
    def get(self, content_hash: bytes
            ) -> Optional[Dict[str, torch.Tensor]]:
        """The payload for ``content_hash`` (touching its recency), or
        None. A payload stays after a hit: a shared prefix may be restored
        by many admissions."""
        p = self._pool.get(content_hash)
        if p is None:
            self.stats["misses"] += 1
            return None
        self._pool.move_to_end(content_hash)
        self.stats["hits"] += 1
        return p

    def note_restored(self, n_blocks: int, n_tokens: int) -> None:
        """Restore accounting, called by the adapter after its write (so
        every consumer of one shared tier counts in one place)."""
        self.stats["restored"] += n_blocks
        reg = self._registry()
        if reg is not None:
            tmetrics.kv_restore_blocks_counter(reg).inc(n_blocks)
            tmetrics.kv_restore_tokens_counter(reg).inc(n_tokens)

    def _registry(self):
        if self._telemetry is not None:
            return self._telemetry if self._telemetry.enabled else None
        reg = get_registry()
        return reg if reg.enabled else None
