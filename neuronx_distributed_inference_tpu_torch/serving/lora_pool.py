"""The bounded per-replica LoRA adapter pool (counterpart:
``neuronx_distributed_inference_tpu/serving/lora_pool.py`` —
``LoraAdapterPool`` :64-288: registration :104-117, ``acquire`` /
``release`` :137-176, eviction and the host spill :178-220, the
transactional swap :233-271).

A replica serves more tenants' adapters than its ``max_loras`` device
slots hold. :class:`LoraAdapterPool` owns the residency of the stacked
factors of ONE application:

  * **device residency** — slots ``1..max_loras-1`` (slot 0 is the pinned
    zero adapter: base-model rows gather it). ``acquire(name)`` returns the
    adapter's slot, loading it on a miss; residency is LRU with per-slot
    pin counts, so a slot serving live rows is never evicted under them;
    every slot pinned raises :class:`AdapterCapacityError` (a
    :class:`CapacityError`);
  * **the host spill cache** — an evicted slot's factors are copied to
    host memory into a bounded LRU, and a later acquire restores from
    there instead of re-reading the checkpoint. A spill is best-effort: a
    failure (the ``adapter_spill`` fault point models one) is counted in
    ``stats["spill_errors"]`` and the eviction proceeds;
  * **the transactional swap** — before the device write the pool clones
    the slot's slices of every leaf it will write, and restores them on
    ANY failure (the ``adapter_swap`` fault point fires between the
    snapshot and the write); the failure surfaces as a retry-safe
    :class:`StepFailure` with ``phase="adapter_swap"``.

The port writes the slot IN PLACE (``app.write_lora_slot``): the captured
CUDA graphs of the LoRA steps hold the stacked tensors' addresses and
serve a swapped slot at their next replay. That is why the snapshot is a
``clone()`` of the slices: the reference keeps the old (immutable) leaf,
which here would be the very tensor being overwritten.

Adapters register by name, as a PEFT directory (loaded lazily through the
application's ``lora_adapter_arrays``) or as host arrays
(``register_arrays``). Observability: ``nxdi_lora_residency_hits_total``,
``nxdi_lora_swaps_total{adapter}`` and ``nxdi_lora_swap_bytes``, the
always-on :attr:`stats`, and the ``lora.swap`` / ``lora.spill``
flight-recorder events.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..resilience.errors import (CapacityError, ConfigurationError,
                                 StepFailure)
from ..resilience.faults import FAULTS as _FAULTS
from ..telemetry import get_registry
from ..telemetry import metrics as tmetrics
from ..telemetry.trace import get_recorder as _get_recorder

__all__ = ["LoraAdapterPool", "AdapterCapacityError"]


class AdapterCapacityError(CapacityError):
    """Every adapter slot is pinned by live rows. The engine admits such a
    batch request by request, so base rows and resident adapters never
    wait behind an adapter that has no slot (a port-only subclass: the
    reference raises a plain :class:`CapacityError` and requeues the
    whole batch)."""


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


class LoraAdapterPool:
    """Bounded device-slot residency for named LoRA adapters over ONE
    application's stacked adapter factors."""

    def __init__(self, app, adapters: Optional[Dict[str, str]] = None,
                 host_cache_adapters: int = 8, telemetry=None):
        if getattr(app.spec, "lora", None) is None:
            raise ConfigurationError(
                "LoraAdapterPool needs an application built with "
                "lora_config (TpuConfig.lora_config): the stacked adapter "
                "factors are the pool's backing store")
        if app.spec.lora.max_loras < 2:
            raise ConfigurationError(
                "max_loras must be >= 2 to pool adapters: slot 0 is the "
                "pinned zero adapter (base model)")
        if host_cache_adapters < 1:
            raise ConfigurationError("host_cache_adapters must be >= 1")
        self.app = app
        self._telemetry = telemetry
        self.max_host = host_cache_adapters
        # device slots 1..max_loras-1 (slot 0, the zero adapter, is never
        # written)
        self._free: List[int] = list(range(1, app.spec.lora.max_loras))
        self._slots: Dict[str, int] = {}       # resident name -> slot
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._pins: Dict[str, int] = {}        # resident name -> refcount
        # registration: name -> ("path", dir) | ("arrays", {mod: (A, B)})
        self._sources: Dict[str, Any] = {}
        # the host spill cache: name -> {mod: (A, B)} (bounded, LRU)
        self._host: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # resident name -> the slot's prefix-cache salt its swap-in left;
        # names whose slot was since written outside the pool (a hot
        # update, which the spill cache then carries on) are local
        self._swap_salt: Dict[str, bytes] = {}
        self._local: set = set()
        self.stats: Dict[str, Any] = {
            "hits": 0, "misses": 0, "swaps": 0, "swap_bytes": 0,
            "swap_errors": 0, "cold_loads": 0, "restores": 0,
            "spills": 0, "spill_errors": 0, "host_evictions": 0,
            "evictions": 0, "swap_s": 0.0}
        for name, path in (adapters or {}).items():
            self.register(name, path)

    # -- registration ------------------------------------------------------
    def register(self, name: str, path: str) -> None:
        """Declare ``name`` as a PEFT directory, loaded on its first
        acquisition."""
        self._sources[name] = ("path", path)

    def register_arrays(self, name: str, arrays: Dict[str, Any]) -> None:
        """Declare ``name`` from host arrays in the ``lora_adapter_arrays``
        layout (``{module: (A (L, in, r), B (L, r, out))}``)."""
        self._sources[name] = ("arrays", arrays)

    @property
    def names(self):
        return tuple(self._sources)

    @property
    def n_slots(self) -> int:
        """Usable device slots (slot 0 excluded)."""
        return self.app.spec.lora.max_loras - 1

    def resident(self, name: str) -> bool:
        """Read-only residency probe (no LRU touch)."""
        return name in self._slots

    def slot_of(self, name: str) -> Optional[int]:
        return self._slots.get(name)

    def portable(self, name: str) -> bool:
        """Whether ``name`` on this pool still holds its registered
        factors, so KV computed under it may leave this engine (the spill
        tier, handoff records): False for good once its slot was written
        outside the pool."""
        slot = self._slots.get(name)
        if (slot is not None
                and self.app.lora_kv_salt(slot) != self._swap_salt.get(name)):
            self._local.add(name)
        return name not in self._local

    # -- the acquire / release lifecycle -----------------------------------
    def acquire(self, name: str) -> int:
        """Pin ``name`` into a device slot and return the slot. A hit
        touches recency; a miss claims a free slot (evicting the least
        recently used UNPINNED resident when none is free, its factors
        spilled to the host best-effort) and swaps the adapter in
        transactionally. Raises :class:`CapacityError` when every slot is
        pinned, :class:`ConfigurationError` for an unregistered name."""
        if name in self._slots:
            self._lru.move_to_end(name)
            self._pins[name] += 1
            self.stats["hits"] += 1
            reg = self._registry()
            if reg is not None:
                tmetrics.lora_residency_hits_counter(reg).inc()
            return self._slots[name]
        if name not in self._sources:
            raise ConfigurationError(
                f"unknown adapter {name!r}; registered: "
                f"{sorted(self._sources)}")
        self.stats["misses"] += 1
        slot = self._claim_slot()
        arrays = self._load(name)
        self._swap_in(name, slot, arrays)
        self._slots[name] = slot
        self._lru[name] = None
        self._pins[name] = 1
        return slot

    def release(self, name: str) -> None:
        """Unpin one acquisition; the adapter stays resident until LRU
        pressure evicts it. Releasing a non-resident name is a no-op
        (rollback paths release blindly)."""
        if self._pins.get(name, 0) > 0:
            self._pins[name] -= 1

    def pins(self, name: str) -> int:
        return self._pins.get(name, 0)

    # -- internals ---------------------------------------------------------
    def _claim_slot(self) -> int:
        if self._free:
            return self._free.pop()
        for victim in self._lru:               # oldest-touched first
            if self._pins.get(victim, 0) == 0:
                return self._evict(victim)
        raise AdapterCapacityError(
            f"all {self.n_slots} adapter slots are pinned by live rows; "
            "release sequences (or raise max_loras) before acquiring "
            "another adapter")

    def _evict(self, name: str) -> int:
        self.portable(name)            # a hot-updated slot stays local
        slot = self._slots.pop(name)
        self._swap_salt.pop(name, None)
        del self._lru[name]
        self._pins.pop(name, None)
        self.stats["evictions"] += 1
        self._spill(name, slot)
        return slot

    def _slot_arrays(self, slot: int) -> Dict[str, Any]:
        """The slot's factors as host tensors in the ``lora_adapter_arrays``
        layout (every layer, in order), in the stacks' dtype."""
        app = self.app
        out = {}
        for mod in app.spec.lora.target_modules:
            parts_a, parts_b = [], []
            for key, rows in app._lora_stack_rows().items():
                lw = app.params[key]
                if f"lora_A_{mod}" not in lw:
                    continue
                parts_a.append((rows, lw[f"lora_A_{mod}"][:, slot]))
                parts_b.append((rows, lw[f"lora_B_{mod}"][:, slot]))
            if parts_a:
                out[mod] = (self._gather_layers(parts_a),
                            self._gather_layers(parts_b))
        return out

    def _gather_layers(self, parts):
        """Reassemble per-stack (rows, tensor) slices into one host tensor
        over every layer."""
        if len(parts) == 1 and isinstance(parts[0][0], slice):
            # a copy even on the CPU, where .cpu() would return the view
            # of the slot the next swap overwrites
            return parts[0][1].to("cpu", copy=True)
        L = self.app.spec.num_layers
        first = parts[0][1]
        out = torch.zeros((L,) + tuple(first.shape[1:]), dtype=first.dtype)
        for rows, t in parts:
            out[rows] = t.cpu()
        return out

    def _spill(self, name: str, slot: int) -> None:
        """Best-effort device-to-host copy of the evicted slot's factors
        into the bounded host cache; a failure is swallowed and counted
        (the eviction that triggered it must proceed)."""
        try:
            if _FAULTS.active:
                _FAULTS.fire("adapter_spill")
            self._host[name] = self._slot_arrays(slot)
            self._host.move_to_end(name)
            while len(self._host) > self.max_host:
                self._host.popitem(last=False)
                self.stats["host_evictions"] += 1
            self.stats["spills"] += 1
            rec = _get_recorder()
            if rec.enabled:
                rec.instant("lora.spill", cat="lora", adapter=name,
                            slot=slot, host_cached=len(self._host))
        except Exception:
            self.stats["spill_errors"] += 1

    def _load(self, name: str) -> Dict[str, Any]:
        cached = self._host.get(name)
        if cached is not None:
            self._host.move_to_end(name)
            self.stats["restores"] += 1
            return cached
        kind, src = self._sources[name]
        self.stats["cold_loads"] += 1
        if kind == "arrays":
            return src
        return self.app.lora_adapter_arrays(src)

    def _snapshot(self, slot: int, modules) -> List[tuple]:
        """(leaf, clone of its ``slot`` slice) for every stacked leaf the
        swap writes: copies, since the write lands in the same storage."""
        out = []
        for key in self.app._lora_stack_rows():
            lw = self.app.params[key]
            for mod in modules:
                for ab in "AB":
                    leaf = lw.get(f"lora_{ab}_{mod}")
                    if leaf is not None:
                        out.append((leaf, leaf[:, slot].clone()))
        return out

    def _swap_in(self, name: str, slot: int,
                 arrays: Dict[str, Any]) -> None:
        """Transactional device write: clone the slot's slices of every
        leaf the swap writes, write, and copy the clones back on ANY
        failure, so a failed swap never corrupts a resident slot (the
        claimed slot returns to the free list)."""
        snapshot = self._snapshot(slot, arrays)
        t0 = time.perf_counter()
        try:
            if _FAULTS.active:
                _FAULTS.fire("adapter_swap")
            self.app.write_lora_slot(slot, arrays)
        except Exception as e:
            for leaf, saved in snapshot:
                leaf[:, slot].copy_(saved)
            self._free.append(slot)
            self.stats["swap_errors"] += 1
            from .adapter import _trace_error
            raise _trace_error(StepFailure(
                f"adapter swap of {name!r} into slot {slot} failed; the "
                "stacked factors were restored from the pre-swap snapshot "
                "(no resident slot corrupted)",
                phase="adapter_swap", seq_ids=(), retry_safe=True)) from e
        dt = time.perf_counter() - t0
        self._swap_salt[name] = self.app.lora_kv_salt(slot)
        nbytes = sum(_nbytes(a) + _nbytes(b) for a, b in arrays.values())
        self.stats["swaps"] += 1
        self.stats["swap_bytes"] += nbytes
        self.stats["swap_s"] += dt
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("lora.swap", cat="lora", adapter=name, slot=slot,
                        bytes=nbytes, s=round(dt, 6))
        reg = self._registry()
        if reg is not None:
            tmetrics.lora_swaps_counter(reg).inc(adapter=name)
            tmetrics.lora_swap_bytes_counter(reg).inc(nbytes)

    def _registry(self):
        if self._telemetry is not None:
            return self._telemetry if self._telemetry.enabled else None
        reg = get_registry()
        return reg if reg.enabled else None

    # -- introspection -----------------------------------------------------
    def debug_state(self) -> Dict[str, Any]:
        return {
            "resident": {n: {"slot": s, "pins": self._pins.get(n, 0)}
                         for n, s in self._slots.items()},
            "free_slots": list(self._free),
            "host_cached": list(self._host),
            "stats": dict(self.stats),
        }
