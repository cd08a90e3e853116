"""Serving adapters — the continuous-batching contract an engine drives
(counterpart: ``neuronx_distributed_inference_tpu/serving/adapter.py`` —
``_SeqState``/``_ChunkState`` :137-180, the helpers :182-243
(``_meta_seed`` :192, ``_meta_adapter`` :204), ``_Inflight`` :165,
``_async_fetch`` :236, ``_AdapterTelemetry`` :245-456 (``on_spec_step``
:320, the pipeline hooks :373-386), the helpers :459-560, ``_CbScratch``
:563, ``_PagedScratch`` :606, ``_EngineAdapterBase`` :682-1088 (the eager
path, the depth-1 pipeline :903-1068, ``flush`` :837 and ``debug_state``
:1071),
``ContinuousBatchingAdapter`` :1090-1275 and ``PagedEngineAdapter`` :1277
with its speculation and ragged routing :1371-1385 and :1540-1670,
scheduler hooks :1794-1878, the host-RAM KV spill tier :1881-1975, the
LoRA pool binding :1975-2020, preemption :2022-2165 and chunked prefill
:2174-2400).

``ContinuousBatchingAdapter`` drives the contiguous app: a request owns one
cache row (its ``seq_id``) from ``add_requests`` to ``release``; prefill
and decode address rows by ``seq_id``. ``PagedEngineAdapter`` drives the
paged app. The engine owns scheduling; the adapter owns device state:

  * ``add_requests(seq_ids, prompts)`` — transactional admission; the
    uncached prompt suffixes run as chunked, packed prefill rows of
    ctx-bucket ``_run_paged`` dispatches (or, with
    ``prefill_budget_tokens``, one budgeted chunk dispatch per step);
  * ``step(seq_ids=None)`` — one decode step for the running rows (with
    ``speculation=``: draft and verify, 1..k+1 tokens a row,
    ``serving/speculation/``; with ``ragged=True``: ONE mixed dispatch of
    decode or verify rows and pending prefill chunks, ``serving/ragged/``);
  * ``step_many(k, seq_ids=None)`` — k decode steps in one call of the
    device loop (slots advance on the device);
  * ``release(seq_ids)`` — free rows and their blocks.

When the block pool runs dry the ``preemption_policy`` ("lifo" /
"fewest_generated") evicts a running or pending sequence and queues a
:class:`Preempted` record for :meth:`PagedEngineAdapter.take_preempted`.

Every paged dispatch carries the per-request sampling seeds
(``meta["sampling_seed"]``, else 0) as ``row_seeds``: under a
``stream_seed`` config every sampled token is the coupled draw of its
(request seed, position), whatever path or batch produced it.

With a ``lora_pool`` (:class:`~.lora_pool.LoraAdapterPool` over the same
app) a request's ``meta["adapter"]`` names its LoRA adapter: admission
pins it into a device slot (the pool swaps it in on a miss) before the
row's blocks are allocated, so the prefix cache is keyed by the slot
(``app.lora_kv_salt``; the reference keys it on the tokens only); every
dispatch with an adapter row carries the rows' slots as ``adapter_ids``
(base-model rows slot 0, the zero adapter; a pass of base rows only
carries none and runs the LoRA-free step), and release, preemption and
admission rollback unpin it. ``set_adapter_shed(True)`` (the ``shed_adapters`` degradation
actuator) admits tagged requests as base-model rows.

With a ``kv_spill_tier`` (:class:`~.fleet.kv_tier.HostKVSpillTier`) an
LRU-evicted prefix block spills its payload to host RAM, and an admission
restores the spilled full blocks past its device prefix hit, in place,
instead of recomputing them. The tier's chains (and the handoff records'
of ``fleet/handoff.py``) are salted as the prefix cache's cannot be: a
slot's salt names one write on one engine, while a tier may be shared by
engines and a record crosses them. So a row under a pooled adapter keys
them by the adapter's NAME (:func:`adapter_tier_salt`), a base row by b""
(the reference's chain), and a row whose factors were written outside
the pool (``LoraAdapterPool.portable``; a base row after slot 0 was
written) never reaches a tier or a record.

Decode pipeline (``pipeline_depth``, both adapters):

  * ``pipeline_depth=0`` (default) is the eager path: every ``step()``
    dispatches and fetches its own tokens;
  * ``pipeline_depth=1`` keeps the previous dispatch's sampled tokens on
    the card and feeds them straight into the next decode step (the
    captured T = 1 graph copies them into its static input on the card),
    while their copy to a pinned host buffer runs behind it; ``step()``
    then returns the PREVIOUS step's tokens ({} on the first call) and
    ``flush()`` drains the last. The host's bookkeeping for step N + 1
    overlaps the card's work on step N. Token streams equal the eager
    path's. A live set that changed since the in-flight dispatch (an
    admission, a release, a preemption) drains it first; a ragged or
    speculative step, ``step_many`` and ``release`` drain it too;
  * a device failure of step N surfaces at its fetch, in step N + 1's
    call, as a :class:`StepFailure` with ``retry_safe=False``: the host
    bookkeeping of every in-flight step (positions, paged KV growth) is
    rolled back to the last DELIVERED token (the ``pipeline_flush`` fault
    point makes this deterministic). The cache itself was written in
    place by the failed chain.

Telemetry (``telemetry=`` registry, else the process-global one) and the
fault points ``slow_step``, ``decode_step``, ``pipeline_flush``,
``prefill_chunk``, ``spec_draft``, ``spec_verify`` and ``ragged_step``
are those of the counterpart.

A step that fails before its dispatch began (an injected fault, a host
error) raises a ``retry_safe`` :class:`StepFailure`; one that fails inside
the dispatch does not, since the cache is updated in place.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..modules import autobucketing
from ..modules.block_kv_cache import (_hash_block, cut_cached_at_unwritten,
                                      slots_from_table,
                                      slots_from_table_into)
from ..parallel.mesh import refuse_over_mesh
from ..resilience.errors import (AdmissionError, CapacityError,
                                 ConfigurationError, DeadlineExceeded,
                                 KVCacheStateError, SequenceStateError,
                                 ServingError, StepFailure)
from ..resilience.faults import FAULTS as _FAULTS
from ..resilience.preemption import (PREEMPTION_POLICIES, Preempted,
                                     pick_victim)
from ..telemetry import get_registry
from ..telemetry import metrics as tmetrics
from ..telemetry.request_trace import trace_of as _trace_of
from ..telemetry.trace import get_recorder as _get_recorder


@dataclass
class _SeqState:
    position: int                 # position of last_token
    last_token: int
    running: bool = True
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    prompt_len: int = 0
    admit_idx: int = 0            # adapter-wide admission counter (LIFO)
    deadline: Optional[float] = None   # absolute perf_counter() deadline
    expired_reported: bool = False     # deadline metric counted once
    meta: Any = None              # opaque engine passthrough


@dataclass
class _ChunkState:
    """Chunked-prefill progress of one PENDING admission: KV for
    ``prompt[:done]`` is written (or prefix-cached); ``[done:]`` still has
    chunks to run."""
    prompt: List[int]
    done: int
    admit_idx: int
    t0: float = 0.0               # admission wall time (TTFT anchor)
    deadline: Optional[float] = None
    expired_reported: bool = False
    meta: Any = None


@dataclass
class _Inflight:
    """One dispatched but not yet fetched decode step (pipeline_depth 1).

    ``states`` pins the exact _SeqState objects the dispatch advanced:
    retire and rollback apply only where the identity still matches, so a
    row released (or preempted) and re-admitted under the same seq_id
    while the step was in flight never receives the stale token."""
    live: Tuple[int, ...]
    states: Tuple[_SeqState, ...]
    b: int
    pad_to: int
    out: Dict[str, Any]
    t_dispatch: float
    grown: int = 0                # paged KV tokens grown for this dispatch


def _async_fetch(out: Dict[str, Any]) -> None:
    """Start the copy of a dispatch's sampled tokens to the host without
    waiting: on the card a non-blocking copy into a pinned buffer of its
    own (one per dispatch, so a later step's copy never overwrites tokens
    not yet read) and an event recorded behind it, kept in
    ``out["fetch"]``; on the CPU the tokens are on the host already."""
    toks = out["tokens"]
    if toks.device.type != "cuda":
        out["fetch"] = (toks, None)
        return
    host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    host.copy_(toks, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    out["fetch"] = (host, done)


def _meta_tenant(meta: Any) -> str:
    """Tenant label value from an opaque per-request ``meta`` payload (the
    engine passes mappings with a "tenant" key; anything else is "")."""
    try:
        return str(meta.get("tenant", ""))
    except AttributeError:
        return ""


def _meta_seed(meta: Any) -> int:
    """Per-request sampling seed from an opaque ``meta`` payload (the
    engine passes mappings with a "sampling_seed" key; anything else seeds
    as 0). Feeds the coupled sampling stream (ops/sampling.stream_keys)."""
    try:
        return int(meta.get("sampling_seed", 0))
    except (AttributeError, TypeError, ValueError):
        return 0


def _meta_adapter(meta: Any) -> Optional[str]:
    """The named LoRA adapter of an opaque per-request ``meta`` payload
    (the engine passes mappings with an "adapter" key); anything else,
    empty values included, is the base model."""
    try:
        name = meta.get("adapter", None)
    except AttributeError:
        return None
    return str(name) if name else None


def _common_tenant(tenants) -> str:
    """The single tenant shared by every affected row, or "" when the set
    is empty or mixed."""
    ts = set(tenants)
    return ts.pop() if len(ts) == 1 else ""


def _trace_error(err):
    """Record ``err`` on the flight recorder when tracing is live; returns
    ``err`` so raise sites stay one-liners."""
    rec = _get_recorder()
    if rec.enabled and getattr(err, "trace_id", None) is None:
        rec.error(err)
    return err


class _AdapterTelemetry:
    """Engine-adapter instrumentation (a copy of the counterpart's): TTFT
    / per-step decode latency histograms, live-batch and pad-waste
    accounting, pipeline depth, overlap and steps per fetch, one request
    span per seq_id. Host-side only; every method is a cheap no-op while
    telemetry is disabled."""

    def __init__(self, engine: str, telemetry=None):
        self.engine = engine
        self._telemetry = telemetry
        self._requests: Dict[int, Dict[str, Any]] = {}

    @property
    def registry(self):
        return self._telemetry if self._telemetry is not None \
            else get_registry()

    def on_add(self, seq_ids: Sequence[int], prompts, t0: float,
               live: int, padded: int, count_rows: bool = True,
               tenants: Optional[Sequence[str]] = None):
        reg = self.registry
        if not reg.enabled:
            return
        if tenants is None:
            tenants = [""] * len(seq_ids)
        ttft = time.perf_counter() - t0
        hist = tmetrics.ttft_histogram(reg)
        for sid, prompt, tenant in zip(seq_ids, prompts, tenants):
            span = reg.start_span("request", engine=self.engine, seq_id=sid,
                                  tenant=tenant)
            span.t_start = t0
            span.event("first_token", ttft_s=ttft, prompt_len=len(prompt))
            self._requests[sid] = {"span": span, "steps": 0,
                                   "t_first": t0 + ttft, "t_last": t0 + ttft,
                                   "tenant": tenant}
            hist.observe(ttft, engine=self.engine, tenant=tenant)
        tmetrics.requests_counter(reg).inc(len(seq_ids), engine=self.engine,
                                           event="added")
        tmetrics.generated_tokens_counter(reg).inc(live, engine=self.engine)
        if count_rows:
            self._rows(reg, "prefill", live, padded)

    def on_prefill_chunk(self, rows: int, padded_rows: int,
                         real_tokens: int, padded_tokens: int):
        reg = self.registry
        if not reg.enabled:
            return
        tmetrics.prefill_chunks_counter(reg).inc(rows, engine=self.engine)
        if padded_tokens:
            tmetrics.prefill_pad_waste_histogram(reg).observe(
                1.0 - real_tokens / padded_tokens, engine=self.engine)
        self._rows(reg, "prefill", rows, padded_rows)

    def on_step(self, live_ids: Sequence[int], t0: float, padded: int,
                steps: int = 1):
        reg = self.registry
        if not reg.enabled:
            return
        now = time.perf_counter()
        n = len(live_ids)
        tmetrics.decode_step_histogram(reg).observe((now - t0) / steps,
                                                    engine=self.engine)
        tmetrics.generated_tokens_counter(reg).inc(n * steps,
                                                   engine=self.engine)
        for sid in live_ids:
            info = self._requests.get(sid)
            if info is not None:
                info["steps"] += steps
                info["t_last"] = now
        self._rows(reg, "decode", n, padded, steps=steps)

    def on_spec_step(self, rows: Sequence[Tuple[int, int]], t0: float,
                     padded: int, width: int, drafted: int, accepted: int,
                     mode: str = "greedy"):
        """One speculative engine step: ``rows`` is (seq_id, tokens
        delivered) per live row; ``mode`` labels the verify discipline
        (greedy | sampled) so the two acceptance regimes never share a
        series."""
        reg = self.registry
        now = time.perf_counter()
        delivered = 0
        for sid, n in rows:
            delivered += n
            info = self._requests.get(sid)
            if info is not None:
                info["steps"] += n
                info["t_last"] = now
        if not reg.enabled:
            return
        tmetrics.decode_step_histogram(reg).observe(now - t0,
                                                    engine=self.engine)
        tmetrics.generated_tokens_counter(reg).inc(delivered,
                                                   engine=self.engine)
        tmetrics.spec_drafted_counter(reg).inc(drafted, engine=self.engine,
                                               mode=mode)
        tmetrics.spec_accepted_counter(reg).inc(accepted,
                                                engine=self.engine,
                                                mode=mode)
        if drafted:
            tmetrics.spec_accept_rate_gauge(reg).set(accepted / drafted,
                                                     engine=self.engine,
                                                     mode=mode)
        tmetrics.spec_verify_width_histogram(reg).observe(
            width, engine=self.engine)
        self._rows(reg, "decode", len(rows), padded)

    def on_ragged_step(self, kind_rows: Dict[str, int], real_tokens: int,
                       padded_tokens: int):
        """One ragged unified dispatch: ``kind_rows`` maps row kind
        (decode/prefill/verify/pad) to rows packed; the pad-waste gauge
        tracks the last dispatch's (padded - real) / padded."""
        reg = self.registry
        if not reg.enabled:
            return
        counter = tmetrics.ragged_rows_counter(reg)
        for kind, n in kind_rows.items():
            if n:
                counter.inc(n, engine=self.engine, kind=kind)
        if padded_tokens:
            tmetrics.ragged_pad_waste_gauge(reg).set(
                1.0 - real_tokens / padded_tokens, engine=self.engine)

    def on_dispatch(self, depth: int):
        reg = self.registry
        if reg.enabled:
            tmetrics.dispatch_depth_gauge(reg).set(depth, engine=self.engine)

    def on_fetch(self, steps: int, overlap_s: Optional[float] = None):
        reg = self.registry
        if not reg.enabled:
            return
        tmetrics.steps_per_fetch_histogram(reg).observe(steps,
                                                        engine=self.engine)
        if overlap_s is not None:
            tmetrics.host_overlap_histogram(reg).observe(overlap_s,
                                                         engine=self.engine)

    def on_release(self, seq_ids: Sequence[int]):
        reg = self.registry
        released = 0
        for sid in seq_ids:
            info = self._requests.pop(sid, None)
            if info is None:
                continue
            released += 1
            span, steps = info["span"], info["steps"]
            span.event("released", decode_steps=steps)
            if reg.enabled and steps > 0:
                # first token -> LAST decode step, not -> release
                tmetrics.tpot_histogram(reg).observe(
                    (info["t_last"] - info["t_first"]) / steps,
                    engine=self.engine, tenant=info.get("tenant", ""))
            span.end()
        if released and reg.enabled:
            tmetrics.requests_counter(reg).inc(released, engine=self.engine,
                                               event="released")

    def on_preempt(self, seq_id: int, reason: str, tenant: str = ""):
        info = self._requests.pop(seq_id, None)
        if info is not None:
            info["span"].event("preempted", reason=reason)
            info["span"].end()
        reg = self.registry
        if reg.enabled:
            tmetrics.preemptions_counter(reg).inc(engine=self.engine,
                                                  reason=reason,
                                                  tenant=tenant)

    def on_deadline(self, seq_ids: Sequence[int],
                    tenants: Optional[Sequence[str]] = None):
        reg = self.registry
        if not seq_ids or not reg.enabled:
            return
        if tenants is None:
            tenants = [""] * len(seq_ids)
        counter = tmetrics.deadline_expired_counter(reg)
        for tenant in tenants:
            counter.inc(engine=self.engine, tenant=tenant)

    def on_step_failure(self, phase: str, tenant: str = ""):
        reg = self.registry
        if reg.enabled:
            tmetrics.step_failures_counter(reg).inc(engine=self.engine,
                                                    phase=phase,
                                                    tenant=tenant)

    def on_admission_rollback(self):
        reg = self.registry
        if reg.enabled:
            tmetrics.admission_rollbacks_counter(reg).inc(engine=self.engine)

    def _rows(self, reg, phase: str, live: int, padded: int,
              steps: int = 1):
        tmetrics.live_batch_gauge(reg).set(live, engine=self.engine)
        tmetrics.live_rows_counter(reg).inc(live * steps, engine=self.engine,
                                            phase=phase)
        if padded > live:
            tmetrics.pad_rows_counter(reg).inc((padded - live) * steps,
                                               engine=self.engine,
                                               phase=phase)


def _live_rows(seqs: Dict[int, _SeqState],
               seq_ids: Optional[Sequence[int]],
               pending=()) -> List[int]:
    """Running rows for a step call; ``pending`` ids (mid-prefill) are
    known but carry no decodable row yet."""
    ids = sorted(seqs) if seq_ids is None else list(seq_ids)
    if seq_ids is not None:
        for sid in ids:
            if sid not in seqs and sid not in pending:
                raise SequenceStateError(f"seq_id {sid} is not running "
                                         "(released or never added)")
    return [sid for sid in ids if sid in seqs and seqs[sid].running]


def _validate_admission(seq_ids: Sequence[int],
                        prompts: Sequence[Sequence[int]], seq_len: int):
    if len(seq_ids) == 0:
        raise AdmissionError("add_requests called with empty seq_ids")
    if len(seq_ids) != len(prompts):
        raise AdmissionError("seq_ids and prompts length mismatch "
                             f"({len(seq_ids)} vs {len(prompts)})")
    if len(set(seq_ids)) != len(seq_ids):
        raise AdmissionError("duplicate seq_ids in one add_requests call")
    for sid, p in zip(seq_ids, prompts):
        if len(p) == 0:
            raise AdmissionError(f"zero-length prompt for seq_id {sid}")
        if len(p) > seq_len:
            raise AdmissionError(
                f"prompt for seq_id {sid} is {len(p)} tokens — beyond the "
                f"configured seq_len {seq_len}")


def _resolve_deadlines(deadline_s, n: int,
                       t0: float) -> List[Optional[float]]:
    if deadline_s is None:
        return [None] * n
    if isinstance(deadline_s, (int, float)):
        return [t0 + float(deadline_s)] * n
    if len(deadline_s) != n:
        raise AdmissionError("deadline_s and seq_ids length mismatch")
    return [None if d is None else t0 + float(d) for d in deadline_s]


def _pre_step_checks(seqs: Dict[int, _SeqState], live: Sequence[int],
                     seq_len: Optional[int], telemetry: _AdapterTelemetry,
                     horizon: int = 1):
    """Wall-clock deadlines, then the decode-past-seq_len guard, for the
    whole ``horizon`` of fused steps, BEFORE any device work. ``seq_len``
    is None for a rolling cache, which never overflows."""
    now = time.perf_counter()
    expired = [s for s in live
               if seqs[s].deadline is not None and now >= seqs[s].deadline]
    if expired:
        fresh = [s for s in expired if not seqs[s].expired_reported]
        for s in fresh:
            seqs[s].expired_reported = True
        telemetry.on_deadline(fresh, [_meta_tenant(seqs[s].meta)
                                      for s in fresh])
        raise _trace_error(DeadlineExceeded(
            f"seq_ids {expired} exceeded their wall-clock deadline; "
            "release() them (or re-queue with a fresh budget) and step "
            "again", seq_ids=expired))
    over = ([] if seq_len is None else
            [s for s in live if seqs[s].position + horizon > seq_len])
    if over:
        raise _trace_error(CapacityError(
            f"decode step (horizon {horizon}) for seq_ids {over} would "
            f"write KV past the configured seq_len {seq_len}; release them "
            "or rebuild with a larger seq_len", seq_ids=over))


def _repeat_row0(x: np.ndarray, pad_to: int) -> np.ndarray:
    """Pad a batch axis to ``pad_to`` by repeating row 0 (pad rows
    recompute row 0 and rewrite its slots with the same values)."""
    return np.concatenate([x, np.repeat(x[:1], pad_to - x.shape[0],
                                        axis=0)])


def _pad_paged_rows(pad_to, *rows):
    if rows[0].shape[0] == pad_to:
        return rows
    return tuple(_repeat_row0(x, pad_to) for x in rows)


class _CbScratch:
    """Reusable decode-step input buffers for one (live set, batch
    bucket) composition of the contiguous adapter."""

    def __init__(self, live: Sequence[int], pad_to: int):
        b = len(live)
        self.live = tuple(live)
        self.b = b
        self.pad_to = pad_to
        self.sid_p = np.empty((pad_to,), np.int32)
        self.sid_p[:b] = live
        self.sid_p[b:] = live[0]
        self.toks_p = np.empty((pad_to, 1), np.int32)
        self.pos_p = np.empty((pad_to, 1), np.int32)
        self.gather_idx = None            # _feedback_index

    def fill(self, adapter, need_tokens: bool = True):
        seqs = adapter.seqs
        for i, s in enumerate(self.live):
            st = seqs[s]
            self.pos_p[i, 0] = st.position
            if need_tokens:
                self.toks_p[i, 0] = st.last_token
        if self.pad_to > self.b:
            self.pos_p[self.b:] = self.pos_p[0, 0]
            if need_tokens:
                self.toks_p[self.b:] = self.toks_p[0, 0]


class _PagedScratch:
    """Reusable decode-step input buffers for one (live set, batch bucket,
    table-width bucket) composition: the block-table array is refreshed
    only for rows whose block list grew; slots are recomputed in place."""

    def __init__(self, live: Sequence[int], pad_to: int, width: int,
                 block_size: int, seeds: Sequence[int],
                 aids: Optional[Sequence[int]] = None):
        b = len(live)
        self.live = tuple(live)
        self.b = b
        self.pad_to = pad_to
        self.width = width
        self.seeds = _repeat_row0(np.asarray(seeds, np.int32), pad_to)
        # the rows' LoRA slots are constants of the live composition
        self.aids = (None if aids is None else
                     _repeat_row0(np.asarray(aids, np.int32), pad_to))
        self.last = np.zeros((pad_to,), np.int32)
        self.ids = np.empty((pad_to, 1), np.int32)
        self.pos = np.empty((pad_to, 1), np.int32)
        self.slots = np.empty((pad_to, 1), np.int32)
        self.bt = np.zeros((pad_to, width), np.int32)
        self.counts = [0] * b
        self._block_size = block_size
        self.gather_idx = None            # _feedback_index

    def fill(self, adapter, need_tokens: bool = True):
        seqs = adapter.seqs
        for i, s in enumerate(self.live):
            st = seqs[s]
            self.pos[i, 0] = st.position
            if need_tokens:
                self.ids[i, 0] = st.last_token
        prev0 = self.counts[0]
        adapter.app.kv_mgr.fill_block_table(self.bt[:self.b], self.live,
                                            self.counts)
        if self.pad_to > self.b:
            self.pos[self.b:] = self.pos[0, 0]
            if need_tokens:
                self.ids[self.b:] = self.ids[0, 0]
            if self.counts[0] != prev0:
                self.bt[self.b:] = self.bt[0]
        slots_from_table_into(self.slots, self.bt, self.pos,
                              self._block_size)


class _EngineAdapterBase:
    """The decode machinery both adapters share: the eager step template,
    the depth-1 decode pipeline (device-resident token feedback, deferred
    fetch, lookahead-aware rollback) and ``step_many``; subclasses provide
    dispatch, scratch construction, KV growth and token bookkeeping."""

    engine_name = ""
    _decode_failure_msg = "decode device step failed"
    _step_growth = 0              # paged: KV tokens grown per dispatch

    def _init_decode_path(self, pipeline_depth: int):
        if pipeline_depth not in (0, 1):
            raise ConfigurationError(
                f"pipeline_depth must be 0 (eager) or 1 (one dispatch of "
                f"lookahead), got {pipeline_depth!r}")
        self.pipeline_depth = pipeline_depth
        self._inflight: Optional[_Inflight] = None
        self._ready: Dict[int, int] = {}
        self._scratch = None
        # plain-int host counters (always on). The decode counters count
        # ONLY decode work; chunked prefill keeps its own prefill_* set
        self.host_stats: Dict[str, Any] = {
            "dispatches": 0, "device_steps": 0,
            "blocking_fetches": 0, "blocked_s": 0.0,
            "prefill_dispatches": 0, "prefill_blocking_fetches": 0,
            "prefill_blocked_s": 0.0, "prefill_real_tokens": 0,
            "prefill_padded_tokens": 0}

    # -- subclass hooks ----------------------------------------------------
    def _pending_ids(self):
        """seq_ids admitted but still mid-prefill (paged chunked
        admissions); () on adapters without a deferred prefill path."""
        return ()

    def _advance_prefill(self, seq_ids=None):
        """Run at most one packed prefill-chunk dispatch (no-op on adapters
        without a deferred prefill path)."""

    def _grow_for_step(self, live: List[int], n: int = 1) -> List[int]:
        return live

    def _rollback_step_growth(self, live: Sequence[int], n: int = 1):
        pass

    def _unwind_inflight_growth(self, rec: _Inflight):
        pass

    def _append_token(self, st: _SeqState, tok: int):
        st.last_token = tok

    def _traces_of(self, seq_ids):
        """Request trace ids of ``seq_ids`` (running rows): the
        attribution of a steady-state incident (serving/warmup.py)."""
        return [_trace_of(self.seqs[s].meta)
                for s in seq_ids if s in self.seqs]

    def _request_context(self, seq_ids):
        """In declared steady state, the app's ``request_context`` over
        the rows' trace ids; a no-op context otherwise."""
        if getattr(self.app, "_steady_state", False):
            return self.app.request_context(self._traces_of(seq_ids))
        return contextlib.nullcontext()

    def _tenant_of(self, seq_ids) -> str:
        """Common tenant label of ``seq_ids`` (running rows), "" when
        mixed or unknown."""
        return _common_tenant(_meta_tenant(self.seqs[s].meta)
                              for s in seq_ids if s in self.seqs)

    def _note_dispatch(self, scr, toks_dev) -> None:
        """Count one decode dispatch and mark it on the flight recorder."""
        self.host_stats["dispatches"] += 1
        self.host_stats["device_steps"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.decode", cat="adapter",
                        engine=self.engine_name, rows=scr.b,
                        pad_to=scr.pad_to, seq_ids=list(scr.live),
                        pipelined=toks_dev is not None)

    # -- the ONLY places that block on device output -----------------------
    def _fetch_rows(self, out, b: int) -> np.ndarray:
        """The dispatch's sampled tokens on the host: a wait on the event
        of its copy (:func:`_async_fetch`, started here when the dispatch
        did not)."""
        t0 = time.perf_counter()
        if "fetch" not in out:
            _async_fetch(out)
        host, done = out["fetch"]
        if done is not None:
            done.synchronize()
        toks = host.numpy()
        t1 = time.perf_counter()
        self.host_stats["blocking_fetches"] += 1
        self.host_stats["blocked_s"] += t1 - t0
        rec = _get_recorder()
        if rec.enabled:
            rec.complete("fetch.tokens", t0, cat="adapter", t1=t1,
                         engine=self.engine_name, rows=b)
        return toks.reshape(toks.shape[0], -1)[:b]

    # -- decode ------------------------------------------------------------
    def step(self, seq_ids: Optional[Sequence[int]] = None) -> Dict[int, int]:
        """One decode step for ``seq_ids`` (default: every running row).

        Eager (``pipeline_depth=0``): {seq_id: next token} for THIS step,
        plus the first tokens of prefills that completed in this call.
        Pipelined (``pipeline_depth=1``): dispatches this step and returns
        the PREVIOUS step's tokens ({} on the first call after the
        pipeline empties; :meth:`flush` drains the last). Raises
        :class:`DeadlineExceeded` / :class:`CapacityError` before any
        device work when a row is over budget, and :class:`StepFailure`
        when a device step fails (see the module docstring for the
        deferred-failure rollback)."""
        if self.pipeline_depth:
            return self._step_pipelined(seq_ids)
        return self._step_eager(seq_ids)

    def step_many(self, num_steps: int,
                  seq_ids: Optional[Sequence[int]] = None
                  ) -> Dict[int, List[int]]:
        """``num_steps`` decode steps in one call of the device loop and
        one host fetch: {seq_id: [tokens]} in stream order; a pipelined
        adapter's in-flight token is drained first and leads its row's
        list. Deadlines and the seq_len guard are enforced once for the
        whole horizon."""
        if num_steps < 1:
            raise ConfigurationError("step_many requires num_steps >= 1")
        if self._inflight is not None or self._ready:
            self._stash_flush()
        # drained tokens stay in _ready until this call is past every
        # fallible stage: a recoverable failure must not drop them
        pending = self._pending_ids()
        live = _live_rows(self.seqs, seq_ids, pending)
        if not live and not pending:
            return {s: [t] for s, t in self._drain_ready().items()}
        if _FAULTS.active:
            _FAULTS.fire("slow_step")
        if live:
            _pre_step_checks(self.seqs, live, self._pos_limit,
                             self.telemetry, horizon=num_steps)
        self._advance_prefill(seq_ids)
        if not live:
            return {s: [t] for s, t in self._drain_ready().items()}
        t0 = time.perf_counter()
        live = self._grow_for_step(live, num_steps)
        if not live:
            return {s: [t] for s, t in self._drain_ready().items()}
        toks, pad_to = self._run_many(live, num_steps)
        res = {s: [t] for s, t in self._drain_ready().items()}
        for i, s in enumerate(live):
            st = self.seqs[s]
            st.position += num_steps
            row = [int(t) for t in toks[i]]
            for t in row:
                self._append_token(st, t)
            res.setdefault(s, []).extend(row)
        self.telemetry.on_step(live, t0, padded=pad_to, steps=num_steps)
        self.telemetry.on_fetch(num_steps)
        return res

    def flush(self) -> Dict[int, int]:
        """Retire the in-flight pipelined dispatch (if any) and hand back
        every token not yet delivered: {seq_id: token} ({} in eager mode
        unless a failed call left first tokens behind). A deferred fetch
        failure aborts the pipeline (StepFailure, ``retry_safe=False``)."""
        ready = self._drain_ready()
        rec, self._inflight = self._inflight, None
        if rec is not None:
            try:
                ready.update(self._retire_or_abort([rec]))
            except BaseException:
                # the drained tokens were already generated and applied to
                # host state: keep them deliverable past the failure
                self._ready = {**ready, **self._ready}
                raise
        return ready

    def _drain_ready(self) -> Dict[int, int]:
        if not self._ready:
            return {}
        out, self._ready = self._ready, {}
        return out

    def _stash_flush(self):
        """flush() into the pending buffer, so tokens drained by add,
        release or step_many are handed back by the next returning call
        instead of being dropped."""
        for s, t in self.flush().items():
            self._ready[s] = t

    def _run_guarded(self, live, n: int, run):
        """Run the fused loop ``run()`` (which fetches its tokens) under
        the ``decode_step`` fault point; any failure rolls back the
        horizon's KV growth and raises a typed :class:`StepFailure`."""
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("decode_step")
            dispatched = True
            return run()
        except ServingError:
            self._rollback_step_growth(live, n)
            raise
        except Exception as e:
            self._rollback_step_growth(live, n)
            self.telemetry.on_step_failure("decode", self._tenant_of(live))
            raise _trace_error(StepFailure(
                "fused decode loop failed; positions were not advanced",
                phase="decode", seq_ids=tuple(live),
                retry_safe=not dispatched)) from e

    # -- eager path --------------------------------------------------------
    def _step_eager(self, seq_ids) -> Dict[int, int]:
        pending = self._pending_ids()
        live = _live_rows(self.seqs, seq_ids, pending)
        if not live and not pending:
            return self._drain_ready()
        if _FAULTS.active:
            _FAULTS.fire("slow_step")
        if live:
            _pre_step_checks(self.seqs, live, self._pos_limit,
                             self.telemetry)
        self._advance_prefill(seq_ids)
        if not live:
            return self._drain_ready()
        t0 = time.perf_counter()
        live = self._grow_for_step(live)
        if not live:
            return self._drain_ready()
        scr = self._scratch_for(live)
        scr.fill(self)
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("decode_step")
            dispatched = True
            out = self._dispatch_decode(scr)
            new = self._fetch_rows(out, len(live))
        except ServingError:
            self._rollback_step_growth(live)
            self._scratch = None
            raise
        except Exception as e:
            self._rollback_step_growth(live)
            self._scratch = None
            self.telemetry.on_step_failure("decode", self._tenant_of(live))
            raise _trace_error(StepFailure(
                self._decode_failure_msg + "; positions were not advanced",
                phase="decode", seq_ids=tuple(live),
                retry_safe=not dispatched)) from e
        res = self._drain_ready()
        for i, s in enumerate(live):
            st = self.seqs[s]
            st.position += 1
            tok = int(new[i, 0])
            self._append_token(st, tok)
            res[s] = tok
        self.telemetry.on_step(live, t0, padded=scr.pad_to)
        self.telemetry.on_fetch(1)
        return res

    # -- pipelined path ----------------------------------------------------
    def _step_pipelined(self, seq_ids) -> Dict[int, int]:
        pending = self._pending_ids()
        live = _live_rows(self.seqs, seq_ids, pending)
        if not live and not pending:
            return self.flush()
        if _FAULTS.active:
            _FAULTS.fire("slow_step")
        if live:
            _pre_step_checks(self.seqs, live, self._pos_limit,
                             self.telemetry)
        self._advance_prefill(seq_ids)
        if not live:
            return self.flush()
        ready = self._drain_ready()
        try:
            return self._advance_pipeline(live, ready)
        except BaseException:
            # tokens drained (or retired) this call were already generated
            # and applied to host state: keep them deliverable past a
            # recoverable failure
            self._ready = {**ready, **self._ready}
            raise

    def _advance_pipeline(self, live: List[int],
                          ready: Dict[int, int]) -> Dict[int, int]:
        prev, self._inflight = self._inflight, None
        if prev is not None and not self._matches(prev, live):
            # the live set changed since the dispatch: drain it first
            ready.update(self._retire_or_abort([prev]))
            prev = None
        t0 = time.perf_counter()
        try:
            live = self._grow_for_step(live)
        except ServingError:
            self._inflight = prev          # growth rolled itself back
            raise
        if not live:
            self._inflight = prev
            return ready
        if prev is not None and not self._matches(prev, live):
            # preemption shrank the batch: drain the old composition's
            # dispatch before re-padding for the new one
            ready.update(self._retire_or_abort([prev]))
            prev = None
        scr = self._scratch_for(live)
        scr.fill(self, need_tokens=prev is None)
        toks_dev = None if prev is None else self._feedback_tokens(prev, scr)
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("decode_step")
            dispatched = True
            out = self._dispatch_decode(scr, toks_dev)
        except ServingError:
            self._rollback_step_growth(live)
            self._scratch = None
            self._inflight = prev          # the lookahead step is healthy
            raise
        except Exception as e:
            self._rollback_step_growth(live)
            self._scratch = None
            self._inflight = prev
            self.telemetry.on_step_failure("decode", self._tenant_of(live))
            raise _trace_error(StepFailure(
                self._decode_failure_msg + " at dispatch; the in-flight "
                "lookahead step was preserved",
                phase="decode", seq_ids=tuple(live),
                retry_safe=not dispatched)) from e
        rec = _Inflight(
            live=tuple(live), states=tuple(self.seqs[s] for s in live),
            b=len(live), pad_to=scr.pad_to, out=out, t_dispatch=t0,
            grown=self._step_growth)
        for s in live:
            self.seqs[s].position += 1
        if prev is not None:
            ready.update(self._retire_or_abort([prev, rec]))
        self._inflight = rec
        self.telemetry.on_dispatch(1)
        return ready

    def _matches(self, rec: _Inflight, live: Sequence[int]) -> bool:
        return (rec.live == tuple(live)
                and all(self.seqs.get(s) is st
                        for s, st in zip(rec.live, rec.states)))

    def _feedback_tokens(self, prev: _Inflight, scr):
        """The previous dispatch's sampled tokens, still on the card,
        re-padded there (pad rows stay clones of row 0) as the next step's
        (pad_to, 1) input ids: no host round trip. The pad map is a device
        tensor made once per scratch."""
        toks = prev.out["tokens"].reshape(-1)
        if scr.pad_to > scr.b:
            if scr.gather_idx is None:
                idx = torch.zeros(scr.pad_to, dtype=torch.long)
                idx[:scr.b] = torch.arange(scr.b)
                if toks.device.type == "cuda":
                    idx = idx.pin_memory()
                scr.gather_idx = idx.to(toks.device, non_blocking=True)
            toks = toks.index_select(0, scr.gather_idx)
        return toks[:, None]

    def _retire(self, rec: _Inflight) -> Dict[int, int]:
        """Fetch ``rec``'s tokens (the one blocking wait of the pipelined
        path) and apply the deferred host bookkeeping. Raises the raw
        fetch failure: callers route it through :meth:`_abort_pipeline`."""
        if _FAULTS.active:
            _FAULTS.fire("pipeline_flush")
        overlap = time.perf_counter() - rec.t_dispatch
        new = self._fetch_rows(rec.out, rec.b)
        res = {}
        for i, (s, st) in enumerate(zip(rec.live, rec.states)):
            if self.seqs.get(s) is not st:
                continue               # released or preempted in flight
            tok = int(new[i, 0])
            self._append_token(st, tok)
            res[s] = tok
        self.telemetry.on_step(list(res), rec.t_dispatch, padded=rec.pad_to)
        self.telemetry.on_fetch(1, overlap_s=overlap)
        self.telemetry.on_dispatch(0)
        return res

    def _retire_or_abort(self, records: List[Optional[_Inflight]]
                         ) -> Dict[int, int]:
        try:
            return self._retire(records[0])
        except Exception as e:
            self._abort_pipeline(records, e)

    def _abort_pipeline(self, records: Sequence[Optional[_Inflight]],
                        cause: Exception):
        """A deferred fetch failed: the in-flight step's output (and any
        dispatch issued on top of it) is garbage. Unwind every in-flight
        dispatch's host bookkeeping (positions, paged KV growth) to the
        last DELIVERED token and raise a :class:`StepFailure` with
        ``retry_safe=False`` (the failed chain wrote the cache in place)."""
        self._scratch = None
        seq_ids: Tuple[int, ...] = ()
        for rec in records:
            if rec is None:
                continue
            if not seq_ids:
                seq_ids = rec.live
            for s, st in zip(rec.live, rec.states):
                if self.seqs.get(s) is st:
                    st.position -= 1
            self._unwind_inflight_growth(rec)
        self.telemetry.on_dispatch(0)
        self.telemetry.on_step_failure("decode", self._tenant_of(seq_ids))
        raise _trace_error(StepFailure(
            "pipelined decode fetch failed; every in-flight lookahead step "
            "was rolled back to the last delivered token",
            phase="decode", seq_ids=seq_ids, retry_safe=False)) from cause

    # -- post-mortem snapshot ----------------------------------------------
    def debug_state(self) -> Dict[str, Any]:
        """Read-only host-side snapshot for post-mortems; JSON-able, never
        touches device state."""
        return {
            "engine": self.engine_name,
            "running_ids": [int(s) for s in sorted(self.seqs)],
            "positions": {int(s): int(st.position)
                          for s, st in self.seqs.items()},
            "tenants": {int(s): _meta_tenant(st.meta)
                        for s, st in self.seqs.items()},
            "pipeline_inflight": (0 if self._inflight is None
                                  else len(self._inflight.live)),
            "ready_undelivered": [int(s) for s in sorted(self._ready)],
            "host_stats": dict(self.host_stats),
        }


def adapter_tier_salt(name: str) -> bytes:
    """The salt of the spill tier's and the handoff records' chains for a
    row under the pooled LoRA adapter ``name``: one adapter, whatever its
    slot or engine (a name names one adapter's weights across engines
    that share a tier or trade records)."""
    return b"lora-adapter:" + name.encode("utf-8")


def tier_chain(prompt: Sequence[int], block_size: int,
               salt: bytes) -> List[bytes]:
    """The chain hashes of ``prompt``'s full blocks from ``salt``."""
    out, parent = [], salt
    for bi in range(len(prompt) // block_size):
        parent = _hash_block(parent, prompt[bi * block_size:
                                            (bi + 1) * block_size])
        out.append(parent)
    return out


class ContinuousBatchingAdapter(_EngineAdapterBase):
    """Engine adapter over the contiguous app (built with
    ``is_continuous_batching=True``): each request owns cache row
    ``seq_id`` in ``[0, batch_size)``."""

    engine_name = "cb"

    def __init__(self, app, telemetry=None, pipeline_depth: int = 0):
        cfg = app.tpu_config
        if pipeline_depth:
            refuse_over_mesh(app, "pipeline_depth=1")
        if not cfg.is_continuous_batching:
            raise ConfigurationError("app must be built with "
                                     "is_continuous_batching=True")
        if app.cache is None:
            app.init_cache()
        self.app = app
        self.batch = cfg.batch_size
        self.seqs: Dict[int, _SeqState] = {}
        self.telemetry = _AdapterTelemetry("cb", telemetry)
        # a rolling cache (slot = pos % w) decodes past seq_len
        self._pos_limit = (None if app.spec.rolling_window
                           else cfg.seq_len)
        # free rows, ascending — maintained incrementally on add/release
        self._free: List[int] = list(range(self.batch))
        self._init_decode_path(pipeline_depth)

    @property
    def free_slots(self) -> List[int]:
        return list(self._free)

    def add_requests(self, seq_ids: Sequence[int],
                     prompts: Sequence[Sequence[int]],
                     deadline_s: Union[None, float,
                                       Sequence[Optional[float]]] = None
                     ) -> Dict[int, int]:
        """Prefill ``prompts`` into cache rows ``seq_ids``: {seq_id: first
        generated token}. Rows are padded to the ctx bucket, the batch to a
        batch bucket by repeating row 0. A failure admits nothing (the rows
        written hold garbage only for seq_ids no live row reads)."""
        _validate_admission(seq_ids, prompts, self.app.tpu_config.seq_len)
        for sid in seq_ids:
            if not 0 <= sid < self.batch:
                raise AdmissionError(f"seq_id {sid} out of range "
                                     f"[0,{self.batch})")
            if sid in self.seqs:
                raise AdmissionError(f"seq_id {sid} already running")
        t0 = time.perf_counter()
        deadlines = _resolve_deadlines(deadline_s, len(seq_ids), t0)
        b = len(seq_ids)
        lens = np.asarray([len(p) for p in prompts], np.int32)
        try:
            width = autobucketing.get_target_bucket(self.app.ctx_buckets,
                                                    int(lens.max()))
        except ValueError as e:
            raise AdmissionError(f"prompt does not fit any context-encoding "
                                 f"bucket: {e}") from e
        ids = np.zeros((b, width), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
        pad_to = self._batch_bucket(b)
        sid = np.asarray(seq_ids, np.int32)
        if pad_to > b:
            ids, sid, lens_p = (_repeat_row0(x, pad_to)
                                for x in (ids, sid, lens))
        else:
            lens_p = lens
        try:
            out = self.app._run_prefill(ids, lens_p, seq_ids=sid)
            toks = out["tokens"].cpu().numpy()[:b]
        except ServingError:
            raise
        except Exception as e:
            self.telemetry.on_step_failure("prefill")
            raise _trace_error(StepFailure(
                "prefill device step failed; no sequences were admitted",
                phase="prefill", seq_ids=seq_ids, retry_safe=False)) from e
        res = {}
        for i, s in enumerate(seq_ids):
            self.seqs[s] = _SeqState(
                position=int(lens[i]), last_token=int(toks[i]),
                prompt_len=int(lens[i]), deadline=deadlines[i])
            del self._free[bisect.bisect_left(self._free, s)]
            res[s] = int(toks[i])
        self.telemetry.on_add(seq_ids, prompts, t0, live=b, padded=pad_to)
        return res

    def release(self, seq_ids: Sequence[int]):
        if self._inflight is not None:
            self._stash_flush()
        for sid in seq_ids:
            self._ready.pop(sid, None)
            if self.seqs.pop(sid, None) is not None:
                bisect.insort(self._free, sid)
                self._scratch = None
        self.telemetry.on_release(seq_ids)

    def _scratch_for(self, live: Sequence[int]) -> _CbScratch:
        pad_to = self._batch_bucket(len(live))
        scr = self._scratch
        if scr is None or scr.live != tuple(live) or scr.pad_to != pad_to:
            scr = self._scratch = _CbScratch(live, pad_to)
        return scr

    def _dispatch_decode(self, scr: _CbScratch, toks_dev=None):
        """Issue ONE decode step without waiting on the card: the token
        copy to the host starts behind it (:func:`_async_fetch`), the
        fetch is the caller's. ``toks_dev``: the previous dispatch's tokens
        on the card (pipelined feedback); None = the scratch's host
        tokens."""
        ids = scr.toks_p if toks_dev is None else toks_dev
        with self._request_context(scr.live):
            out = self.app._run_decode(ids, scr.pos_p, seq_ids=scr.sid_p)
        _async_fetch(out)
        self._note_dispatch(scr, toks_dev)
        return out

    def _run_many(self, live: List[int], num_steps: int):
        """Fused k-step decode through ``decode_loop``: one dispatch, one
        fetch. Returns (tokens (b, k), batch bucket)."""
        b = len(live)
        pad_to = self._batch_bucket(b)
        first = np.asarray([self.seqs[s].last_token for s in live], np.int32)
        pos = np.asarray([self.seqs[s].position for s in live], np.int32)
        sid = np.asarray(live, np.int32)
        if pad_to > b:
            first, pos, sid = (_repeat_row0(x, pad_to)
                               for x in (first, pos, sid))

        def run():
            out = self.app._run_decode_loop(first, pos, num_steps,
                                            seq_ids=sid)
            self.host_stats["dispatches"] += 1
            self.host_stats["device_steps"] += num_steps
            return self._fetch_rows(out, b)
        return self._run_guarded(live, num_steps, run), pad_to

    def _batch_bucket(self, b: int) -> int:
        if b > self.batch:
            raise CapacityError(f"live batch {b} exceeds compiled batch "
                                f"{self.batch}")
        return autobucketing.get_target_bucket(self.app.batch_buckets, b)


class PagedEngineAdapter(_EngineAdapterBase):
    """Continuous-batching adapter over the paged application: block
    tables keyed by seq_id, slot mappings computed from the tables.

    ``prefill_chunk_tokens`` bounds one sequence's per-dispatch prefill
    chunk (default: the largest ctx bucket); ``prefill_budget_tokens``
    defers prefill to ``step()`` (``add_requests`` returns ``{}``, each
    step runs at most one packed chunk dispatch of at most that many
    prompt tokens before its decode work).

    ``ragged=True`` routes every step through ONE mixed dispatch of the
    live decode rows and the pending prefill chunks
    (:class:`~.ragged.RaggedDispatchPath`); admission then always defers
    and ``prefill_budget_tokens`` caps the prompt tokens packed per
    step."""

    engine_name = "paged"

    def __init__(self, app, telemetry=None,
                 preemption_policy: Optional[str] = "lifo",
                 pipeline_depth: int = 0,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_budget_tokens: Optional[int] = None,
                 speculation=None, kv_spill_tier=None,
                 ragged: bool = False, lora_pool=None):
        cfg = app.tpu_config
        if not cfg.is_block_kv_layout:
            raise ConfigurationError("app must be built with "
                                     "is_block_kv_layout=True")
        for bad, what in ((pipeline_depth, "pipeline_depth=1"),
                          (speculation is not None, "speculation"),
                          (kv_spill_tier is not None, "the KV spill tier"),
                          (lora_pool is not None, "multi-LoRA")):
            if bad:
                refuse_over_mesh(app, what)
        if (preemption_policy is not None
                and preemption_policy not in PREEMPTION_POLICIES):
            raise ConfigurationError(
                f"unknown preemption_policy {preemption_policy!r}; expected "
                f"one of {PREEMPTION_POLICIES} or None")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ConfigurationError("prefill_chunk_tokens must be >= 1")
        if prefill_budget_tokens is not None and prefill_budget_tokens < 1:
            raise ConfigurationError("prefill_budget_tokens must be >= 1")
        if app.cache is None:
            app.init_cache()
        self.app = app
        self.batch = cfg.batch_size
        self.seqs: Dict[int, _SeqState] = {}
        self.telemetry = _AdapterTelemetry("paged", telemetry)
        self.preemption_policy = preemption_policy
        self.preempted: List[Preempted] = []
        self._admit_counter = 0
        self._pos_limit = cfg.seq_len
        self._chunk_widths = autobucketing.prefill_chunk_buckets(
            app.ctx_buckets, prefill_chunk_tokens)
        self.prefill_chunk_tokens = (
            min(prefill_chunk_tokens, self._chunk_widths[-1])
            if prefill_chunk_tokens is not None else self._chunk_widths[-1])
        self.prefill_budget_tokens = prefill_budget_tokens
        self._chunks: Dict[int, _ChunkState] = {}   # pending admissions
        self._unwritten: set = set()   # allocated blocks not fully written
        self._init_decode_path(pipeline_depth)
        # the host-RAM KV spill tier: evicted prefix blocks spill their
        # payloads to host RAM and come back by an in-place H2D write
        # instead of a recompute
        self._kv_tier = kv_spill_tier
        # block -> (its prefix-cache hash, its tier key, its adapter) as
        # its admission named it: the spill hook files a block under the
        # tier key only while the block still holds that content
        self._tier_keys: Dict[int, Tuple[bytes, bytes, Optional[str]]] = {}
        self.host_stats["kv_spilled_blocks"] = 0
        self.host_stats["kv_restored_blocks"] = 0
        if kv_spill_tier is not None:
            app.kv_mgr.set_spill_hook(self._spill_block)
        # the multi-LoRA pool: a request's meta "adapter" resolves to a
        # pinned device slot at admission; every dispatch then carries the
        # rows' slots, so one step mixes rows of different adapters
        if (lora_pool is not None
                and getattr(lora_pool, "app", None) is not app):
            raise ConfigurationError(
                "lora_pool must be built over THIS adapter's application "
                "(its stacked slots back the per-row gather)")
        self._lora_pool = lora_pool
        self._lora_slots: Dict[int, int] = {}   # seq_id -> pinned slot
        self._lora_names: Dict[int, str] = {}
        self._adapter_shed = False
        if lora_pool is not None:
            self.host_stats["lora_rows"] = 0
            self.host_stats["lora_shed_requests"] = 0
        # degradation actuators: set_ragged_shed routes steps through the
        # two-phase template; set_speculation_shed clamps windows to 1;
        # set_adapter_shed admits adapter requests as base-model rows
        self._ragged_shed = False
        self._spec_shed = False
        self._ragged = None
        self._spec = None
        if speculation is not None:
            # deferred import: speculation/ imports this module
            from .speculation import SelfDraftProposer
            if isinstance(speculation, int):
                speculation = SelfDraftProposer(speculation)
        if ragged:
            from .ragged import RaggedDispatchPath
            self._ragged = RaggedDispatchPath(self, speculation)
        elif speculation is not None:
            from .speculation import SpeculativeDecodePath
            self._spec = SpeculativeDecodePath(self, speculation)

    # -- admission ---------------------------------------------------------
    def add_requests(self, seq_ids: Sequence[int],
                     prompts: Sequence[Sequence[int]],
                     deadline_s: Union[None, float,
                                       Sequence[Optional[float]]] = None,
                     meta: Optional[Sequence[Any]] = None
                     ) -> Dict[int, int]:
        """Transactional admission: either every sequence is admitted, or
        every allocation from this call is rolled back (pool pressure may
        still preempt RUNNING sequences first; that eviction survives a
        rollback). Returns {seq_id: first token}, or ``{}`` when prefill
        is deferred to ``step()`` (``prefill_budget_tokens`` or
        ``ragged=True``)."""
        _validate_admission(seq_ids, prompts, self.app.tpu_config.seq_len)
        for sid in seq_ids:
            if sid in self.seqs or sid in self._chunks:
                raise AdmissionError(f"seq_id {sid} already running")
        live_now = len(self.seqs) + len(self._chunks)
        if live_now + len(seq_ids) > self.batch:
            raise AdmissionError(
                f"admitting {len(seq_ids)} sequences would put "
                f"{live_now + len(seq_ids)} live/pending rows on a "
                f"batch of {self.batch}")
        t0 = time.perf_counter()
        deadlines = _resolve_deadlines(deadline_s, len(seq_ids), t0)
        if meta is not None and len(meta) != len(seq_ids):
            raise AdmissionError("meta and seq_ids length mismatch")
        metas = list(meta) if meta is not None else [None] * len(seq_ids)
        mgr = self.app.kv_mgr
        bs = mgr.spec.block_size
        protect = frozenset(seq_ids)
        begun: List[int] = []
        try:
            for i, sid in enumerate(seq_ids):
                prompt = list(prompts[i])
                # the adapter's slot first: it salts the prefix cache
                self._bind_adapter(sid, metas[i])
                salt = self._kv_salt(sid)
                while True:
                    try:
                        blocks, c = mgr.begin_sequence(sid, prompt,
                                                       salt=salt)
                        begun.append(sid)
                        break
                    except CapacityError:
                        # never evict a sibling of this very call
                        victim = self._choose_victim(exclude=protect)
                        if victim is None:
                            raise
                        self._preempt(victim, reason="admission")
                # a hit on a block another pending sequence has not fully
                # written yet must be recomputed, not trusted
                n_hit = int(c) // bs
                c = cut_cached_at_unwritten(blocks, int(c), bs,
                                            self._unwritten)
                c = min(c, len(prompt) - 1)
                self._unwritten.update(blocks[n_hit:])
                if self._kv_tier is not None:
                    # restore instead of recompute: the spilled full
                    # blocks past the device hit, written in place; they
                    # stay unwritten until the row's last chunk lands,
                    # like chunk-written blocks
                    c = self._tier_admit(sid, prompt, blocks, c)
                self._admit_counter += 1
                self._chunks[sid] = _ChunkState(
                    prompt=prompt, done=int(c),
                    admit_idx=self._admit_counter, t0=t0,
                    deadline=deadlines[i], meta=metas[i])
        except ServingError:
            self._rollback_admission(begun)
            self._lora_release_all(seq_ids)
            raise
        except Exception as e:
            self._rollback_admission(begun)
            self._lora_release_all(seq_ids)
            self.telemetry.on_step_failure(
                "prefill", _common_tenant(map(_meta_tenant, metas)))
            raise _trace_error(StepFailure(
                "paged admission failed; all allocations from this call "
                "were rolled back", phase="prefill", seq_ids=seq_ids,
                retry_safe=True)) from e
        if self.prefill_budget_tokens is not None or self._ragged is not None:
            # deferred: step() drives the chunks (ragged mode always
            # defers — the unified dispatch packs chunk rows WITH decode
            # rows, so admission never serializes its own device work)
            return {}
        try:
            while any(s in self._chunks for s in seq_ids):
                self._prefill_step(only=protect, defer_telemetry=True)
        except ServingError:
            self._rollback_admission(begun)
            raise
        except Exception as e:
            self._rollback_admission(begun)
            self.telemetry.on_step_failure(
                "prefill", _common_tenant(map(_meta_tenant, metas)))
            raise _trace_error(StepFailure(
                "paged prefill failed; all allocations from this call were "
                "rolled back", phase="prefill", seq_ids=seq_ids,
                retry_safe=False)) from e
        # telemetry only once the WHOLE call is past rollback
        self.telemetry.on_add(seq_ids, prompts, t0, live=len(seq_ids),
                              padded=len(seq_ids), count_rows=False,
                              tenants=[_meta_tenant(m) for m in metas])
        return {s: self._ready.pop(s) for s in seq_ids}

    def release(self, seq_ids: Sequence[int]):
        if self._inflight is not None:
            self._stash_flush()
        proposer = self._active_proposer
        if proposer is not None:
            proposer.forget(seq_ids)
        for sid in seq_ids:
            self._ready.pop(sid, None)
            self._lora_release(sid)
            if sid in self._chunks:
                self._abort_prefill_rows([sid])
                continue
            if sid in self.seqs:
                self.seqs.pop(sid)
                self._scratch = None
                if sid in self.app.kv_mgr.tables:
                    self.app.kv_mgr.end_sequence(sid)
        self.telemetry.on_release(seq_ids)

    # -- step routing (speculation, the ragged unified dispatch) ------------
    def step(self, seq_ids: Optional[Sequence[int]] = None,
             token_room: Optional[Dict[int, int]] = None):
        """One decode step, {seq_id: token} (see the base class). With
        ``speculation=`` the step is draft-and-verify and returns {seq_id:
        [tokens]} with 1..k+1 tokens a row; with ``ragged=True`` every
        step is ONE unified mixed dispatch through serving/ragged/ and
        returns {seq_id: [tokens]}; ``token_room`` (scheduler hook) caps
        each row's tokens for the step. With the ragged path SHED
        (:meth:`set_ragged_shed`) the step falls back to two-phase
        dispatching: through the speculative path when a proposer is
        attached, else the plain chunk-then-decode template. Tokens are
        the same either way, only the dispatch count changes."""
        if self._ragged is not None:
            if not self._ragged_shed:
                return self._ragged.step(seq_ids, token_room)
            if self._ragged.spec_path is not None:
                return self._ragged.spec_path.step(seq_ids, token_room)
            return super().step(seq_ids)   # 1 token/row: room is honored
        if self._spec is not None:
            return self._spec.step(seq_ids, token_room)
        if token_room is not None:
            raise ConfigurationError(
                "token_room is a speculative-decode hook; build the "
                "adapter with speculation= or ragged=True to use it")
        return super().step(seq_ids)

    def step_many(self, num_steps: int,
                  seq_ids: Optional[Sequence[int]] = None
                  ) -> Dict[int, List[int]]:
        """Fused multi-step decode (base class). With ``speculation=`` or
        ``ragged=True`` ``num_steps`` is a per-row TOKEN budget: engine
        steps run (each one materialized dispatch) until every row has
        delivered it, and no row overshoots."""
        if self._ragged is None and self._spec is None:
            return super().step_many(num_steps, seq_ids)
        if num_steps < 1:
            raise ConfigurationError("step_many requires num_steps >= 1")
        out: Dict[int, List[int]] = {}
        remaining: Dict[int, int] = {}
        targets = seq_ids                  # validated on the first pass only
        for _ in range(num_steps):
            live = _live_rows(self.seqs, targets, self._pending_ids())
            if seq_ids is not None:
                # rows preempted mid-loop must not fail later passes
                targets = [s for s in seq_ids
                           if s in self.seqs or s in self._chunks]
            ids = [s for s in live if remaining.get(s, num_steps) > 0]
            if not ids and not self._pending_ids():
                break
            room = {s: remaining.get(s, num_steps) for s in ids}
            # through step() so the shed flags apply here too (a shed
            # plain step returns {seq_id: token})
            res = self.step(ids, token_room=room)
            if not res and not ids:
                break                  # pending-only pass made no tokens
            for s, toks in res.items():
                toks = toks if isinstance(toks, list) else [toks]
                out.setdefault(s, []).extend(toks)
                remaining[s] = remaining.get(s, num_steps) - len(toks)
        return out

    @property
    def _active_proposer(self):
        """The draft proposer of whichever path is engaged (the speculative
        path or the ragged path), None without speculation."""
        if self._spec is not None:
            return self._spec.proposer
        if self._ragged is not None:
            return self._ragged.proposer
        return None

    @property
    def speculation_shed(self) -> bool:
        return self._spec_shed

    @property
    def ragged_shed(self) -> bool:
        return self._ragged_shed

    def set_speculation_shed(self, shed: bool) -> None:
        """Degradation actuator: clamp every draft window to width 1, so
        steps run the width-1 verify — no draft dispatches, tokens
        unchanged. Engaging it drops the proposer's per-sequence state.
        Reversible; a no-op without a proposer."""
        shed = bool(shed)
        if shed == self._spec_shed:
            return
        self._spec_shed = shed
        proposer = self._active_proposer
        if shed and proposer is not None and self.seqs:
            proposer.forget(list(self.seqs))

    def set_ragged_shed(self, shed: bool) -> None:
        """Degradation actuator: route steps through the two-phase (chunk
        dispatch + decode or verify dispatch) template instead of the
        unified ragged dispatch — see :meth:`step`. Reversible; a no-op
        without ``ragged=True``."""
        self._ragged_shed = bool(shed)

    @property
    def adapter_shed(self) -> bool:
        return self._adapter_shed

    def set_adapter_shed(self, shed: bool) -> None:
        """Degradation actuator (reference :1655-1664): admit NEW
        adapter-tagged requests as base-model rows, with no pool acquire
        (no swap traffic while burning). Running rows keep their pinned
        slots; a shed admission's meta mapping is annotated
        ``lora_shed=True``. Reversible; a no-op without a pool."""
        self._adapter_shed = bool(shed)

    # -- decode hooks ------------------------------------------------------
    _decode_failure_msg = ("paged decode step failed; KV growth was rolled "
                           "back")

    def _pending_ids(self):
        return self._chunks.keys()

    def _grow_for_step(self, live: List[int], n: int = 1) -> List[int]:
        return self._grow_with_preemption(live, n)

    def _rollback_step_growth(self, live: Sequence[int], n: int = 1):
        self._rollback_grow(live, n)

    _step_growth = 1

    def _unwind_inflight_growth(self, rec: _Inflight):
        if not rec.grown:
            return
        for s, st in zip(rec.live, rec.states):
            if self.seqs.get(s) is st and s in self.app.kv_mgr.tables:
                self.app.kv_mgr.shrink(s, rec.grown)

    def _append_token(self, st: _SeqState, tok: int):
        st.last_token = tok
        st.tokens.append(tok)

    def _scratch_for(self, live: Sequence[int]) -> _PagedScratch:
        app = self.app
        pad_to = autobucketing.get_target_bucket(app.batch_buckets,
                                                 len(live))
        width = app._bt_width_for(live)
        scr = self._scratch
        if (scr is None or scr.live != tuple(live) or scr.pad_to != pad_to
                or scr.width != width):
            scr = self._scratch = _PagedScratch(
                live, pad_to, width, app.kv_mgr.spec.block_size,
                [_meta_seed(self.seqs[s].meta) for s in live],
                aids=self._lora_aids(live))
        return scr

    def _dispatch_decode(self, scr: _PagedScratch, toks_dev=None):
        """Issue ONE paged decode step without waiting on the card (the
        token copy to the host starts behind it, the fetch is the
        caller's); in steady state an unexpected graph signature is
        attributed to the batched requests' traces. ``toks_dev``: the
        previous dispatch's tokens on the card (pipelined feedback); None
        = the scratch's host tokens."""
        ids = scr.ids if toks_dev is None else toks_dev
        with self._request_context(scr.live):
            out = self.app._run_paged(ids, scr.pos, scr.slots, scr.bt,
                                      scr.last, row_seeds=scr.seeds,
                                      adapter_ids=scr.aids)
        _async_fetch(out)
        self._note_dispatch(scr, toks_dev)
        return out

    def _run_many(self, live: List[int], num_steps: int):
        """Fused k-step decode (``paged_decode_loop``): blocks for the whole
        horizon are allocated already; slots advance on the device.
        Returns (tokens (b, k), batch bucket)."""
        app = self.app
        b = len(live)
        pad_to = autobucketing.get_target_bucket(app.batch_buckets, b)
        bt = app.kv_mgr.block_table_array(live, app._bt_width_for(live))
        first = np.asarray([self.seqs[s].last_token for s in live],
                           np.int32)
        pos = np.asarray([self.seqs[s].position for s in live], np.int32)
        seeds = np.asarray([_meta_seed(self.seqs[s].meta) for s in live],
                           np.int32)
        aids = self._lora_aids(live)
        if aids is not None:
            aids = np.asarray(aids, np.int32)
        if pad_to > b:
            first, pos, bt, seeds = (_repeat_row0(x, pad_to)
                                     for x in (first, pos, bt, seeds))
            if aids is not None:
                aids = _repeat_row0(aids, pad_to)

        def run():
            with self._request_context(live):
                out = app._run_paged_loop(first, pos, bt, num_steps,
                                          row_seeds=seeds,
                                          adapter_ids=aids)
            self.host_stats["dispatches"] += 1
            self.host_stats["device_steps"] += num_steps
            return self._fetch_rows(out, b)
        return self._run_guarded(live, num_steps, run), pad_to

    # -- scheduler hooks ---------------------------------------------------
    @property
    def running_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self.seqs))

    @property
    def pending_prefill_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self._chunks,
                            key=lambda s: self._chunks[s].admit_idx))

    @property
    def free_capacity(self) -> int:
        return self.batch - len(self.seqs) - len(self._chunks)

    def prefix_warmth(self, prompt: Sequence[int],
                      adapter: Optional[str] = None) -> int:
        """READ-ONLY probe: how many leading tokens of ``prompt`` an
        admission right now would serve from the prefix cache (cut at the
        first block a pending admission has not written yet, capped at
        ``len(prompt) - 1``). The engine orders admissions warm-first.

        ``adapter`` (the request's named LoRA adapter) adds
        ``prefill_chunk_tokens`` when a pool is attached and holds the
        adapter resident (the admission saves a swap), so a router lands
        a tenant's requests where their adapter lives (reference
        :1843-1880), and probes the blocks cached under that adapter's
        salt (none for an adapter that is not resident: its swap-in will
        salt anew). The residency probe never touches the pool's LRU."""
        salt = b""
        resident = False
        named = (adapter is not None and self._lora_pool is not None
                 and not self._adapter_shed)
        if named:
            resident = self._lora_pool.resident(adapter)
            # a cold adapter gets a fresh salt: nothing is cached under it
            salt = (self.app.lora_kv_salt(self._lora_pool.slot_of(adapter))
                    if resident else None)
        cached, blocks = ((0, []) if salt is None else
                          self.app.kv_mgr.probe_cached_tokens(prompt, salt))
        if cached and self._unwritten:
            cached = cut_cached_at_unwritten(
                blocks, cached, self.app.kv_mgr.spec.block_size,
                self._unwritten)
        if self._kv_tier is not None:
            # spilled blocks count too (an admission would restore them),
            # under the tier's salt: a cold adapter may have some
            tsalt = (self._name_tier_salt(adapter) if named
                     else self._base_tier_salt())
            if tsalt is not None:
                cached = self._tier_warmth(prompt, cached, tsalt)
        warmth = min(cached, len(prompt) - 1)
        if resident:
            warmth += self.prefill_chunk_tokens
        return warmth

    def debug_state(self) -> Dict[str, Any]:
        """Base snapshot plus pending chunked admissions, batch headroom,
        block-pool occupancy and uncollected preemption records."""
        state = super().debug_state()
        mgr = self.app.kv_mgr
        usable = mgr.spec.num_blocks - 1          # block 0 is the null block
        free = int(mgr.allocator.num_free)
        state.update({
            "pending_prefill": {
                int(s): {"done": int(c.done), "total": len(c.prompt),
                         "tenant": _meta_tenant(c.meta)}
                for s, c in self._chunks.items()},
            "free_capacity": self.free_capacity,
            "blocks": {"usable": usable, "free": free,
                       "in_use": usable - free,
                       "unwritten": len(self._unwritten)},
            "preempted_uncollected": [int(r.seq_id) for r in self.preempted],
            "ragged": self._ragged is not None,
            "allocator": mgr.allocator_kind,
        })
        if self._kv_tier is not None:
            state["kv_tier"] = {"blocks": len(self._kv_tier),
                                "bytes": int(self._kv_tier.nbytes),
                                "stats": dict(self._kv_tier.stats)}
        if self._lora_pool is not None:
            state["lora"] = {
                "rows": {int(s): int(slot)
                         for s, slot in self._lora_slots.items()},
                "shed": self._adapter_shed,
                "pool": self._lora_pool.debug_state(),
            }
        return state

    # -- the host-RAM KV spill tier (serving/fleet/kv_tier.py) --------------
    def _base_tier_salt(self) -> Optional[bytes]:
        """A base row's tier salt: b"", or None when slot 0 was written
        on this engine (its prefix-cache salt is then local to it)."""
        return b"" if self.app.lora_kv_salt(0) == b"" else None

    def _name_tier_salt(self, name: str) -> Optional[bytes]:
        """A pooled adapter's tier salt, or None once its slot was written
        outside the pool (``LoraAdapterPool.portable``)."""
        return (adapter_tier_salt(name) if self._lora_pool.portable(name)
                else None)

    def tier_salt(self, sid: int) -> Optional[bytes]:
        """The salt of ``sid``'s tier and handoff chains
        (:func:`adapter_tier_salt` of its pooled adapter, b"" for a base
        row), or None when its KV must not leave this engine."""
        name = self._lora_names.get(sid)
        if name is not None:
            return self._name_tier_salt(name)
        return self._base_tier_salt()

    def _tier_admit(self, sid: int, prompt: List[int], blocks: List[int],
                    done: int) -> int:
        """At admission: name each full block by its tier key (for the
        spill hook) and restore the spilled blocks past ``done``. Returns
        the new ``done``."""
        tsalt = self.tier_salt(sid)
        if tsalt is None:
            return done
        chain = tier_chain(prompt, self.app.kv_mgr.spec.block_size, tsalt)
        meta = getattr(self.app.kv_mgr.allocator, "meta", {})
        name = self._lora_names.get(sid)
        for bi, key in enumerate(chain):
            m = meta.get(blocks[bi])
            if m is not None and m.content_hash is not None:
                self._tier_keys[blocks[bi]] = (m.content_hash, key, name)
        return self._restore_spilled(sid, len(prompt), blocks, done, chain)

    def _spill_block(self, blk: int, content_hash: bytes) -> None:
        """The manager's eviction hook: copy an LRU-evicted prefix block's
        payload device → host into the tier under the tier key its
        admission recorded (a block no admission named, or one whose salt
        is local to this engine, is not spilled). Best-effort: a failure
        (the ``kv_spill`` fault point included) is counted, never raised
        into the allocation that evicted the block.

        The read runs on the cache's stream inside ``allocate`` /
        ``extend``, between dispatches: stream order puts it after every
        write queued before it, and it syncs the host with the card."""
        key = self._tier_keys.pop(blk, None)
        if (blk in self._unwritten or key is None
                or key[0] != content_hash
                or (key[2] is not None
                    and not self._lora_pool.portable(key[2]))):
            return
        try:
            cache = self.app.cache
            self._kv_tier.spill(key[1],
                                cache["k"][:, blk].to("cpu", copy=True),
                                cache["v"][:, blk].to("cpu", copy=True))
            self.host_stats["kv_spilled_blocks"] += 1
        except Exception:
            self._kv_tier.stats["spill_errors"] += 1

    def _tier_warmth(self, prompt: Sequence[int], cached: int,
                     salt: bytes) -> int:
        """Extend the device prefix hit with the consecutive spilled full
        blocks an admission would restore now (read-only)."""
        bs = self.app.kv_mgr.spec.block_size
        warm = cached
        for bi, key in enumerate(tier_chain(prompt, bs, salt)):
            if (bi + 1) * bs <= cached:
                continue                   # on the device already
            if bi * bs != warm or not self._kv_tier.contains(key):
                break
            warm = (bi + 1) * bs
        return warm

    def _restore_spilled(self, sid: int, n_prompt: int, blocks: List[int],
                         done: int, chain: List[bytes]) -> int:
        """Restore the consecutive spilled full blocks past ``done`` (the
        device hit after its cut) and return the new ``done``, capped at
        ``n_prompt - 1`` like a prefix hit (the last token always runs;
        a restored block that holds it is partly rewritten by the final
        chunk). The ``kv_restore`` fault point fires before the write, so
        the admission's rollback is exact."""
        tier = self._kv_tier
        bs = self.app.kv_mgr.spec.block_size
        limit = n_prompt - 1
        restores: List[Tuple[int, Any]] = []
        new_done = done
        for bi, key in enumerate(chain):
            if (bi + 1) * bs <= new_done:
                continue                   # on the device already
            if bi * bs != new_done or new_done >= limit:
                break                      # a gap or the cap: stop
            payload = tier.get(key)
            if payload is None:
                break
            restores.append((blocks[bi], payload))
            new_done = min((bi + 1) * bs, limit)
        if not restores:
            return done
        if _FAULTS.active:
            _FAULTS.fire("kv_restore")
        self._apply_block_payloads(restores)
        n_tok = new_done - done
        tier.note_restored(len(restores), n_tok)
        self.host_stats["kv_restored_blocks"] += len(restores)
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("kv.restore", cat="fleet", engine=self.engine_name,
                        seq_id=int(sid), blocks=len(restores),
                        tokens=n_tok)
        return new_done

    def _apply_block_payloads(self, restores) -> None:
        """Write spilled payloads into their freshly allocated device
        blocks IN PLACE (the captured graphs hold the cache's addresses;
        the reference rebinds the cache): per K and V one host-to-device
        copy of the stacked payloads and one indexed write, on the
        cache's stream, which every later dispatch follows. An fp8 cache
        is written through its uint8 view. A payload of another dtype or
        block shape is refused, never cast."""
        cache = self.app.cache
        idx = torch.tensor([b for b, _ in restores], dtype=torch.long)
        for name in ("k", "v"):
            dst = cache[name]
            want = (dst.dtype, (dst.shape[0], *dst.shape[2:]))
            parts = [p[name] for _, p in restores]
            for t in parts:
                if (t.dtype, tuple(t.shape)) != want:
                    raise KVCacheStateError(
                        f"a spilled {name} payload {t.dtype} "
                        f"{tuple(t.shape)} does not fit the cache's "
                        f"{want[0]} {want[1]} blocks")
            if dst.is_floating_point() and dst.element_size() == 1:
                dst = dst.view(torch.uint8)
                parts = [t.view(torch.uint8) for t in parts]
            dst.index_copy_(1, idx.to(dst.device),
                            torch.stack(parts, dim=1).to(
                                dst.device, non_blocking=True))

    # -- the multi-LoRA adapter pool (serving/lora_pool.py) -----------------
    def _bind_adapter(self, sid: int, meta: Any) -> None:
        """Resolve a request's named adapter (meta "adapter") to a pinned
        device slot at admission. Shed (``set_adapter_shed``): admitted as
        a base-model row, no acquire, meta annotated ``lora_shed=True``. A
        typed acquire failure (:class:`CapacityError`: every slot pinned;
        :class:`StepFailure`: the swap failed, rolled back) propagates
        into the admission's rollback."""
        if self._lora_pool is None:
            return
        name = _meta_adapter(meta)
        if name is None:
            return
        if self._adapter_shed:
            self.host_stats["lora_shed_requests"] += 1
            try:
                meta["lora_shed"] = True
            except TypeError:
                pass
            return
        slot = self._lora_pool.acquire(name)
        self._lora_slots[sid] = slot
        self._lora_names[sid] = name
        self.host_stats["lora_rows"] += 1

    def _lora_release(self, sid: int) -> None:
        """Unpin ``sid``'s adapter slot (release, preemption, admission
        rollback); idempotent."""
        name = self._lora_names.pop(sid, None)
        if name is not None:
            self._lora_slots.pop(sid, None)
            self._lora_pool.release(name)

    def _lora_release_all(self, seq_ids) -> None:
        """Unpin the adapters an admission that failed bound (a row can
        hold its slot before its blocks are begun)."""
        for sid in seq_ids:
            self._lora_release(sid)

    def _kv_salt(self, sid: int) -> bytes:
        """The prefix-cache salt of ``sid``'s blocks: its adapter slot's
        (``app.lora_kv_salt``); base rows salt nothing."""
        slot = self._lora_slots.get(sid, 0)
        return self.app.lora_kv_salt(slot) if slot else b""

    def _lora_aids(self, sids) -> Optional[List[int]]:
        """The rows' device slots for a dispatch, or None: without a pool,
        or when every row is a base-model row (no adapter, or admitted
        shed), so a base-only pass runs the LoRA-free step and pays no
        deltas (slot 0's are zeros: the same tokens, bit for bit; the
        reference always passes the ids)."""
        if self._lora_pool is None:
            return None
        aids = [self._lora_slots.get(s, 0) for s in sids]
        return aids if any(aids) else None

    # -- preemption --------------------------------------------------------
    def preempt(self, seq_id: int, reason: str = "scheduler") -> Preempted:
        """Scheduler-driven eviction of one running or pending sequence;
        the record is returned AND queued for :meth:`take_preempted`."""
        if seq_id not in self.seqs and seq_id not in self._chunks:
            raise SequenceStateError(
                f"cannot preempt seq_id {seq_id}: not running or pending")
        self._preempt(seq_id, reason)
        return self.preempted[-1]

    def take_preempted(self) -> List[Preempted]:
        out, self.preempted = self.preempted, []
        return out

    def _choose_victim(self, exclude=frozenset()) -> Optional[int]:
        if self.preemption_policy is None:
            return None
        cands = [(sid, st.admit_idx, len(st.tokens) - st.prompt_len)
                 for sid, st in self.seqs.items()
                 if st.running and sid not in exclude]
        cands += [(sid, cst.admit_idx, 0)
                  for sid, cst in self._chunks.items()
                  if sid not in exclude]
        return pick_victim(self.preemption_policy, cands)

    def _preempt(self, victim: int, reason: str):
        self._ready.pop(victim, None)      # the replay regenerates it
        self._lora_release(victim)         # a requeue re-acquires via meta
        proposer = self._active_proposer
        if proposer is not None:
            # a stateful proposer must not carry the victim's state into a
            # re-admission under the same id
            proposer.forget((victim,))
        cst = self._chunks.pop(victim, None)
        if cst is not None:
            # half-prefilled victim: blocks not fully written leave the
            # prefix cache; the record's tokens are the bare prompt
            self._abort_pending(victim)
            tenant = _meta_tenant(cst.meta)
            self.preempted.append(Preempted(
                seq_id=victim, tokens=tuple(cst.prompt),
                prompt_len=len(cst.prompt), n_generated=0, reason=reason,
                deadline=cst.deadline, meta=cst.meta,
                trace_id=self._trace_preempt(victim, reason, tenant,
                                             pending=True,
                                             trace=_trace_of(cst.meta))))
            self.telemetry.on_preempt(victim, reason, tenant)
            return
        st = self.seqs.pop(victim)
        self._scratch = None
        if victim in self.app.kv_mgr.tables:
            self.app.kv_mgr.end_sequence(victim)
        tenant = _meta_tenant(st.meta)
        self.preempted.append(Preempted(
            seq_id=victim, tokens=tuple(st.tokens),
            prompt_len=st.prompt_len,
            n_generated=len(st.tokens) - st.prompt_len, reason=reason,
            deadline=st.deadline, meta=st.meta,
            trace_id=self._trace_preempt(victim, reason, tenant,
                                         trace=_trace_of(st.meta))))
        self.telemetry.on_preempt(victim, reason, tenant)

    def _trace_preempt(self, victim: int, reason: str, tenant: str,
                       pending: bool = False,
                       trace: Optional[str] = None) -> Optional[str]:
        rec = _get_recorder()
        if not rec.enabled:
            return None
        return rec.instant("preempt", cat="adapter",
                           engine=self.engine_name, seq_id=victim,
                           reason=reason, tenant=tenant, pending=pending,
                           trace=trace)

    def _grow_with_preemption(self, live: Sequence[int],
                              n: int = 1) -> List[int]:
        """Grow every live row by ``n`` tokens, evicting victims when the
        pool is dry; returns the rows still live. If eviction cannot free
        enough, this call's growth is rolled back and the
        :class:`CapacityError` propagates."""
        mgr = self.app.kv_mgr
        live = list(live)
        queue = list(live)
        grown: List[int] = []
        while queue:
            s = queue[0]
            try:
                mgr.grow(s, n)
            except CapacityError:
                victim = self._choose_victim()
                if victim is None:
                    for g in grown:
                        mgr.shrink(g, n)
                    raise
                self._preempt(victim, reason="grow")
                for lst in (queue, live, grown):
                    if victim in lst:
                        lst.remove(victim)
                continue
            queue.pop(0)
            grown.append(s)
        return live

    def _rollback_grow(self, live: Sequence[int], n: int = 1):
        for s in live:
            self.app.kv_mgr.shrink(s, n)

    def _rollback_admission(self, seq_ids: Sequence[int]):
        """Abort every sequence begun by a failing ``add_requests``, in
        REVERSE admission order (the originating sequence's invalidate must
        be the last dereference of an intra-call shared-prefix hash)."""
        for sid in reversed(list(seq_ids)):
            self._chunks.pop(sid, None)
            self._ready.pop(sid, None)
            self._lora_release(sid)
            if self.seqs.pop(sid, None) is not None:
                self._scratch = None
            self._abort_pending(sid)
        self.telemetry.on_admission_rollback()

    # -- chunked, packed prefill -------------------------------------------
    def _advance_prefill(self, seq_ids=None):
        if self._chunks:
            self._prefill_step(budget=self.prefill_budget_tokens,
                               target=seq_ids)

    def _prefill_step(self, budget: Optional[int] = None, only=None,
                      target=None, defer_telemetry: bool = False):
        """ONE packed chunk dispatch: pending sequences (admission order)
        each contribute their next uncached-suffix chunk as a row of one
        ctx-bucket ``_run_paged`` call, bounded by ``budget`` real prompt
        tokens. Sequences whose FINAL chunk lands become running rows with
        their first token in ``_ready``; intermediate samples are
        discarded. A failure rolls back every sequence of the dispatch.
        ``target`` is the step call's explicit seq_ids (None = all): an
        expired pending admission raises only when targeted.
        ``defer_telemetry`` (the transactional ``add_requests`` path)
        leaves the admission telemetry to the caller."""
        chunks = self._chunks
        order = sorted(chunks, key=lambda s: chunks[s].admit_idx)
        if only is not None:
            order = [s for s in order if s in only]
        now = time.perf_counter()
        expired = [s for s in order if chunks[s].deadline is not None
                   and now >= chunks[s].deadline]
        if expired:
            hit = (expired if target is None
                   else [s for s in expired if s in set(target)])
            if hit:
                fresh = [s for s in hit if not chunks[s].expired_reported]
                for s in fresh:
                    chunks[s].expired_reported = True
                self.telemetry.on_deadline(
                    fresh, [_meta_tenant(chunks[s].meta) for s in fresh])
                raise _trace_error(DeadlineExceeded(
                    f"seq_ids {hit} exceeded their wall-clock deadline "
                    "mid-prefill; release() them (or re-queue with a fresh "
                    "budget) and step again", seq_ids=hit))
            # expired but not targeted by this step: skip them without
            # stalling the targeted rows
            order = [s for s in order if s not in expired]
        rows: List[Tuple[int, int, int, bool]] = []
        left = float("inf") if budget is None else int(budget)
        for s in order:
            if len(rows) == self.batch or left < 1:
                break
            st = chunks[s]
            n = int(min(len(st.prompt) - st.done,
                        self.prefill_chunk_tokens, left))
            rows.append((s, st.done, n, st.done + n == len(st.prompt)))
            left -= n
        if not rows:
            return
        seq_list = tuple(s for s, *_ in rows)
        final_rows = [(i, s) for i, (s, _, _, fin) in enumerate(rows)
                      if fin]
        row_tenant = _common_tenant(_meta_tenant(chunks[s].meta)
                                    for s in seq_list)
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("prefill_chunk")
            *packed, seeds, aids = self._pack_prefill_rows(rows)
            dispatched = True
            out = self.app._run_paged(*packed, row_seeds=seeds,
                                      adapter_ids=aids)
            self.host_stats["prefill_dispatches"] += 1
            new = (self._fetch_prefill_tokens(out) if final_rows else None)
        except ServingError as e:
            self._abort_prefill_rows(seq_list)
            _trace_error(e)
            raise
        except Exception as e:
            self._abort_prefill_rows(seq_list)
            self.telemetry.on_step_failure("prefill", row_tenant)
            raise _trace_error(StepFailure(
                "chunked prefill dispatch failed; every partially-"
                "prefilled sequence packed in it was rolled back",
                phase="prefill", seq_ids=seq_list,
                retry_safe=not dispatched)) from e
        bs = self.app.kv_mgr.spec.block_size
        for s, _, n, _ in rows:
            chunks[s].done += n
        if final_rows:
            # the fetched tokens order this dispatch (and every earlier one
            # on the stream) before now: the covered blocks are written
            for s2, cst in chunks.items():
                self._unwritten.difference_update(
                    self.app.kv_mgr.tables[s2][:cst.done // bs])
        pad_rows, width = packed[0].shape
        real = sum(n for _, _, n, _ in rows)
        self.host_stats["prefill_real_tokens"] += real
        self.host_stats["prefill_padded_tokens"] += pad_rows * width
        self.telemetry.on_prefill_chunk(len(rows), pad_rows, real,
                                        pad_rows * width)
        for i, s in final_rows:
            st = chunks.pop(s)
            self._unwritten.difference_update(self.app.kv_mgr.tables[s])
            tok = int(new[i, 0])
            self.seqs[s] = _SeqState(
                position=len(st.prompt), last_token=tok,
                tokens=list(st.prompt) + [tok],
                prompt_len=len(st.prompt), admit_idx=st.admit_idx,
                deadline=st.deadline, meta=st.meta)
            self._scratch = None
            self._ready[s] = tok
            if not defer_telemetry:
                self.telemetry.on_add([s], [st.prompt], st.t0, live=1,
                                      padded=1, count_rows=False,
                                      tenants=[_meta_tenant(st.meta)])

    def _fetch_prefill_tokens(self, out) -> np.ndarray:
        """Materialize a final-chunk dispatch's sampled tokens (the one
        blocking copy of a packed admission)."""
        t0 = time.perf_counter()
        toks = out["tokens"].cpu().numpy()
        t1 = time.perf_counter()
        self.host_stats["prefill_blocking_fetches"] += 1
        self.host_stats["prefill_blocked_s"] += t1 - t0
        rec = _get_recorder()
        if rec.enabled:
            rec.complete("fetch.tokens", t0, cat="adapter", t1=t1,
                         engine=self.engine_name, phase="prefill")
        return toks.reshape(toks.shape[0], -1)

    def _pack_prefill_rows(self, rows):
        """Packed-chunk inputs: one row per sequence at its own suffix
        offset over its own block table; width = smallest ctx bucket
        covering the longest chunk; batch padded by repeating row 0. The
        last two are the rows' seeds and LoRA slots (None without a
        pool)."""
        app = self.app
        b = len(rows)
        width = autobucketing.get_target_bucket(
            self._chunk_widths, max(n for _, _, n, _ in rows))
        sids = [s for s, *_ in rows]
        bt = app.kv_mgr.block_table_array(sids, app._bt_width_for(sids))
        ids_w = np.zeros((b, width), np.int32)
        pos_w = np.zeros((b, width), np.int32)
        slot_pos = np.full((b, width), -1, np.int32)
        last = np.zeros((b,), np.int32)
        for i, (s, lo, n, fin) in enumerate(rows):
            st = self._chunks[s]
            ids_w[i, :n] = st.prompt[lo:lo + n]
            pos_w[i] = lo + np.arange(width, dtype=np.int32)
            slot_pos[i, :n] = pos_w[i, :n]
            if fin:
                last[i] = n - 1
        slots = slots_from_table(bt, slot_pos, app.kv_mgr.spec.block_size)
        seeds = np.asarray([_meta_seed(self._chunks[s].meta) for s in sids],
                           np.int32)
        aids = self._lora_aids(sids)
        pad_to = autobucketing.get_target_bucket(app.batch_buckets, b)
        if aids is not None:
            aids = _repeat_row0(np.asarray(aids, np.int32), pad_to)
        return _pad_paged_rows(pad_to, ids_w, pos_w, slots, bt, last,
                               seeds) + (aids,)

    def _drop_unwritten(self, sid):
        """Retire ``sid``'s EXCLUSIVE blocks from the unwritten set (a
        block another pending sequence shares stays tracked)."""
        tbl = set(self.app.kv_mgr.tables.get(sid, ()))
        if not tbl:
            return
        for other in self._chunks:
            if other != sid:
                tbl.difference_update(self.app.kv_mgr.tables.get(other, ()))
        self._unwritten -= tbl

    def _abort_pending(self, sid):
        """Tear down one pending/rolled-back sequence: blocks whose content
        never fully landed are invalidated, written ones freed."""
        if sid not in self.app.kv_mgr.tables:
            return
        unwritten = set(self.app.kv_mgr.tables[sid]) & self._unwritten
        self._drop_unwritten(sid)
        self.app.kv_mgr.abort_sequence(sid, unwritten=unwritten)

    def _abort_prefill_rows(self, sids):
        """Drop pending rows (reverse admission order): their chunk state,
        their blocks (unwritten ones invalidated) and their adapter pins
        (the reference keeps the pin, so a replayed admission would pin
        the slot twice)."""
        for s in reversed(list(sids)):
            self._chunks.pop(s, None)
            self._lora_release(s)
            self._abort_pending(s)
