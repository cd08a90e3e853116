"""Serving adapters — the continuous-batching contract an engine drives
(counterpart: ``neuronx_distributed_inference_tpu/serving/adapter.py`` —
``_SeqState``/``_ChunkState`` :137-180, the helpers :182-243,
``_AdapterTelemetry`` :245-456, the helpers :459-560, ``_CbScratch`` :563,
``_PagedScratch`` :606, the eager path of ``_EngineAdapterBase``
:682-903 with ``flush`` :837 and ``debug_state`` :1071,
``ContinuousBatchingAdapter`` :1090-1275 and ``PagedEngineAdapter`` :1277
with its ragged routing :1541-1649, scheduler hooks :1794-1878,
preemption :2022-2165 and chunked prefill :2174-2400).

``ContinuousBatchingAdapter`` drives the contiguous app: a request owns one
cache row (its ``seq_id``) from ``add_requests`` to ``release``; prefill
and decode address rows by ``seq_id``. ``PagedEngineAdapter`` drives the
paged app. The engine owns scheduling; the adapter owns device state:

  * ``add_requests(seq_ids, prompts)`` — transactional admission; the
    uncached prompt suffixes run as chunked, packed prefill rows of
    ctx-bucket ``_run_paged`` dispatches (or, with
    ``prefill_budget_tokens``, one budgeted chunk dispatch per step);
  * ``step(seq_ids=None)`` — one decode step for the running rows (with
    ``ragged=True``: ONE mixed dispatch of decode rows and pending
    prefill chunks, ``serving/ragged/``);
  * ``step_many(k, seq_ids=None)`` — k decode steps in one call of the
    device loop (slots advance on the device);
  * ``release(seq_ids)`` — free rows and their blocks.

When the block pool runs dry the ``preemption_policy`` ("lifo" /
"fewest_generated") evicts a running or pending sequence and queues a
:class:`Preempted` record for :meth:`PagedEngineAdapter.take_preempted`.

Telemetry (``telemetry=`` registry, else the process-global one) and the
fault points ``slow_step``, ``decode_step``, ``prefill_chunk`` and
``ragged_step`` are those of the counterpart. The eager path
(``pipeline_depth=0``) is ported; the constructor refuses what waits for
later slices: ``speculation``, ``lora_pool``, ``kv_spill_tier`` and
``pipeline_depth > 0``.

A step that fails before its dispatch began (an injected fault, a host
error) raises a ``retry_safe`` :class:`StepFailure`; one that fails inside
the dispatch does not, since the cache is updated in place.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..modules import autobucketing
from ..modules.block_kv_cache import (cut_cached_at_unwritten,
                                      slots_from_table,
                                      slots_from_table_into)
from ..resilience.errors import (AdmissionError, CapacityError,
                                 ConfigurationError, DeadlineExceeded,
                                 SequenceStateError, ServingError,
                                 StepFailure)
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


def _meta_tenant(meta: Any) -> str:
    """Tenant label value from an opaque per-request ``meta`` payload (the
    engine passes mappings with a "tenant" key; anything else is "")."""
    try:
        return str(meta.get("tenant", ""))
    except AttributeError:
        return ""


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
    """Engine-adapter instrumentation (a copy of the counterpart's, less
    the pipeline and speculation hooks the port does not run): TTFT /
    per-step decode latency histograms, live-batch and pad-waste
    accounting, one request span per seq_id. Host-side only; every method
    is a cheap no-op while telemetry is disabled."""

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

    def on_fetch(self, steps: int):
        reg = self.registry
        if reg.enabled:
            tmetrics.steps_per_fetch_histogram(reg).observe(
                steps, engine=self.engine)

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
                     seq_len: int, telemetry: _AdapterTelemetry,
                     horizon: int = 1):
    """Wall-clock deadlines, then the decode-past-seq_len guard, for the
    whole ``horizon`` of fused steps, BEFORE any device work."""
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
    over = [s for s in live if seqs[s].position + horizon > seq_len]
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


def _pad_paged_rows(pad_to, ids, pos, slots, bt, last):
    if ids.shape[0] == pad_to:
        return ids, pos, slots, bt, last
    return tuple(_repeat_row0(x, pad_to) for x in (ids, pos, slots, bt,
                                                   last))


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

    def fill(self, adapter):
        seqs = adapter.seqs
        for i, s in enumerate(self.live):
            st = seqs[s]
            self.pos_p[i, 0] = st.position
            self.toks_p[i, 0] = st.last_token
        if self.pad_to > self.b:
            self.pos_p[self.b:] = self.pos_p[0, 0]
            self.toks_p[self.b:] = self.toks_p[0, 0]


class _PagedScratch:
    """Reusable decode-step input buffers for one (live set, batch bucket,
    table-width bucket) composition: the block-table array is refreshed
    only for rows whose block list grew; slots are recomputed in place."""

    def __init__(self, live: Sequence[int], pad_to: int, width: int,
                 block_size: int):
        b = len(live)
        self.live = tuple(live)
        self.b = b
        self.pad_to = pad_to
        self.width = width
        self.last = np.zeros((pad_to,), np.int32)
        self.ids = np.empty((pad_to, 1), np.int32)
        self.pos = np.empty((pad_to, 1), np.int32)
        self.slots = np.empty((pad_to, 1), np.int32)
        self.bt = np.zeros((pad_to, width), np.int32)
        self.counts = [0] * b
        self._block_size = block_size

    def fill(self, adapter):
        seqs = adapter.seqs
        for i, s in enumerate(self.live):
            st = seqs[s]
            self.pos[i, 0] = st.position
            self.ids[i, 0] = st.last_token
        prev0 = self.counts[0]
        adapter.app.kv_mgr.fill_block_table(self.bt[:self.b], self.live,
                                            self.counts)
        if self.pad_to > self.b:
            self.pos[self.b:] = self.pos[0, 0]
            self.ids[self.b:] = self.ids[0, 0]
            if self.counts[0] != prev0:
                self.bt[self.b:] = self.bt[0]
        slots_from_table_into(self.slots, self.bt, self.pos,
                              self._block_size)


class _EngineAdapterBase:
    """The eager decode template both adapters share (``step``,
    ``step_many``, ``flush``); subclasses provide dispatch, scratch
    construction, KV growth and token bookkeeping."""

    engine_name = ""
    _decode_failure_msg = "decode device step failed"

    def _init_host_stats(self):
        # plain-int host counters (always on). The decode counters count
        # ONLY decode work; chunked prefill keeps its own prefill_* set
        self._ready: Dict[int, int] = {}
        self._scratch = None
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

    def _append_token(self, st: _SeqState, tok: int):
        st.last_token = tok

    def _tenant_of(self, seq_ids) -> str:
        """Common tenant label of ``seq_ids`` (running rows), "" when
        mixed or unknown."""
        return _common_tenant(_meta_tenant(self.seqs[s].meta)
                              for s in seq_ids if s in self.seqs)

    # -- the ONLY places that block on device output -----------------------
    def _fetch_rows(self, out, b: int) -> np.ndarray:
        t0 = time.perf_counter()
        toks = out["tokens"].cpu().numpy()
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
        """One decode step for ``seq_ids`` (default: every running row):
        {seq_id: next token}, plus the first tokens of prefills that
        completed in this call. Raises :class:`DeadlineExceeded` /
        :class:`CapacityError` before any device work when a row is over
        budget, and :class:`StepFailure` when the device step fails (KV
        growth is rolled back, positions are not advanced)."""
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

    def step_many(self, num_steps: int,
                  seq_ids: Optional[Sequence[int]] = None
                  ) -> Dict[int, List[int]]:
        """``num_steps`` decode steps in one call of the device loop and
        one host fetch: {seq_id: [tokens]} in stream order. Deadlines and
        the seq_len guard are enforced once for the whole horizon."""
        if num_steps < 1:
            raise ConfigurationError("step_many requires num_steps >= 1")
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
        """Hand back every token not yet delivered: {seq_id: token}. The
        eager path keeps nothing in flight, so this only drains first
        tokens a failed call left behind."""
        return self._drain_ready()

    def _drain_ready(self) -> Dict[int, int]:
        out, self._ready = self._ready, {}
        return out

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
            "pipeline_inflight": 0,
            "ready_undelivered": [int(s) for s in sorted(self._ready)],
            "host_stats": dict(self.host_stats),
        }


def _refuse_waiting(**knobs):
    waiting = [name for name, v in knobs.items() if v]
    if waiting:
        raise ConfigurationError(
            "the PyTorch port's adapter does not run these yet: "
            + ", ".join(waiting))


class ContinuousBatchingAdapter(_EngineAdapterBase):
    """Engine adapter over the contiguous app (built with
    ``is_continuous_batching=True``): each request owns cache row
    ``seq_id`` in ``[0, batch_size)``."""

    engine_name = "cb"

    def __init__(self, app, telemetry=None, pipeline_depth: int = 0):
        _refuse_waiting(pipeline_depth=pipeline_depth)
        cfg = app.tpu_config
        if not cfg.is_continuous_batching:
            raise ConfigurationError("app must be built with "
                                     "is_continuous_batching=True")
        if app.cache is None:
            app.init_cache()
        self.app = app
        self.batch = cfg.batch_size
        self.seqs: Dict[int, _SeqState] = {}
        self.telemetry = _AdapterTelemetry("cb", telemetry)
        self._pos_limit = cfg.seq_len
        # free rows, ascending — maintained incrementally on add/release
        self._free: List[int] = list(range(self.batch))
        self._init_host_stats()

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

    def _dispatch_decode(self, scr: _CbScratch):
        out = self.app._run_decode(scr.toks_p, scr.pos_p, seq_ids=scr.sid_p)
        self.host_stats["dispatches"] += 1
        self.host_stats["device_steps"] += 1
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
        _refuse_waiting(**{
            "pipeline_depth > 0": pipeline_depth,
            "speculation": speculation is not None,
            "kv_spill_tier": kv_spill_tier is not None,
            "lora_pool": lora_pool is not None})
        cfg = app.tpu_config
        if not cfg.is_block_kv_layout:
            raise ConfigurationError("app must be built with "
                                     "is_block_kv_layout=True")
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
        self._init_host_stats()
        # degradation actuator (set_ragged_shed): route steps through the
        # two-phase template instead of the unified dispatch
        self._ragged_shed = False
        self._ragged = None
        if ragged:
            from .ragged import RaggedDispatchPath
            self._ragged = RaggedDispatchPath(self)

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
                while True:
                    try:
                        blocks, c = mgr.begin_sequence(sid, prompt)
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
                self._admit_counter += 1
                self._chunks[sid] = _ChunkState(
                    prompt=prompt, done=int(c),
                    admit_idx=self._admit_counter, t0=t0,
                    deadline=deadlines[i], meta=metas[i])
        except ServingError:
            self._rollback_admission(begun)
            raise
        except Exception as e:
            self._rollback_admission(begun)
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
        for sid in seq_ids:
            self._ready.pop(sid, None)
            if sid in self._chunks:
                self._abort_prefill_rows([sid])
                continue
            if sid in self.seqs:
                self.seqs.pop(sid)
                self._scratch = None
                if sid in self.app.kv_mgr.tables:
                    self.app.kv_mgr.end_sequence(sid)
        self.telemetry.on_release(seq_ids)

    # -- step routing (ragged unified dispatch, serving/ragged/) ------------
    def step(self, seq_ids: Optional[Sequence[int]] = None,
             token_room: Optional[Dict[int, int]] = None):
        """One decode step, {seq_id: token} (see the base class). With
        ``ragged=True`` every step is ONE unified mixed dispatch through
        serving/ragged/ and returns {seq_id: [tokens]}; ``token_room``
        (scheduler hook) caps each row's tokens for the step. With the
        ragged path SHED (:meth:`set_ragged_shed`) the step falls back to
        the two-phase chunk-then-decode template; greedy tokens are the
        same either way, only the dispatch count changes."""
        if self._ragged is not None:
            if not self._ragged_shed:
                return self._ragged.step(seq_ids, token_room)
            return super().step(seq_ids)   # 1 token/row: room is honored
        if token_room is not None:
            raise ConfigurationError(
                "token_room is a speculative-decode hook; build the "
                "adapter with ragged=True to use it")
        return super().step(seq_ids)

    def step_many(self, num_steps: int,
                  seq_ids: Optional[Sequence[int]] = None
                  ) -> Dict[int, List[int]]:
        """Fused multi-step decode (base class). With ``ragged=True``
        ``num_steps`` is a per-row TOKEN budget: unified engine steps run
        (each one materialized dispatch) until every row has delivered
        it."""
        if self._ragged is None:
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
            # through step() so the shed flag applies here too (a shed
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
    def ragged_shed(self) -> bool:
        return self._ragged_shed

    def set_ragged_shed(self, shed: bool) -> None:
        """Degradation actuator: route steps through the two-phase (chunk
        dispatch + decode dispatch) template instead of the unified ragged
        dispatch — see :meth:`step`. Reversible; a no-op without
        ``ragged=True``."""
        self._ragged_shed = bool(shed)

    # -- decode hooks ------------------------------------------------------
    _decode_failure_msg = ("paged decode step failed; KV growth was rolled "
                           "back")

    def _pending_ids(self):
        return self._chunks.keys()

    def _grow_for_step(self, live: List[int], n: int = 1) -> List[int]:
        return self._grow_with_preemption(live, n)

    def _rollback_step_growth(self, live: Sequence[int], n: int = 1):
        self._rollback_grow(live, n)

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
                live, pad_to, width, app.kv_mgr.spec.block_size)
        return scr

    def _dispatch_decode(self, scr: _PagedScratch):
        """Issue ONE paged decode step without reading any device value
        (the fetch is the caller's)."""
        out = self.app._run_paged(scr.ids, scr.pos, scr.slots, scr.bt,
                                  scr.last)
        self.host_stats["dispatches"] += 1
        self.host_stats["device_steps"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.decode", cat="adapter",
                        engine=self.engine_name, rows=scr.b,
                        pad_to=scr.pad_to, seq_ids=list(scr.live),
                        pipelined=False)
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
        if pad_to > b:
            first = _repeat_row0(first, pad_to)
            pos = _repeat_row0(pos, pad_to)
            bt = _repeat_row0(bt, pad_to)

        def run():
            out = app._run_paged_loop(first, pos, bt, num_steps)
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

    def prefix_warmth(self, prompt: Sequence[int]) -> int:
        """READ-ONLY probe: how many leading tokens of ``prompt`` an
        admission right now would serve from the prefix cache (cut at the
        first block a pending admission has not written yet, capped at
        ``len(prompt) - 1``). The engine orders admissions warm-first."""
        cached, blocks = self.app.kv_mgr.probe_cached_tokens(prompt)
        if cached and self._unwritten:
            cached = cut_cached_at_unwritten(
                blocks, cached, self.app.kv_mgr.spec.block_size,
                self._unwritten)
        return min(cached, len(prompt) - 1)

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
        })
        return state

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
            packed = self._pack_prefill_rows(rows)
            dispatched = True
            out = self.app._run_paged(*packed)
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
        covering the longest chunk; batch padded by repeating row 0."""
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
        pad_to = autobucketing.get_target_bucket(app.batch_buckets, b)
        return _pad_paged_rows(pad_to, ids_w, pos_w, slots, bt, last)

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
        for s in reversed(list(sids)):
            self._chunks.pop(s, None)
            self._abort_pending(s)
