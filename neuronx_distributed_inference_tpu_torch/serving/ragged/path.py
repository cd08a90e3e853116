"""The ragged unified engine step (counterpart:
``neuronx_distributed_inference_tpu/serving/ragged/path.py``).

:class:`RaggedDispatchPath` owns one engine step of the ragged mode of a
:class:`~..adapter.PagedEngineAdapter`:

  1. the :class:`~.planner.RaggedBatchPlanner` lays out ALL runnable work
     — live decode rows (width 1) and pending prefill chunks (width n at
     each row's own suffix offset) — as ragged rows of ONE dispatch,
     padded to the ``autobucketing.ragged_row_buckets`` ladder;
  2. per-row KV growth for the live rows (preemption-aware, exactly like
     the non-ragged grow);
  3. THE ragged dispatch (``model_base.paged_ragged_step``): per-row
     sampling for decode rows and final prefill chunks, nothing emitted
     for intermediate chunks and pad rows. An all-decode step has a row
     grid 1 wide and runs the paged decode kernel;
  4. the ONE blocking copy of the step to the host, then host
     bookkeeping: chunk cursors advance (final chunks graduate to running
     rows), ``_unwritten`` blocks covered by the now-materialized writes
     are confirmed, positions advance.

Failure contract: the ``ragged_step`` fault point fires between growth
and the dispatch; any dispatch/fetch failure rolls EVERY packed row back
to its last delivered token — live rows' KV growth shrunk, positions
untouched, prefill rows evicted as :class:`Preempted` records
(``reason="ragged_rollback"``) so the engine replays them — and raises a
typed :class:`StepFailure` with ``phase="ragged"``. ``_dispatch_ragged``
never reads a device value: every shape-deciding number comes from the
numpy plan. :meth:`RaggedDispatchPath._fetch_ragged` is the step's single
blocking copy.

Speculation (verify rows, the proposer's draft pass) waits with the
speculative path: the adapter refuses ``speculation=``, so every live row
is a decode row of width 1 here. The warm-up plane's steady-state request
context is not ported either.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...models.model_base import EMIT_LAST, EMIT_NONE
from ...modules import autobucketing
from ...modules.block_kv_cache import slots_from_table
from ...resilience.errors import CapacityError, ServingError, StepFailure
from ...resilience.faults import FAULTS as _FAULTS
from ...telemetry.request_trace import trace_of as _trace_of
from ...telemetry.trace import get_recorder as _get_recorder
from ..adapter import (_SeqState, _common_tenant, _live_rows, _meta_tenant,
                       _pre_step_checks, _repeat_row0, _trace_error)
from ..speculation.verifier import validate_spec_sampling
from .planner import (KIND_DECODE, KIND_PREFILL, KIND_VERIFY,
                      RaggedBatchPlanner, RaggedPlan)

__all__ = ["RaggedDispatchPath"]


class RaggedDispatchPath:
    """One mixed prefill+decode dispatch per engine step."""

    def __init__(self, adapter):
        # unseeded sampling is refused, as on the speculative paths
        cfg = adapter.app.tpu_config
        validate_spec_sampling(cfg.on_device_sampling_config,
                               where="ragged unified dispatch")
        self.adapter = adapter
        self.planner = RaggedBatchPlanner(adapter)
        # ONE warm-shape ladder for every row kind (decode / prefill chunk)
        self.row_buckets = autobucketing.ragged_row_buckets(
            adapter.app.ctx_buckets, adapter.prefill_chunk_tokens)
        stats = adapter.host_stats
        for key in ("ragged_steps", "ragged_dispatches",
                    "ragged_rows_decode", "ragged_rows_prefill",
                    "ragged_rows_verify", "ragged_pad_rows",
                    "ragged_real_tokens", "ragged_padded_tokens"):
            stats.setdefault(key, 0)

    # -- the ragged engine step --------------------------------------------
    def step(self, seq_ids: Optional[Sequence[int]] = None,
             token_room: Optional[Dict[int, int]] = None
             ) -> Dict[int, List[int]]:
        """ONE unified engine step: every runnable row — decode, prefill
        chunk — rides a single materialized dispatch. Returns ``{seq_id:
        [tokens]}`` (one token per decode row; first tokens of prompts
        whose final chunk landed this step). ``token_room`` (scheduler
        hook) clamps a verify row's width; decode rows take one token."""
        ad = self.adapter
        pending = ad._pending_ids()
        live = _live_rows(ad.seqs, seq_ids, pending)

        def drain() -> Dict[int, List[int]]:
            return {s: [t] for s, t in ad._drain_ready().items()}

        if not live and not pending:
            return drain()
        if _FAULTS.active:
            _FAULTS.fire("slow_step")
        if live:
            _pre_step_checks(ad.seqs, live, ad._pos_limit, ad.telemetry,
                             horizon=1)
        t0 = time.perf_counter()
        # candidate width 1: every live row is a decode row (no proposer)
        plan = self.planner.plan(live, seq_ids, token_room, 1)
        if plan.live_ids:
            self._grow_plan(plan)
            plan.prune(ad)             # rows preempted mid-grow drop out
        if not plan.rows:
            return drain()
        # _ready (graduated first tokens) is drained only after the
        # fallible stages, so a StepFailure leaves them deliverable
        res = self._execute_plan(plan, t0)
        out = drain()
        for s, row in res.items():
            out.setdefault(s, []).extend(row)
        return out

    # -- internals ---------------------------------------------------------
    def _grow_plan(self, plan: RaggedPlan) -> None:
        """Grow every live row's block list to cover its window, evicting
        victims per the adapter's preemption policy when the pool runs
        dry. On an unevictable CapacityError all growth from this call is
        rolled back before the raise."""
        ad = self.adapter
        mgr = ad.app.kv_mgr
        widths = plan.widths
        queue = list(plan.live_ids)
        grown: List[int] = []
        while queue:
            s = queue[0]
            if s not in ad.seqs:       # preempted by an earlier eviction
                queue.pop(0)
                continue
            try:
                mgr.grow(s, widths[s])
            except CapacityError:
                victim = ad._choose_victim()
                if victim is None:
                    for g in grown:
                        mgr.shrink(g, widths[g])
                    raise
                ad._preempt(victim, reason="grow")
                for lst in (queue, grown):
                    if victim in lst:
                        lst.remove(victim)
                continue
            queue.pop(0)
            grown.append(s)

    def _rollback_plan(self, plan: RaggedPlan) -> None:
        """Dispatch-failure rollback: live rows shrink to their last
        delivered token (positions untouched — a retry continues the
        exact stream), and every prefill row packed in the failed dispatch
        is evicted as a PREEMPTION in reverse admission order (its
        never-written blocks leave the prefix cache; the record lets the
        scheduler replay the admission)."""
        ad = self.adapter
        for s in plan.live_ids:
            if s in ad.seqs and s in ad.app.kv_mgr.tables:
                ad.app.kv_mgr.shrink(s, plan.widths[s])
        for s in reversed(plan.prefill_ids):
            if s in ad._chunks:
                ad._preempt(s, reason="ragged_rollback")

    def _execute_plan(self, plan: RaggedPlan,
                      t0: float) -> Dict[int, List[int]]:
        ad = self.adapter
        app = ad.app
        chunks = ad._chunks
        rows = plan.rows
        live_rows = [(i, r) for i, r in enumerate(rows)
                     if r.kind != KIND_PREFILL]
        prefill_rows = [(i, r) for i, r in enumerate(rows)
                        if r.kind == KIND_PREFILL]
        b = len(rows)
        W = autobucketing.get_target_bucket(
            self.row_buckets, max(r.width for r in rows))
        pad_to = autobucketing.get_target_bucket(app.batch_buckets, b)
        sids = [r.seq_id for r in rows]
        bs = app.kv_mgr.spec.block_size
        bt = app.kv_mgr.block_table_array(sids, app._bt_width_for(sids))
        ids = np.zeros((b, W), np.int32)
        pos = np.zeros((b, W), np.int32)
        slot_pos = np.full((b, W), -1, np.int32)
        wid = np.zeros((b,), np.int32)
        emit = np.zeros((b,), np.int32)
        cols = np.arange(W, dtype=np.int32)
        for i, r in enumerate(rows):
            wid[i] = r.width
            # positions past the width still feed RoPE and the mask (as
            # in the reference); their slots stay -1, so nothing is written
            pos[i] = r.offset + cols
            slot_pos[i, :r.width] = pos[i, :r.width]
            if r.kind == KIND_PREFILL:
                st = chunks[r.seq_id]
                ids[i, :r.width] = st.prompt[r.offset:r.offset + r.width]
                emit[i] = EMIT_LAST if r.final else EMIT_NONE
            else:
                ids[i, 0] = ad.seqs[r.seq_id].last_token
                emit[i] = EMIT_LAST
        slots = slots_from_table(bt, slot_pos, bs)
        if pad_to > b:
            # batch-pad rows clone row 0 and write its slots with the same
            # values, so the duplicate writes are order-free. A verify row
            # 0 would need its drafts cloned too (reference path.py:314-320);
            # that waits with speculation
            ids, pos, slots, bt, wid, emit = (
                _repeat_row0(x, pad_to)
                for x in (ids, pos, slots, bt, wid, emit))
        tenant = _common_tenant(
            [_meta_tenant(ad.seqs[s].meta) for s in sids if s in ad.seqs]
            + [_meta_tenant(chunks[s].meta) for s in sids if s in chunks])
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("ragged_step")
            dispatched = True
            out = self._dispatch_ragged(ids, pos, slots, bt, wid, emit,
                                        rows)
            toks, n_emit = self._fetch_ragged(out, b)
        except ServingError as e:
            self._rollback_plan(plan)
            _trace_error(e)
            raise
        except Exception as e:
            self._rollback_plan(plan)
            ad.telemetry.on_step_failure("ragged", tenant)
            # the cache is written in place: only a failure before the
            # dispatch began leaves it as it was
            raise _trace_error(StepFailure(
                "ragged unified dispatch failed; every packed row was "
                "rolled back to its last delivered token",
                phase="ragged", seq_ids=tuple(sids),
                retry_safe=not dispatched)) from e
        return self._accept(plan, live_rows, prefill_rows, toks, n_emit,
                            t0, b, W, pad_to)

    def _accept(self, plan, live_rows, prefill_rows, toks, n_emit, t0, b,
                W, pad_to) -> Dict[int, List[int]]:
        """Post-fetch host bookkeeping (the dispatch is materialized)."""
        ad = self.adapter
        app = ad.app
        chunks = ad._chunks
        bs = app.kv_mgr.spec.block_size
        # 1. chunk cursors advance; the fetch above ordered the dispatch,
        # so every block each pending row's cursor covers is now written
        for _, r in prefill_rows:
            chunks[r.seq_id].done += r.width
        for s2, cst in chunks.items():
            ad._unwritten.difference_update(
                app.kv_mgr.tables[s2][:cst.done // bs])
        # 2. final chunks graduate to running rows
        for i, r in prefill_rows:
            if not r.final:
                continue
            st = chunks.pop(r.seq_id)
            ad._unwritten.difference_update(app.kv_mgr.tables[r.seq_id])
            tok = int(toks[i, 0])
            ad.seqs[r.seq_id] = _SeqState(
                position=len(st.prompt), last_token=tok,
                tokens=list(st.prompt) + [tok],
                prompt_len=len(st.prompt), admit_idx=st.admit_idx,
                deadline=st.deadline, meta=st.meta)
            ad._scratch = None         # live set grew
            ad._ready[r.seq_id] = tok
            ad.telemetry.on_add([r.seq_id], [st.prompt], st.t0, live=1,
                                padded=1, count_rows=False,
                                tenants=[_meta_tenant(st.meta)])
        # 3. live rows: positions advance by the emitted tokens
        res: Dict[int, List[int]] = {}
        for i, r in live_rows:
            st = ad.seqs[r.seq_id]
            n = int(n_emit[i])
            row = [int(t) for t in toks[i, :n]]
            st.position += n
            for t in row:
                ad._append_token(st, t)
            res[r.seq_id] = row
        # 4. telemetry + always-on host counters
        stats = ad.host_stats
        n_decode = sum(1 for _, r in live_rows if r.kind == KIND_DECODE)
        n_verify = len(live_rows) - n_decode
        real = sum(r.width for r in plan.rows)
        stats["ragged_steps"] += 1
        stats["ragged_rows_decode"] += n_decode
        stats["ragged_rows_verify"] += n_verify
        stats["ragged_rows_prefill"] += len(prefill_rows)
        stats["ragged_pad_rows"] += pad_to - b
        stats["ragged_real_tokens"] += real
        stats["ragged_padded_tokens"] += pad_to * W
        if prefill_rows:
            pre_real = sum(r.width for _, r in prefill_rows)
            stats["prefill_real_tokens"] += pre_real
            stats["prefill_padded_tokens"] += len(prefill_rows) * W
            ad.telemetry.on_prefill_chunk(len(prefill_rows),
                                          len(prefill_rows), pre_real,
                                          len(prefill_rows) * W)
        ad.telemetry.on_ragged_step(
            {KIND_DECODE: n_decode, KIND_VERIFY: n_verify,
             KIND_PREFILL: len(prefill_rows), "pad": pad_to - b},
            real, pad_to * W)
        if live_rows:
            ad.telemetry.on_step([r.seq_id for _, r in live_rows], t0,
                                 padded=pad_to)
        return res

    # -- dispatch region: no device value is read here ---------------------
    def _dispatch_ragged(self, ids, pos, slots, bt, wid, emit, rows):
        """Issue THE unified dispatch (one per engine step) from the
        numpy plan, without reading any output."""
        ad = self.adapter
        out = ad.app._run_ragged(ids, pos, slots, bt, wid, emit)
        ad.host_stats["dispatches"] += 1
        ad.host_stats["ragged_dispatches"] += 1
        ad.host_stats["device_steps"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.ragged", cat="adapter",
                        engine=ad.engine_name, rows=len(rows),
                        pad_to=int(wid.shape[0]), width=int(ids.shape[1]),
                        kinds={r.kind: sum(1 for x in rows
                                           if x.kind == r.kind)
                               for r in rows},
                        seq_ids=[int(r.seq_id) for r in rows],
                        # per-row request trace ids (aligned with seq_ids)
                        traces=[self._row_trace(r.seq_id) for r in rows])
        return out

    def _row_trace(self, seq_id: int):
        """The request trace id behind one packed row (live rows carry
        meta on their _SeqState, pending prefill rows on their chunk
        state)."""
        ad = self.adapter
        st = ad.seqs.get(seq_id)
        meta = st.meta if st is not None else getattr(
            ad._chunks.get(seq_id), "meta", None)
        return _trace_of(meta)

    def _fetch_ragged(self, out, b: int):
        """The ONE blocking copy of a ragged engine step: tokens and
        ``num_emitted`` travel to the host together."""
        ad = self.adapter
        t0 = time.perf_counter()
        both = torch.cat([out["tokens"], out["num_emitted"][:, None]],
                         dim=1).cpu().numpy()[:b]
        t1 = time.perf_counter()
        ad.host_stats["blocking_fetches"] += 1
        ad.host_stats["blocked_s"] += t1 - t0
        rec = _get_recorder()
        if rec.enabled:
            rec.complete("fetch.tokens", t0, cat="adapter", t1=t1,
                         engine=ad.engine_name, rows=b, phase="ragged")
        return both[:, :-1], both[:, -1]
