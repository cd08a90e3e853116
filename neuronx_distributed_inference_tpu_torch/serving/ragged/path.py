"""The ragged unified engine step (counterpart:
``neuronx_distributed_inference_tpu/serving/ragged/path.py``).

:class:`RaggedDispatchPath` owns one engine step of the ragged mode of a
:class:`~..adapter.PagedEngineAdapter`:

  1. the :class:`~.planner.RaggedBatchPlanner` lays out ALL runnable work
     — live decode rows (width 1), speculative verify windows (width
     k + 1, clamped like the speculative path's) and pending prefill
     chunks (width n at each row's own suffix offset) — as ragged rows of
     ONE dispatch, padded to the ``autobucketing.ragged_row_buckets``
     ladder;
  2. per-row KV growth for the live rows' windows (preemption-aware,
     exactly like the non-ragged grow);
  3. with speculation attached, the proposer's draft pass (the self-draft
     loop's k T = 1 steps on the paged decode kernel, or a Medusa / EAGLE
     proposer's device work); its tokens are merged into the packed input
     on the device, never through the host;
  4. THE ragged dispatch (``model_base.paged_ragged_step``): per-row
     sampling for decode rows and final prefill chunks, acceptance for
     verify windows (greedy exact match, or the coupled draw under a
     seeded sampled config), nothing emitted for intermediate chunks and
     pad rows. An all-decode step has a row grid 1 wide and runs the
     paged decode kernel;
  5. the ONE blocking copy of the step to the host, then host
     bookkeeping: chunk cursors advance (final chunks graduate to running
     rows), ``_unwritten`` blocks covered by the now-materialized writes
     are confirmed, accept cursors advance and KV shrinks to each verify
     row's accepted prefix; a ``wants_hidden`` proposer gets the
     dispatch's hidden states of its rows (re-padded as row-0 clones).

Failure contract: the ``ragged_step`` fault point fires between growth
and the dispatch; any dispatch/fetch failure rolls EVERY packed row back
to its last delivered token — live rows' KV growth shrunk, positions
untouched, prefill rows evicted as :class:`Preempted` records
(``reason="ragged_rollback"``) so the engine replays them — and raises a
typed :class:`StepFailure` with ``phase="ragged"``. A draft failure rolls
back only the live rows' growth (``phase="spec_draft"``). The dispatch
helpers (``_dispatch_ragged``, the speculative path's
``_dispatch_spec_draft``) never read a device value: every shape-deciding
number comes from the numpy plan. :meth:`RaggedDispatchPath._fetch_ragged`
is the step's single blocking copy.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...models.model_base import EMIT_LAST, EMIT_NONE, EMIT_VERIFY
from ...modules import autobucketing
from ...modules.block_kv_cache import slots_from_table
from ...resilience.errors import CapacityError, ServingError, StepFailure
from ...resilience.faults import FAULTS as _FAULTS
from ...telemetry.request_trace import trace_of as _trace_of
from ...telemetry.trace import get_recorder as _get_recorder
from ..adapter import (_SeqState, _common_tenant, _live_rows, _meta_seed,
                       _meta_tenant, _pre_step_checks, _repeat_row0,
                       _trace_error)
from ..speculation.verifier import (SpeculativeDecodePath,
                                    validate_spec_sampling)
from .planner import (KIND_DECODE, KIND_PREFILL, KIND_VERIFY,
                      RaggedBatchPlanner, RaggedPlan)

__all__ = ["RaggedDispatchPath"]


class RaggedDispatchPath:
    """One mixed prefill+decode+verify dispatch per engine step."""

    def __init__(self, adapter, proposer=None):
        # unseeded sampling is refused, as on the speculative path
        cfg = adapter.app.tpu_config
        self.mode = validate_spec_sampling(cfg.on_device_sampling_config,
                                           where="ragged unified dispatch")
        self.adapter = adapter
        self.planner = RaggedBatchPlanner(adapter)
        # ONE warm-shape ladder for every row kind (decode / verify /
        # prefill chunk)
        self.row_buckets = autobucketing.ragged_row_buckets(
            adapter.app.ctx_buckets, adapter.prefill_chunk_tokens)
        self.proposer = proposer
        self.spec_path = None
        self.max_width = 1
        if proposer is not None:
            # the speculative path's validation, proposer binding and
            # draft dispatch, reused; only its verify is replaced by the
            # unified dispatch
            self.spec_path = SpeculativeDecodePath(adapter, proposer)
            self.max_width = min(self.spec_path.max_width,
                                 self.row_buckets[-1])
        stats = adapter.host_stats
        for key in ("ragged_steps", "ragged_dispatches",
                    "ragged_rows_decode", "ragged_rows_prefill",
                    "ragged_rows_verify", "ragged_pad_rows",
                    "ragged_real_tokens", "ragged_padded_tokens"):
            stats.setdefault(key, 0)

    @property
    def wants_hidden(self) -> bool:
        return self.proposer is not None and self.proposer.wants_hidden

    # -- the ragged engine step --------------------------------------------
    def step(self, seq_ids: Optional[Sequence[int]] = None,
             token_room: Optional[Dict[int, int]] = None
             ) -> Dict[int, List[int]]:
        """ONE unified engine step: every runnable row — decode, verify,
        prefill chunk — rides a single materialized dispatch. Returns
        ``{seq_id: [tokens]}`` (1..k+1 tokens per decode or verify row;
        first tokens of prompts whose final chunk landed this step).
        ``token_room`` (scheduler hook) clamps a verify row's width so a
        step never overshoots its remaining token budget."""
        ad = self.adapter
        if ad._inflight is not None:
            ad._stash_flush()          # retire a pre-ragged pipelined step
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
        # the degradation shed clamps verify windows to width 1 (decode
        # rows, no draft dispatch); the tokens are the same either way
        max_width = 1 if ad._spec_shed else self.max_width
        plan = self.planner.plan(live, seq_ids, token_room, max_width)
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

    def _rollback_live(self, plan: RaggedPlan) -> None:
        """Shrink every live row's window growth back to its last
        accepted or delivered token (positions untouched — a retry
        continues the exact stream)."""
        ad = self.adapter
        for s in plan.live_ids:
            if s in ad.seqs and s in ad.app.kv_mgr.tables:
                ad.app.kv_mgr.shrink(s, plan.widths[s])

    def _rollback_plan(self, plan: RaggedPlan) -> None:
        """Dispatch-failure rollback: live rows shrink to their last
        accepted or delivered token, and every prefill row packed in the
        failed dispatch is evicted as a PREEMPTION in reverse admission
        order (its never-written blocks leave the prefix cache; the record
        lets the scheduler replay the admission)."""
        ad = self.adapter
        self._rollback_live(plan)
        for s in reversed(plan.prefill_ids):
            if s in ad._chunks:
                ad._preempt(s, reason="ragged_rollback")

    def _draft(self, plan: RaggedPlan, live_rows):
        """The proposer's draft pass over the live (verify) rows through
        the speculative path's shared preamble. A draft failure rolls back
        ONLY the live rows' growth (the prefill rows saw no device work);
        a sat-out proposer releases the unused window. Returns (drafts
        device tensor or None, bucketed spec width, ctx)."""
        app = self.adapter.app
        live = [r.seq_id for r in live_rows]
        drafts, W, ctx = self.spec_path.run_draft(
            live, plan.widths, lambda: self._rollback_live(plan))
        if drafts is None and W > 1:
            for r in live_rows:
                if r.width > 1:
                    app.kv_mgr.shrink(r.seq_id, r.width - 1)
                    r.width = 1
                    plan.widths[r.seq_id] = 1
            W = 1
            ctx.num_drafts = 0
            ctx.widths = np.ones_like(ctx.widths)
        return drafts, W, ctx

    def _execute_plan(self, plan: RaggedPlan,
                      t0: float) -> Dict[int, List[int]]:
        ad = self.adapter
        app = ad.app
        chunks = ad._chunks
        rows = plan.rows
        live_rows = [(i, r) for i, r in enumerate(rows)
                     if r.kind != KIND_PREFILL]
        # draft BEFORE packing: verify widths fall to 1 when the proposer
        # sits the step out
        drafts, spec_W, ctx = None, 1, None
        if self.spec_path is not None and live_rows:
            drafts, spec_W, ctx = self._draft(plan,
                                              [r for _, r in live_rows])
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
                emit[i] = (EMIT_VERIFY if r.kind == KIND_VERIFY
                           else EMIT_LAST)
        slots = slots_from_table(bt, slot_pos, bs)
        seeds = np.asarray(
            [_meta_seed(ad.seqs[r.seq_id].meta if r.seq_id in ad.seqs
                        else chunks[r.seq_id].meta) for r in rows],
            np.int32)
        # the rows' pinned LoRA slots ride the plan (reference :291-305);
        # without a pool, or with base rows only (slot 0's deltas are
        # zeros), the dispatch stays LoRA-free
        aids = None
        if (ad._lora_pool is not None
                and any(r.adapter_id > 0 for r in rows)):
            aids = np.asarray([max(r.adapter_id, 0) for r in rows],
                              np.int32)
        if pad_to > b:
            # batch-pad rows clone row 0 and write its slots with the same
            # values, so the duplicate writes are order-free (row 0's
            # adapter too, or the clones would write other values)
            ids, pos, slots, bt, wid, emit, seeds = (
                _repeat_row0(x, pad_to)
                for x in (ids, pos, slots, bt, wid, emit, seeds))
            if aids is not None:
                aids = _repeat_row0(aids, pad_to)
        if drafts is not None and spec_W > 1:
            # merge the device-resident drafts into the packed input: the
            # verify rows are the plan's live prefix. Batch-pad rows clone
            # row 0 and share its slots, so they carry row 0's DRAFTS too,
            # or their duplicate KV writes would race row 0's with other
            # values
            n_live = len(live_rows)
            ids = torch.as_tensor(ids, device=app.device)
            ids[:n_live, 1:spec_W] = drafts[:n_live, :spec_W - 1].to(
                torch.int32)
            if pad_to > b:
                ids[b:, 1:spec_W] = drafts[0, :spec_W - 1].to(torch.int32)
        if ctx is not None and self.wants_hidden:
            # ctx.cand (read only by a proposer of hidden states: EAGLE's
            # refresh) keeps the spec context's rows (the live rows, then
            # clones of row 0): the grid's rows past the live prefix are
            # prefill or pad rows, so re-pad by gather; EAGLE's refresh
            # writes cand at row 0's slot for the clones, with its values
            ctx.cand = torch.as_tensor(ids, device=app.device)[
                self._ctx_rows(ctx, len(live_rows)), :spec_W]
        tenant = _common_tenant(
            [_meta_tenant(ad.seqs[s].meta) for s in sids if s in ad.seqs]
            + [_meta_tenant(chunks[s].meta) for s in sids if s in chunks])
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("ragged_step")
            dispatched = True
            out = self._dispatch_ragged(ids, pos, slots, bt, wid, emit,
                                        seeds, rows, aids)
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
                            ctx, spec_W, t0, b, W, pad_to, out.get("hidden"))

    def _ctx_rows(self, ctx, n_live: int) -> torch.Tensor:
        """Grid rows of the spec context's rows: the live prefix, then row
        0 for each of the context's pad rows."""
        return torch.as_tensor(np.concatenate(
            [np.arange(n_live), np.zeros(ctx.padded_batch - n_live,
                                         np.int64)]),
            device=self.adapter.app.device)

    def _accept(self, plan, live_rows, prefill_rows, toks, n_emit, ctx,
                spec_W, t0, b, W, pad_to, hidden=None
                ) -> Dict[int, List[int]]:
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
        # 3. live rows: accept cursors advance, KV shrinks to the accepted
        # prefix
        res: Dict[int, List[int]] = {}
        drafted = accepted = 0
        spec_rows = []
        for i, r in live_rows:
            st = ad.seqs[r.seq_id]
            n = int(n_emit[i])
            row = [int(t) for t in toks[i, :n]]
            st.position += n
            for t in row:
                ad._append_token(st, t)
            if r.width > n:
                app.kv_mgr.shrink(r.seq_id, r.width - n)
            res[r.seq_id] = row
            drafted += r.width - 1
            accepted += n - 1
            spec_rows.append((r.seq_id, n))
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
        if self.spec_path is not None and spec_rows:
            stats["spec_steps"] += 1
            stats["spec_drafted_tokens"] += drafted
            stats["spec_accepted_tokens"] += accepted
            ad.telemetry.on_spec_step(spec_rows, t0, padded=pad_to,
                                      width=spec_W, drafted=drafted,
                                      accepted=accepted, mode=self.mode)
        elif spec_rows:
            ad.telemetry.on_step([s for s, _ in spec_rows], t0,
                                 padded=pad_to)
        if ctx is not None:
            n_live = len(live_rows)
            if hidden is not None:
                hidden = hidden[self._ctx_rows(ctx, n_live), :spec_W]
            self.spec_path.feedback(ctx, toks[:n_live, :spec_W],
                                    n_emit[:n_live], hidden)
        return res

    # -- dispatch region: no device value is read here ---------------------
    def _dispatch_ragged(self, ids, pos, slots, bt, wid, emit, seeds, rows,
                         aids=None):
        """Issue THE unified dispatch (one per engine step) from the
        numpy plan (``ids`` a device tensor when drafts were merged),
        without reading any output. In declared steady state an unexpected
        graph signature is attributed to the packed rows' request traces
        (reference path.py:479-488). ``aids``: the rows' LoRA slots (None
        without a pool)."""
        ad = self.adapter
        ctx = (ad.app.request_context(self._row_trace(r.seq_id)
                                      for r in rows)
               if ad.app._steady_state else contextlib.nullcontext())
        with ctx:
            out = ad.app._run_ragged(ids, pos, slots, bt, wid, emit,
                                     row_seeds=seeds,
                                     want_hidden=self.wants_hidden,
                                     adapter_ids=aids)
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
