"""The speculative engine step (counterpart:
``neuronx_distributed_inference_tpu/serving/speculation/verifier.py`` —
``validate_spec_sampling`` :61, ``_SpecContext`` :84,
``SpeculativeDecodePath`` :103-458, its ``_dispatch_propose`` and
``_dispatch_eagle_refresh`` :399-417).

:class:`SpeculativeDecodePath` owns one engine step of draft-and-verify
decode on a :class:`~..adapter.PagedEngineAdapter`:

  1. per-row candidate widths — ``k + 1`` clamped by the seq_len headroom
     and the scheduler's per-row token room — padded to the
     ``autobucketing.spec_width_buckets`` ladder;
  2. per-row KV growth for the whole window (preemption-aware);
  3. the proposer's draft pass, whose tokens stay on the device (the
     self-draft loop, or a proposer's own device work through
     :meth:`SpeculativeDecodePath._dispatch_propose`);
  4. ONE verify dispatch (``model_base.paged_spec_verify``, with its hidden
     states when the proposer ``wants_hidden``): greedy
     exact-match acceptance, or — under a seeded sampled config — the
     coupled draw, which makes exact match the rejection test of the
     shared positional noise;
  5. the ONE blocking fetch (tokens and accept counts together), then
     the accept cursors advance and KV shrinks to the accepted prefix;
  6. the proposer's feedback (``on_verify``) with the verify's hidden
     states: Medusa keeps each row's feature, EAGLE refreshes its draft
     cache (:meth:`SpeculativeDecodePath._dispatch_eagle_refresh`).

Failure contract: the ``spec_draft`` / ``spec_verify`` fault points fire
before the two dispatches; any failure shrinks every packed row's growth
back to its last accepted token, leaves positions untouched and raises a
typed :class:`StepFailure`. The cache is written in place, so a failure
inside a dispatch is not ``retry_safe``. The ``_dispatch_*`` helpers
never read a device value; :meth:`_fetch_verify` is the step's single
blocking copy. A proposer that fails in ``on_verify`` loses its
per-sequence state, never a token: the step's tokens are delivered
already.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...modules import autobucketing
from ...modules.block_kv_cache import slots_from_table
from ...resilience.errors import (CapacityError, ConfigurationError,
                                  ServingError, StepFailure)
from ...resilience.faults import FAULTS as _FAULTS
from ...telemetry.trace import get_recorder as _get_recorder
from ..adapter import (_live_rows, _meta_seed, _pre_step_checks,
                       _repeat_row0, _trace_error)
from .proposer import DraftProposer

__all__ = ["SpeculativeDecodePath", "validate_spec_sampling"]

logger = logging.getLogger("nxdi_tpu_torch")


def validate_spec_sampling(sampling_config, where: str) -> str:
    """Resolve a speculative path's verify mode from the adapter's
    on-device sampling config: ``"greedy"`` (no config, or
    ``do_sample=False``) or ``"sampled"`` (seeded coupled sampling —
    ``do_sample=True`` with ``stream_seed`` set). UNSEEDED sampling is
    refused: without a stream seed every dispatch draws fresh noise, so
    verify could never reproduce the target draw a draft must match and
    the emitted stream would depend on batch composition."""
    if sampling_config is None or not sampling_config.do_sample:
        return "greedy"
    if sampling_config.stream_seed is None:
        raise ConfigurationError(
            f"{where} supports sampled speculation only for SEEDED "
            "streams: set on_device_sampling_config.stream_seed (coupled "
            "rejection sampling replays the per-position gumbel draw the "
            "draft must match). Supported: greedy (do_sample=False, no "
            "seed needed) and seeded sampling; unseeded do_sample is "
            "not.")
    return "sampled"


@dataclass
class _SpecContext:
    """What a proposer needs to draft for one engine step. Arrays are
    padded to the batch bucket (pad rows clone row 0)."""
    path: "SpeculativeDecodePath"
    live: Tuple[int, ...]          # live seq_ids, dispatch row order
    b: int                         # live rows (before batch padding)
    padded_batch: int
    num_drafts: int                # bucketed width - 1
    first: np.ndarray              # (Bp,) last accepted tokens
    positions: np.ndarray          # (Bp,) their positions
    widths: np.ndarray             # (Bp,) per-row candidate widths
    block_table: np.ndarray        # (Bp, table-width bucket)
    seeds: np.ndarray = None       # (Bp,) per-row sampling stream seeds
    aids: np.ndarray = None        # (Bp,) per-row LoRA slots (None: no
                                   # pool)
    cand: Any = None               # (Bp, W) device candidates, set before
                                   # on_verify (EAGLE's refresh reads them)


class SpeculativeDecodePath:
    """Draft-and-verify stepping for one paged adapter + one proposer."""

    def __init__(self, adapter, proposer: DraftProposer):
        if not isinstance(proposer, DraftProposer):
            raise ConfigurationError(
                "speculation= takes a DraftProposer (e.g. "
                f"SelfDraftProposer(k)), got {type(proposer).__name__}")
        cfg = adapter.app.tpu_config
        self.mode = validate_spec_sampling(cfg.on_device_sampling_config,
                                           where="speculative serving")
        self.adapter = adapter
        self.proposer = proposer
        self.max_width = proposer.max_drafts + 1
        self.width_buckets = autobucketing.spec_width_buckets(self.max_width)
        stats = adapter.host_stats
        for key in ("spec_steps", "spec_draft_dispatches",
                    "spec_verify_dispatches", "spec_drafted_tokens",
                    "spec_accepted_tokens"):
            stats.setdefault(key, 0)
        proposer.bind(adapter)

    # -- the speculative engine step ---------------------------------------
    def step(self, seq_ids: Optional[Sequence[int]] = None,
             token_room: Optional[Dict[int, int]] = None
             ) -> Dict[int, List[int]]:
        """One speculative engine step: at most one prefill-chunk
        dispatch, one draft pass and EXACTLY one verify dispatch; returns
        ``{seq_id: [accepted tokens + bonus]}`` with 1..k+1 tokens a row.
        ``token_room`` clamps a row's width so a step never overshoots its
        remaining token budget."""
        ad = self.adapter
        if ad._inflight is not None:
            ad._stash_flush()          # retire a pre-spec pipelined step
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
        ad._advance_prefill(seq_ids)
        if not live:
            return drain()
        t0 = time.perf_counter()
        limit = ad._pos_limit
        # the degradation shed clamps every window to width 1: no draft
        # dispatch, same tokens (the coupled draws are path-invariant)
        max_w = 1 if ad._spec_shed else self.max_width
        widths = {}
        for s in live:
            w = min(max_w, limit - ad.seqs[s].position)
            if token_room is not None and s in token_room:
                w = min(w, token_room[s])
            widths[s] = max(1, int(w))
        live = self._grow_for_spec(live, widths)
        if not live:
            return drain()
        # _ready is drained only after the fallible stages: a StepFailure
        # leaves first tokens deliverable by the next call
        res = self._draft_verify_accept(live, widths, t0)
        out = drain()
        for s, row in res.items():
            out.setdefault(s, []).extend(row)
        return out

    # -- internals ---------------------------------------------------------
    def _grow_for_spec(self, live: List[int],
                       widths: Dict[int, int]) -> List[int]:
        """Grow every row's blocks to cover its window, evicting victims
        when the pool runs dry (rows preempted mid-grow leave ``live``);
        an unevictable CapacityError rolls back this call's growth."""
        ad = self.adapter
        mgr = ad.app.kv_mgr
        live = list(live)
        queue = list(live)
        grown: List[int] = []
        while queue:
            s = queue[0]
            try:
                mgr.grow(s, widths[s])
            except CapacityError:
                victim = ad._choose_victim()
                if victim is None:
                    for g in grown:
                        mgr.shrink(g, widths[g])
                    raise
                ad._preempt(victim, reason="grow")
                for lst in (queue, live, grown):
                    if victim in lst:
                        lst.remove(victim)
                continue
            queue.pop(0)
            grown.append(s)
        return live

    def _rollback(self, live: Sequence[int], widths: Dict[int, int]):
        for s in live:
            self.adapter.app.kv_mgr.shrink(s, widths[s])

    def run_draft(self, live: List[int], widths: Dict[int, int],
                  rollback) -> Tuple[Any, int, _SpecContext]:
        """The draft preamble shared with the ragged unified step: build
        the row-0-padded :class:`_SpecContext`, fire ``spec_draft`` and run
        the proposer. On failure ``rollback()`` unwinds the caller's KV
        growth before the typed raise. Returns ``(drafts or None, bucketed
        width W, ctx)``."""
        ad = self.adapter
        app = ad.app
        b = len(live)
        pad_to = autobucketing.get_target_bucket(app.batch_buckets, b)
        wmax = max(widths[s] for s in live)
        W = autobucketing.get_target_bucket(self.width_buckets, wmax)
        first = np.asarray([ad.seqs[s].last_token for s in live], np.int32)
        pos = np.asarray([ad.seqs[s].position for s in live], np.int32)
        wid = np.asarray([widths[s] for s in live], np.int32)
        seeds = np.asarray([_meta_seed(ad.seqs[s].meta) for s in live],
                           np.int32)
        aids = ad._lora_aids(live)
        if aids is not None:
            aids = np.asarray(aids, np.int32)
        bt = app.kv_mgr.block_table_array(live, app._bt_width_for(live))
        if pad_to > b:
            first, pos, wid, seeds, bt = (_repeat_row0(x, pad_to)
                                          for x in (first, pos, wid,
                                                    seeds, bt))
            if aids is not None:
                aids = _repeat_row0(aids, pad_to)
        ctx = _SpecContext(path=self, live=tuple(live), b=b,
                           padded_batch=pad_to, num_drafts=W - 1,
                           first=first, positions=pos, widths=wid,
                           block_table=bt, seeds=seeds, aids=aids)
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("spec_draft")
            dispatched = True
            with ad._request_context(live):
                drafts = self.proposer.propose(ctx) if W > 1 else None
        except ServingError as e:
            rollback()
            _trace_error(e)
            raise
        except Exception as e:
            rollback()
            ad.telemetry.on_step_failure("spec", ad._tenant_of(live))
            raise _trace_error(StepFailure(
                "speculative draft pass failed; KV growth was rolled back "
                "and positions were not advanced",
                phase="spec_draft", seq_ids=tuple(live),
                retry_safe=not dispatched)) from e
        return drafts, W, ctx

    def _draft_verify_accept(self, live: List[int], widths: Dict[int, int],
                             t0: float) -> Dict[int, List[int]]:
        ad = self.adapter
        app = ad.app
        tenant = ad._tenant_of(live)
        drafts, W, ctx = self.run_draft(
            live, widths, lambda: self._rollback(live, widths))
        b, pad_to = ctx.b, ctx.padded_batch
        pos, wid, bt = ctx.positions, ctx.widths, ctx.block_table
        if drafts is None and W > 1:
            # the proposer sat this step out: release the unused window
            for s in live:
                if widths[s] > 1:
                    app.kv_mgr.shrink(s, widths[s] - 1)
                    widths[s] = 1
            wid = np.ones_like(wid)
            W = 1
            ctx.num_drafts = 0
            ctx.widths = wid
        first_dev = torch.as_tensor(ctx.first, device=app.device)[:, None]
        cand = (first_dev if W == 1 else
                torch.cat([first_dev, drafts[:, :W - 1].to(torch.int32)],
                          dim=1))
        ctx.cand = cand
        cols = np.arange(W, dtype=np.int32)[None, :]
        pos_w = pos[:, None] + cols
        slot_pos = np.where(cols < wid[:, None], pos_w, -1)
        slots = slots_from_table(bt, slot_pos, app.kv_mgr.spec.block_size)
        dispatched = False
        try:
            if _FAULTS.active:
                _FAULTS.fire("spec_verify")
            dispatched = True
            out = self._dispatch_spec_verify(ctx, cand, pos_w, slots)
            toks, n_emit = self._fetch_verify(out, b)
        except ServingError as e:
            self._rollback(live, widths)
            _trace_error(e)
            raise
        except Exception as e:
            self._rollback(live, widths)
            ad.telemetry.on_step_failure("spec", tenant)
            raise _trace_error(StepFailure(
                "speculative verify dispatch failed; every packed row was "
                "rolled back to its last accepted token",
                phase="spec_verify", seq_ids=tuple(live),
                retry_safe=not dispatched)) from e
        res: Dict[int, List[int]] = {}
        drafted = accepted = 0
        rows = []
        for i, s in enumerate(live):
            st = ad.seqs[s]
            w = widths[s]
            n = int(n_emit[i])
            row = [int(t) for t in toks[i, :n]]
            st.position += n
            for t in row:
                ad._append_token(st, t)
            if w > n:
                app.kv_mgr.shrink(s, w - n)
            res[s] = row
            drafted += w - 1
            accepted += n - 1
            rows.append((s, n))
        stats = ad.host_stats
        stats["spec_steps"] += 1
        stats["spec_drafted_tokens"] += drafted
        stats["spec_accepted_tokens"] += accepted
        ad.telemetry.on_spec_step(rows, t0, padded=pad_to, width=W,
                                  drafted=drafted, accepted=accepted,
                                  mode=self.mode)
        self.feedback(ctx, toks, n_emit, out.get("hidden"))
        return res

    def feedback(self, ctx: _SpecContext, toks, n_emit, hidden=None) -> None:
        """Hand the accept results (and, to a ``wants_hidden`` proposer,
        the verify's hidden states, rows as ``ctx``'s) to the proposer. The
        step's tokens are already delivered: a proposer failing here costs
        its per-sequence state, never the stream."""
        try:
            self.proposer.on_verify(
                ctx, toks, n_emit,
                hidden if self.proposer.wants_hidden else None)
        except Exception:
            logger.warning(
                "speculative proposer %r failed in on_verify; its "
                "per-sequence state was dropped (seq_ids=%s)",
                self.proposer.name, list(ctx.live), exc_info=True)
            self.proposer.forget(ctx.live)

    # -- dispatch regions: no device value is read here --------------------
    def _dispatch_spec_draft(self, ctx: _SpecContext):
        """Issue the self-draft loop; the drafts stay on the device and
        feed the verify input."""
        ad = self.adapter
        out = ad.app._run_spec_draft(ctx.first, ctx.positions,
                                     ctx.block_table, ctx.widths,
                                     ctx.num_drafts, row_seeds=ctx.seeds,
                                     adapter_ids=ctx.aids)
        ad.host_stats["dispatches"] += 1
        ad.host_stats["spec_draft_dispatches"] += 1
        ad.host_stats["device_steps"] += ctx.num_drafts
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.spec_draft", cat="adapter",
                        engine=ad.engine_name, rows=ctx.b,
                        pad_to=ctx.padded_batch, drafts=ctx.num_drafts,
                        seq_ids=list(ctx.live))
        return out["tokens"]

    def _dispatch_propose(self, proposer, ctx: _SpecContext):
        """A proposer's own draft work (the Medusa heads, the EAGLE chain):
        device work only, the tokens stay on the device."""
        ad = self.adapter
        toks = proposer._propose_device(ctx)
        ad.host_stats["dispatches"] += 1
        ad.host_stats["spec_draft_dispatches"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.spec_draft", cat="adapter",
                        engine=ad.engine_name, rows=ctx.b,
                        pad_to=ctx.padded_batch, drafts=ctx.num_drafts,
                        proposer=proposer.name, seq_ids=list(ctx.live))
        return toks

    def _dispatch_eagle_refresh(self, proposer, ctx: _SpecContext, hidden):
        """The EAGLE draft-cache refresh with the verified pairs."""
        ad = self.adapter
        proposer._refresh_device(ctx, hidden)
        ad.host_stats["dispatches"] += 1
        ad.host_stats["spec_draft_dispatches"] += 1

    def _dispatch_spec_verify(self, ctx: _SpecContext, cand, pos_w, slots):
        """Issue THE verify dispatch (one per engine step), with the hidden
        states when the proposer wants them."""
        ad = self.adapter
        out = ad.app._run_spec_verify(cand, pos_w, slots, ctx.block_table,
                                      ctx.widths, row_seeds=ctx.seeds,
                                      want_hidden=self.proposer.wants_hidden,
                                      adapter_ids=ctx.aids)
        ad.host_stats["dispatches"] += 1
        ad.host_stats["spec_verify_dispatches"] += 1
        ad.host_stats["device_steps"] += 1
        rec = _get_recorder()
        if rec.enabled:
            rec.instant("dispatch.spec_verify", cat="adapter",
                        engine=ad.engine_name, rows=ctx.b,
                        pad_to=ctx.padded_batch, width=int(cand.shape[1]),
                        seq_ids=list(ctx.live))
        return out

    def _fetch_verify(self, out, b: int):
        """The ONE blocking copy of a speculative step: tokens and
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
                         engine=ad.engine_name, rows=b, phase="spec")
        return both[:, :-1], both[:, -1]
