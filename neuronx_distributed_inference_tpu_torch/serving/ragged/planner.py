"""Ragged row planning: assemble ALL runnable work into ONE row plan (a
copy of ``neuronx_distributed_inference_tpu/serving/ragged/planner.py``
without the per-row LoRA slot: the port's adapter refuses ``lora_pool``).

The :class:`RaggedBatchPlanner` is the scheduling half of the ragged
unified dispatch (see the package docstring): each engine step it walks
the adapter's state — live decode rows, speculative verify windows, and
pending chunked-prefill admissions — and lays them out as ragged rows of
a single :func:`~...models.model_base.paged_ragged_step` dispatch. A
:class:`RaggedRow` carries everything the packer needs: the row's seq_id,
kind tag (``decode`` / ``verify`` / ``prefill``), absolute token offset,
real-token width, and (prefill rows) whether the chunk completes the
prompt.

Contracts the plan preserves from the two-phase paths it replaces:

  * pending admissions keep their admission order and their deadline
    semantics — a TARGETED expired pending row raises
    :class:`~...resilience.errors.DeadlineExceeded` before any device
    work; an untargeted one is merely skipped from packing;
  * ``prefill_budget_tokens`` survives as a per-step cap on REAL prompt
    tokens packed into the dispatch (the planner subsumes the old
    "at most one chunk dispatch BEFORE the decode dispatch"
    serialization point — prefill rows now ride the same dispatch);
  * total rows never exceed the compiled batch (admission already
    guarantees running + pending <= batch);
  * per-row verify widths are clamped exactly like the standalone
    speculative path: ``k+1`` bounded by seq_len headroom and the
    scheduler's per-row token room, floored at 1.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ...resilience.errors import DeadlineExceeded
from ..adapter import _meta_tenant, _trace_error

__all__ = ["RaggedRow", "RaggedPlan", "RaggedBatchPlanner",
           "KIND_DECODE", "KIND_PREFILL", "KIND_VERIFY"]

KIND_DECODE = "decode"
KIND_PREFILL = "prefill"
KIND_VERIFY = "verify"


@dataclass
class RaggedRow:
    """One row of the unified dispatch: ``width`` real tokens starting at
    absolute position ``offset`` over ``seq_id``'s own block table."""
    seq_id: int
    kind: str                  # KIND_DECODE | KIND_VERIFY | KIND_PREFILL
    offset: int                # absolute position of the row's first token
    width: int                 # real tokens in the row (>= 1)
    final: bool = False        # prefill row completing its prompt


@dataclass
class RaggedPlan:
    """The per-step row plan: live (decode/verify) rows first — in the
    step call's row order — then pending prefill rows in admission
    order. ``widths`` maps each live row to its candidate width for KV
    growth and rollback."""
    rows: List[RaggedRow]
    widths: Dict[int, int]

    @property
    def live_ids(self) -> List[int]:
        return [r.seq_id for r in self.rows if r.kind != KIND_PREFILL]

    @property
    def prefill_ids(self) -> List[int]:
        return [r.seq_id for r in self.rows if r.kind == KIND_PREFILL]

    def prune(self, adapter) -> None:
        """Drop rows whose sequence left the adapter mid-plan (preempted
        while growing KV for the dispatch)."""
        self.rows = [r for r in self.rows
                     if (r.seq_id in adapter._chunks
                         if r.kind == KIND_PREFILL
                         else r.seq_id in adapter.seqs)]


class RaggedBatchPlanner:
    """Assembles one :class:`RaggedPlan` per engine step from the paged
    adapter's live and pending state."""

    def __init__(self, adapter):
        self.adapter = adapter

    def plan(self, live: Sequence[int], target: Optional[Sequence[int]],
             token_room: Optional[Dict[int, int]],
             max_width: int) -> RaggedPlan:
        """``live``: decode-capable rows (already deadline-checked by the
        caller). ``target``: the step call's explicit seq_ids set (None =
        all) — governs whether an expired PENDING admission raises or is
        skipped. ``max_width``: speculative candidate cap (k+1; 1 =
        no speculation — plain decode rows)."""
        ad = self.adapter
        rows: List[RaggedRow] = []
        widths: Dict[int, int] = {}
        limit = ad._pos_limit
        for s in live:
            w = 1
            if max_width > 1:
                w = min(max_width, limit - ad.seqs[s].position)
                if token_room is not None and s in token_room:
                    w = min(w, token_room[s])
                w = max(1, int(w))
            widths[s] = w
            rows.append(RaggedRow(
                s, KIND_VERIFY if max_width > 1 else KIND_DECODE,
                ad.seqs[s].position, w))
        self._plan_prefill(rows, target)
        return RaggedPlan(rows, widths)

    def _plan_prefill(self, rows: List[RaggedRow],
                      target: Optional[Sequence[int]]) -> None:
        """Append pending-admission chunk rows (admission order) under the
        ``prefill_budget_tokens`` per-step cap and the compiled-batch row
        cap, enforcing the same deadline semantics as the old standalone
        chunk dispatch."""
        ad = self.adapter
        chunks = ad._chunks
        if not chunks:
            return
        order = sorted(chunks, key=lambda s: chunks[s].admit_idx)
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
                ad.telemetry.on_deadline(
                    fresh, [_meta_tenant(chunks[s].meta) for s in fresh])
                raise _trace_error(DeadlineExceeded(
                    f"seq_ids {hit} exceeded their wall-clock deadline "
                    "mid-prefill; release() them (or re-queue with a "
                    "fresh budget) and step again", seq_ids=hit))
            order = [s for s in order if s not in expired]
        budget = ad.prefill_budget_tokens
        left = float("inf") if budget is None else int(budget)
        for s in order:
            if len(rows) == ad.batch or left < 1:
                break
            st = chunks[s]
            n = int(min(len(st.prompt) - st.done,
                        ad.prefill_chunk_tokens, left))
            rows.append(RaggedRow(s, KIND_PREFILL, st.done, n,
                                  final=st.done + n == len(st.prompt)))
            left -= n
