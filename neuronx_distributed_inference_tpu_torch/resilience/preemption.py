"""Recompute preemption under KV pressure (vLLM-style RECOMPUTE mode) — a
copy of ``neuronx_distributed_inference_tpu/resilience/preemption.py``.

When the block pool cannot satisfy an allocation (admission or decode
growth), the paged adapter evicts the lowest-priority running sequence,
reclaims its blocks, and hands the engine a :class:`Preempted` record. The
record's ``tokens`` (prompt + everything generated so far, including the
not-yet-cached last sample) is re-queued verbatim as a new prompt: under
greedy sampling the recomputed continuation is bit-identical to an
uninterrupted run (pinned by ``tests/test_resilience.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

__all__ = ["Preempted", "PREEMPTION_POLICIES", "pick_victim"]

#: Victim-selection policies:
#:   ``lifo``             — evict the most recently admitted sequence (its
#:                          recompute cost is lowest; vLLM's default)
#:   ``fewest_generated`` — evict the sequence with the fewest generated
#:                          tokens (least decode work thrown away), ties
#:                          broken LIFO
PREEMPTION_POLICIES = ("lifo", "fewest_generated")


@dataclass(frozen=True)
class Preempted:
    """One evicted sequence, ready for the engine to re-queue.

    ``tokens`` is the full recompute prompt: original prompt + generated
    tokens (the last of which had been sampled but not yet written to KV —
    re-prefilling writes it and samples its successor, exactly as the
    interrupted decode would have).

    The record carries everything a requeue needs: ``deadline`` is the
    victim's ABSOLUTE ``perf_counter()`` deadline (None = unbounded) and
    ``meta`` is the adapter's opaque per-request passthrough (the serving
    engine parks tenant/priority/request identity there), so a scheduler
    never reconstructs admission arguments by hand —
    :meth:`admission_kwargs` splats straight into ``add_requests``.
    Sampling state needs no field: the adapters decode greedily, so the
    recompute prompt IS the complete sampling state and the replayed
    continuation is bit-identical (pinned from the adapter path by
    tests/test_resilience.py and from the engine path by
    tests/test_serving_engine.py)."""

    seq_id: int
    tokens: Tuple[int, ...]
    prompt_len: int
    n_generated: int
    reason: str                    # "grow" | "admission" | "scheduler"
    deadline: Optional[float] = None   # absolute perf_counter() deadline
    meta: Any = None                   # engine passthrough (tenant, ...)
    trace_id: Optional[str] = None     # flight-recorder "preempt" event id

    def admission_kwargs(self, seq_id: Optional[int] = None,
                         now: Optional[float] = None) -> Dict[str, Any]:
        """Keyword arguments that re-admit this record through
        ``PagedEngineAdapter.add_requests(**kwargs)``: the recompute
        prompt, the REMAINING relative deadline budget (the victim's
        clock keeps running while it waits), and the meta passthrough.
        ``seq_id`` defaults to the evicted id — pass a fresh one when the
        old id may have been reused."""
        if now is None:
            now = time.perf_counter()
        return {
            "seq_ids": [self.seq_id if seq_id is None else seq_id],
            "prompts": [list(self.tokens)],
            "deadline_s": [None if self.deadline is None
                           else max(self.deadline - now, 0.0)],
            "meta": [self.meta],
        }

    def to_json(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-safe serialization, so a requeue/handoff record can cross
        a process boundary (the fleet handoff contract rides this —
        serving/fleet/handoff.py). The absolute ``deadline`` is a
        ``perf_counter()`` value with no meaning in another process, so
        it is serialized as the REMAINING relative budget (the victim's
        clock keeps running while the record is in flight) and re-anchored
        by :meth:`from_json`. ``meta`` must itself be JSON-safe — the
        serving engine's meta (request_id/tenant/priority dict) is."""
        if now is None:
            now = time.perf_counter()
        return {
            "schema": "nxdi-preempted-v1",
            "seq_id": int(self.seq_id),
            "tokens": [int(t) for t in self.tokens],
            "prompt_len": int(self.prompt_len),
            "n_generated": int(self.n_generated),
            "reason": self.reason,
            "deadline_remaining_s": (None if self.deadline is None
                                     else max(self.deadline - now, 0.0)),
            "meta": self.meta,
            "trace_id": self.trace_id,
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any],
                  now: Optional[float] = None) -> "Preempted":
        """Inverse of :meth:`to_json`: re-anchors the remaining deadline
        budget to THIS process's ``perf_counter()`` clock. Raises
        ``KeyError`` on a wrong-schema payload (callers that accept
        records over the wire wrap it typed — see
        serving/fleet/handoff.py)."""
        if data.get("schema") != "nxdi-preempted-v1":
            raise KeyError(f"not an nxdi-preempted-v1 record: "
                           f"schema={data.get('schema')!r}")
        if now is None:
            now = time.perf_counter()
        rem = data["deadline_remaining_s"]
        return cls(
            seq_id=int(data["seq_id"]),
            tokens=tuple(int(t) for t in data["tokens"]),
            prompt_len=int(data["prompt_len"]),
            n_generated=int(data["n_generated"]),
            reason=str(data["reason"]),
            deadline=None if rem is None else now + float(rem),
            meta=data.get("meta"),
            trace_id=data.get("trace_id"),
        )


def pick_victim(policy: str,
                candidates: Iterable[Tuple[int, int, int]]) -> Optional[int]:
    """Choose the victim seq_id from ``(seq_id, admit_idx, n_generated)``
    tuples; ``None`` when there are no candidates. ``admit_idx`` is the
    adapter's monotonic admission counter."""
    cands = list(candidates)
    if not cands:
        return None
    if policy == "lifo":
        return max(cands, key=lambda c: c[1])[0]
    if policy == "fewest_generated":
        # ties (same generated count) fall back to LIFO
        return min(cands, key=lambda c: (c[2], -c[1]))[0]
    raise ValueError(f"unknown preemption policy {policy!r}; expected one "
                     f"of {PREEMPTION_POLICIES}")
