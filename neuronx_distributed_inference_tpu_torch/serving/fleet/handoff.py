"""Disaggregated prefill → decode handoff (counterpart:
``neuronx_distributed_inference_tpu/serving/fleet/handoff.py`` :60-205 and
the wire form :344-399).

A **prefill-role** engine admits and prefills (any
:class:`~..adapter.PagedEngineAdapter`); once a sequence's first token has
materialized, :func:`capture_handoff` snapshots it into a JSON-safe
record (the serialized :class:`~...resilience.preemption.Preempted`
payload plus the K/V payloads of its fully written blocks, read device →
host and keyed by chain hash) and releases it. A **decode-role** engine
admits the record with :func:`admit_handoff`: the payloads seed its
:class:`~.kv_tier.HostKVSpillTier`, and the record's prompt goes through
the ordinary transactional ``add_requests``, whose restore writes the KV
back instead of recomputing it. The record carries the prompt and every
sampled token (the last one's KV unwritten), so the decode side's greedy
continuation equals a single engine's run.

The JSON form is the reference's ``nxdi-handoff-v1`` byte for byte: the
payloads are base64 raw bytes with the numpy / ml_dtypes dtype name
(``"float32"``, ``"bfloat16"``, ``"float8_e4m3fn"``) and the shape, the
hashes hex. A record of either package admits in the other.

Two differences from the reference:

  * the chain is salted like the spill tier's (``adapter.tier_salt``):
    b"" for a base row (the reference's chain), the pooled adapter's name
    for a LoRA row, and a row whose salt is local to its engine is
    refused (:class:`HandoffError`), so a record never serves one
    adapter's KV to another's rows;
  * :func:`admit_handoff` refuses a record whose dtype or block shape
    ``(L, Bs, Hkv, D)`` differs from the decode engine's cache, before
    any state changes (the reference would cast).

Failures are typed :class:`HandoffError` with the failing side unchanged;
the ``handoff`` fault point fires on both sides. Live migration
(``migrate``) needs the fleet router and comes with it."""

from __future__ import annotations

import base64
from typing import Any, Dict, Optional

import torch

from ...parallel.mesh import refuse_over_mesh
from ...resilience.errors import HandoffError, ServingError
from ...resilience.faults import FAULTS as _FAULTS
from ...resilience.preemption import Preempted
from ...telemetry import get_registry
from ...telemetry import metrics as tmetrics
from ...telemetry.request_trace import trace_of
from ...telemetry.trace import get_recorder as _get_recorder
from ..adapter import tier_chain

__all__ = ["HANDOFF_SCHEMA", "capture_handoff", "admit_handoff",
           "handoff_to_json", "handoff_from_json"]

HANDOFF_SCHEMA = "nxdi-handoff-v1"


def _capture(adapter, seq_id: int, *, reason: str,
             now: Optional[float] = None):
    """Snapshot one RUNNING sequence into a handoff record without
    releasing it. Returns ``(record, pre)``; raises :class:`HandoffError`
    with the adapter unchanged."""
    st = adapter.seqs.get(seq_id)
    if st is None:
        state = ("still mid-prefill" if seq_id in getattr(
            adapter, "_chunks", {}) else "not running")
        raise HandoffError(
            f"cannot capture seq_id {seq_id}: {state}; hand off after "
            "its first token materializes", seq_ids=(seq_id,))
    salt = adapter.tier_salt(seq_id)
    if salt is None:
        raise HandoffError(
            f"seq_id {seq_id} runs under LoRA factors written outside the "
            "adapter pool: its KV is keyed to this engine and cannot be "
            "handed off", seq_ids=(seq_id,))
    mgr = adapter.app.kv_mgr
    bs = mgr.spec.block_size
    table = mgr.tables[seq_id]
    try:
        if _FAULTS.active:
            _FAULTS.fire("handoff")
        # full blocks whose every slot was written: (bi+1)*bs <= position
        # (position indexes the last SAMPLED token, whose KV is unwritten)
        cache = adapter.app.cache
        chain = tier_chain(st.tokens[:st.position], bs, salt)
        kv_blocks = [{"hash": h,
                      "k": cache["k"][:, table[bi]].to("cpu", copy=True),
                      "v": cache["v"][:, table[bi]].to("cpu", copy=True)}
                     for bi, h in enumerate(chain)]
    except ServingError:
        raise
    except Exception as e:
        raise HandoffError(
            f"{reason} capture of seq_id {seq_id} failed; the sequence "
            "is still running on the source engine",
            seq_ids=(seq_id,)) from e
    pre = Preempted(
        seq_id=seq_id, tokens=tuple(st.tokens), prompt_len=st.prompt_len,
        n_generated=len(st.tokens) - st.prompt_len, reason=reason,
        deadline=st.deadline, meta=st.meta)
    record = {
        "schema": HANDOFF_SCHEMA,
        "preempted": pre.to_json(now=now),
        "block_size": bs,
        "kv_blocks": kv_blocks,
        "kind": reason,
        "delivered_tokens": pre.n_generated,
        "trace": trace_of(pre.meta),
    }
    return record, pre


def capture_handoff(adapter, seq_id: int,
                    now: Optional[float] = None) -> Dict[str, Any]:
    """Snapshot one RUNNING sequence of a prefill-role adapter into a
    handoff record and release it: the ``Preempted`` payload (prompt and
    every sampled token, the remaining deadline, meta) and the K/V of
    every fully written block (positions ``[0, position)``). Raises
    :class:`HandoffError` for a pending or unknown seq_id, or a row whose
    KV is keyed to this engine, leaving the adapter unchanged."""
    refuse_over_mesh(adapter.app, "the prefill -> decode handoff")
    record, pre = _capture(adapter, seq_id, reason="handoff", now=now)
    adapter.release([seq_id])
    rec = _get_recorder()
    if rec.enabled:
        rec.instant("handoff.send", cat="fleet", seq_id=int(seq_id),
                    tokens=len(pre.tokens), blocks=len(record["kv_blocks"]),
                    engine=adapter.engine_name, trace=trace_of(pre.meta))
    reg = get_registry()
    if reg.enabled:
        tmetrics.handoffs_counter(reg).inc(role="send")
    return record


def admit_handoff(adapter, record: Dict[str, Any], seq_id: int,
                  now: Optional[float] = None) -> Dict[int, int]:
    """Admit a handoff record on a decode-role adapter: seed its spill
    tier with the record's payloads, then run the ordinary transactional
    ``add_requests`` (the restore writes the KV in place, only the
    uncovered suffix recomputes). Returns the adapter's first-token dict
    (``{}`` when its prefill is deferred, as on the ragged engine).
    Raises :class:`HandoffError`, before any state changes, for a
    malformed record, a decode adapter without a spill tier, or payloads
    whose dtype or block shape differ from its cache; admission failures
    propagate typed with the decode engine rolled back."""
    refuse_over_mesh(adapter.app, "the prefill -> decode handoff")
    tier = getattr(adapter, "_kv_tier", None)
    if tier is None:
        raise HandoffError(
            "decode-role adapter has no kv_spill_tier; build it with "
            "PagedEngineAdapter(app, kv_spill_tier=HostKVSpillTier(...)) "
            "so the handoff KV can be restored instead of recomputed")
    try:
        if _FAULTS.active:
            _FAULTS.fire("handoff")
        if record.get("schema") != HANDOFF_SCHEMA:
            raise KeyError(f"not an {HANDOFF_SCHEMA} record: "
                           f"schema={record.get('schema')!r}")
        mgr = adapter.app.kv_mgr
        if int(record["block_size"]) != mgr.spec.block_size:
            raise KeyError(
                f"handoff block_size {record['block_size']} != decode "
                f"engine's {mgr.spec.block_size}")
        pre = Preempted.from_json(record["preempted"], now=now)
        k = adapter.app.cache["k"]
        want = (k.dtype, (k.shape[0], *k.shape[2:]))
        payloads = {}
        for b in record["kv_blocks"]:
            for name in ("k", "v"):
                t = b[name]
                if not isinstance(t, torch.Tensor):
                    raise TypeError(f"payload {name} is "
                                    f"{type(t).__name__}, not a tensor")
                if (t.dtype, tuple(t.shape)) != want:
                    raise ValueError(
                        f"payload {name} is {t.dtype} "
                        f"{tuple(t.shape)}; the decode engine's cache "
                        f"holds {want[0]} {want[1]} blocks")
            payloads[b["hash"]] = {"k": b["k"], "v": b["v"]}
    except ServingError:
        raise
    except Exception as e:
        raise HandoffError(
            f"handoff admission failed before any decode-engine state "
            f"changed: {e}") from e
    tier.seed(payloads)
    first = adapter.add_requests(**pre.admission_kwargs(seq_id=seq_id,
                                                        now=now))
    rec = _get_recorder()
    if rec.enabled:
        rec.instant("handoff.recv", cat="fleet", seq_id=int(seq_id),
                    tokens=len(pre.tokens), blocks=len(payloads),
                    engine=adapter.engine_name, trace=trace_of(pre.meta))
    reg = get_registry()
    if reg.enabled:
        tmetrics.handoffs_counter(reg).inc(role="recv")
    return first


# ---------------------------------------------------------------------------
# JSON wire form (cross-process)
# ---------------------------------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    """The numpy / ml_dtypes name of a tensor's dtype ("bfloat16",
    "float8_e4m3fn", "float32")."""
    return str(t.dtype).replace("torch.", "")


def _raw(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def handoff_to_json(record: Dict[str, Any]) -> Dict[str, Any]:
    """Pure-JSON form of a handoff record: payloads as base64 raw bytes
    with dtype and shape, hashes as hex."""
    out = dict(record)
    out["kv_blocks"] = [{
        "hash": b["hash"].hex(),
        "dtype": _dtype_name(b["k"]),
        "shape": list(b["k"].shape),
        "k": base64.b64encode(_raw(b["k"])).decode("ascii"),
        "v": base64.b64encode(_raw(b["v"])).decode("ascii"),
    } for b in record["kv_blocks"]]
    return out


def _tensor(data: str, dtype: torch.dtype, shape) -> torch.Tensor:
    raw = bytearray(base64.b64decode(data))
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def handoff_from_json(data: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`handoff_to_json` (payloads become CPU tensors).
    Raises :class:`HandoffError` on malformed input."""
    try:
        out = dict(data)
        blocks = []
        for b in data["kv_blocks"]:
            dtype = getattr(torch, b["dtype"])
            if not isinstance(dtype, torch.dtype):
                raise TypeError(f"unknown dtype {b['dtype']!r}")
            shape = tuple(int(s) for s in b["shape"])
            blocks.append({"hash": bytes.fromhex(b["hash"]),
                           "k": _tensor(b["k"], dtype, shape),
                           "v": _tensor(b["v"], dtype, shape)})
        out["kv_blocks"] = blocks
        return out
    except Exception as e:
        raise HandoffError(f"malformed handoff JSON: {e}") from e
