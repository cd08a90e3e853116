"""The warm-up plane and the device-memory ledger of the port
(counterpart: ``neuronx_distributed_inference_tpu/serving/warmup.py`` —
``_paged_plan`` :103, ``_cb_plan`` :167, ``precompile`` :190,
``memory_ledger`` :294, ``admission_headroom`` :367).

:func:`precompile` walks the application's serving ladder through its own
``_run_*`` entry points at server start. Where the JAX package compiles one
XLA executable per shape, the port captures one CUDA graph per signature of
a T = 1 step (``models/cuda_graphs.py``), at every batch bucket (both
ragged paths pad to ``app.batch_buckets``, not only to ``batch_size``) and
every block-table or KV-view bucket:

  * paged app: the ragged step at W = 1 and the paged step at T = 1
    (greedy, or the coupled draw of a ``stream_seed`` config), and with
    ``spec_widths`` the self-draft loop at every draft count — dummy
    dispatches that write nothing: every slot is -1 (a draft row of width
    1 is frozen) and the table holds only the null block. A LoRA build
    (``lora_config``) adds each of them again with ``adapter_ids`` (all
    slot 0), the signatures ``ragged_lora``, ``paged_lora`` and
    ``spec_draft_lora`` (reference :116-163 warms ``ragged_lora``,
    ``paged_loop_lora`` and ``spec_verify_lora``; the port lists those
    two eager ones too), so the first multi-LoRA pass after warm-up
    captures nothing;
  * contiguous app: the decode step at each batch bucket (and each KV-view
    bucket where the gather path reads the cache) at positions past the
    cache, which write nothing to full rows. A rolling stack (the rolling
    cache, the local layers of the mixed cache) writes such a position at
    ``pos % w`` like any other: one slot of each row, which a request's
    prefill and decode rewrite before the rolling mask lets a query read
    it. The graph of a rolling or mixed app holds every stack of the
    cache, and computes its write slots and masks on the device from the
    replay's positions.

Wider grids (prefill windows and chunks, windowed context encoding, mixed
ragged passes, speculative verify windows, the fused decode loops) run
eagerly by design: PyTorch has
no per-shape build to save there. The plan lists them with the outcome
``eager`` and does not run them, and they are never steady-state
incidents.

Each graph's outcome maps onto the reference's three:

  * ``capture`` (reference ``compile``): the signature was new and a CUDA
    graph was captured; ``n_compiles`` counts captures;
  * ``eager`` (reference ``cache_load``): no build happened — an eager
    entry, or a graph signature run on the CPU, where nothing is captured;
    ``n_cache_loads`` counts them;
  * ``warm`` (reference ``warm``): the signature was seen already.

There is no ``_CompileCacheMonitor``: it listens to jax's compilation-
cache events, and a captured graph has no persistent cache to load from,
so ``cache_monitored`` is always False.

After the walk the application enters declared steady state: a later
first-seen graph signature is an incident (``nxdi_steady_state_recompiles
_total``, a ``compile.unexpected`` event on the request's trace, and
``warmup_state()["incidents"]``).

:func:`memory_ledger` is the live device-memory account of one adapter:
parameter bytes, the paged KV pool split by block state (reconciling with
``PagedEngineAdapter.debug_state()["blocks"]`` exactly), fragmentation and
the admission headroom; served as ``GET /v1/debug/memory``.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import model_base
from ..modules import autobucketing
from ..telemetry import metrics as tmetrics
from ..telemetry.registry import NULL_REGISTRY
from ..telemetry.trace import get_recorder as _get_recorder

__all__ = ["precompile", "memory_ledger", "admission_headroom",
           "WARMUP_SCHEMA", "LEDGER_SCHEMA"]

WARMUP_SCHEMA = "nxdi-warmup-report-v1"
LEDGER_SCHEMA = "nxdi-memory-ledger-v1"


# ---------------------------------------------------------------------------
# the warm-up plan
# ---------------------------------------------------------------------------
def _paged_plan(app, widths, bt_widths, chunk_tokens,
                spec_widths) -> List[tuple]:
    """(kind, bucket, thunk or None) over every table-width bucket and
    batch bucket: the ragged row ladder (W = 1 captured, wider eager), the
    paged T = 1 step (two-phase decode, ``generate``), the eager fused
    decode loop and, per speculative width w (reference
    serving/warmup.py:146-160), the draft loop of w - 1 steps (captured)
    and the verify window (eager); a LoRA build each of them again with
    ``adapter_ids`` (the ``*_lora`` kinds)."""
    cfg = app.tpu_config
    if widths is None:
        widths = autobucketing.ragged_row_buckets(app.ctx_buckets,
                                                  chunk_tokens)
    if bt_widths is None:
        bt_widths = list(app._bt_buckets)
    chunk = max(cfg.decode_chunk_tokens, 1)
    # a LoRA build warms every signature twice: without ids and with them
    # (slot 0, the zero adapter: the dummies write nothing either way)
    variants = [("", None)]
    if app.spec.lora is not None:
        variants.append(("_lora", 0))
    plan: List[tuple] = []
    for tw in bt_widths:
        for b in app.batch_buckets:
            bt = np.zeros((b, tw), np.int32)    # null block only: no writes
            zero = np.zeros((b, 1), np.int32)
            none = np.full((b, 1), -1, np.int32)     # every slot: no write
            for tag, slot in variants:
                aids = None if slot is None else np.full((b,), slot,
                                                         np.int32)

                def ragged(b=b, bt=bt, zero=zero, none=none, aids=aids):
                    app._run_ragged(zero, zero, none, bt,
                                    np.ones((b,), np.int32),
                                    np.zeros((b,), np.int32),
                                    adapter_ids=aids)

                def paged(b=b, bt=bt, zero=zero, none=none, aids=aids):
                    app._run_paged(zero, zero, none, bt,
                                   np.zeros((b,), np.int32),
                                   adapter_ids=aids)
                for w in sorted(widths):
                    plan.append(("ragged" + tag, w,
                                 ragged if w == 1 else None))
                plan.append(("paged" + tag, 1, paged))
                if chunk > 1:
                    plan.append(("paged_loop" + tag, chunk, None))
                for sw in sorted(spec_widths):
                    if sw > 1:
                        plan.append(("spec_draft" + tag, sw - 1,
                                     functools.partial(
                                         app._run_spec_draft,
                                         np.zeros((b,), np.int32),
                                         np.zeros((b,), np.int32), bt,
                                         np.ones((b,), np.int32), sw - 1,
                                         adapter_ids=aids)))
                    plan.append(("spec_verify" + tag, sw, None))
    return plan


def _cb_plan(app) -> List[tuple]:
    """The contiguous app: every prefill bucket and the windowed context
    encoding step (eager), and the decode step per batch bucket — per
    KV-view bucket too where the gather path reads the cache; at the full
    batch of continuous batching both the kernel's in-order rows and the
    gather's rows with a free one — at positions past the cache (no write
    to full rows)."""
    cfg = app.tpu_config
    chunk = max(cfg.decode_chunk_tokens, 1)
    plan: List[tuple] = [("prefill", s, None) for s in app.ctx_buckets]
    if cfg.windowed_context_encoding:
        plan.append(("windowed_cte", cfg.windowed_context_encoding, None))
    warm_batches = sorted(set(app.batch_buckets)
                          | {cfg.tkg_batch_size or cfg.batch_size})
    for bb in warm_batches:
        if chunk > 1:
            plan.append(("decode_loop", chunk, None))
        # rows 0..bb-1; where continuous batching takes those as the
        # identity rows (the kernel's full batch), also a full batch with a
        # free row, padded with row 0 as the adapters pad it: the gather
        full = np.arange(bb, dtype=np.int32)
        row_sets = [full]
        if cfg.is_continuous_batching and bb > 1 and app._identity_rows(full):
            row_sets.append(np.append(full[:-1], 0).astype(np.int32))
        for sid in row_sets:
            kernel = model_base.use_contiguous_decode_kernel(
                app.spec, 1, bb, app.cache, app._identity_rows(sid))
            views = ([None] if kernel or app._kv_bucket(1) is None
                     else list(app.tkg_buckets))
            for v in views:
                plan.append(("decode", v,
                             lambda bb=bb, v=v, sid=sid: app._decode_call(
                                 np.zeros((bb, 1), np.int32),
                                 np.full((bb, 1), cfg.seq_len, np.int32),
                                 sid, v)))
    return plan


def precompile(app, *, registry=None, widths: Optional[Sequence[int]] = None,
               bt_widths: Optional[Sequence[int]] = None,
               chunk_tokens: Optional[int] = None,
               spec_widths: Sequence[int] = (),
               declare_steady: bool = True) -> Dict[str, Any]:
    """Server-start warm-up: walk the plan through the application's own
    entry points, capture every graph signature, time each first-seen one
    into ``nxdi_compile_seconds{kind,bucket}`` and count it into
    ``nxdi_jit_compiles_total`` (a capture) or ``nxdi_jit_cache_hits_total``
    (anything else).

    ``registry``: the replica's metrics registry (default: the app's).
    ``widths`` / ``bt_widths`` override the ragged and table-width ladders;
    ``chunk_tokens`` caps the ragged row ladder as the adapter's
    ``prefill_chunk_tokens`` does. ``spec_widths``: the speculative verify
    widths (``autobucketing.spec_width_buckets(k + 1)`` for a proposer of
    k drafts) whose draft loops to capture. With ``declare_steady`` the
    app enters declared steady state afterwards.

    Returns the ``nxdi-warmup-report-v1`` dict (also kept on the app for
    ``/v1/debug/state["warmup"]``)."""
    if app.params is None:
        app.init_random_weights()
    if app.cache is None:
        app.init_cache()
    reg = registry if registry is not None else app.telemetry
    if hasattr(app, "_run_ragged"):
        plan = _paged_plan(app, widths, bt_widths, chunk_tokens,
                           spec_widths)
    else:
        plan = _cb_plan(app)
    on_card = app.device.type == "cuda"
    # the entry points' own _note_jit would double-count into the app's
    # registry while this walk does its classified accounting
    prev_override = app._telemetry_override
    app._telemetry_override = NULL_REGISTRY
    graphs: List[Dict[str, Any]] = []
    n_compiles = n_eager = n_warm = 0
    t_total0 = time.perf_counter()
    try:
        for kind, bucket, thunk in plan:
            if thunk is None:
                n_eager += 1
                graphs.append({"kind": kind, "bucket": bucket,
                               "seconds": 0.0, "outcome": "eager"})
                continue
            n_seen = len(app._jit_seen)
            n_graphs = len(app.graphs) if app.graphs is not None else 0
            t0 = time.perf_counter()
            thunk()
            if on_card:
                torch.cuda.synchronize(app.device)
            dt = time.perf_counter() - t0
            first_seen = len(app._jit_seen) > n_seen
            if app.graphs is not None and len(app.graphs) > n_graphs:
                outcome = "capture"
                n_compiles += 1
            elif first_seen:
                outcome = "eager"
                n_eager += 1
            else:
                outcome = "warm"
                n_warm += 1
            if reg.enabled:
                if outcome == "capture":
                    tmetrics.jit_compiles_counter(reg).inc(
                        kind=kind, bucket=str(bucket))
                else:
                    tmetrics.jit_cache_hits_counter(reg).inc(kind=kind)
                if first_seen:
                    tmetrics.compile_seconds_gauge(reg).set(
                        dt, kind=kind, bucket=str(bucket))
            graphs.append({"kind": kind, "bucket": bucket,
                           "seconds": dt, "outcome": outcome})
    finally:
        app._telemetry_override = prev_override
    total = time.perf_counter() - t_total0
    report = {
        "schema": WARMUP_SCHEMA,
        "n_graphs": len(graphs),
        "n_compiles": n_compiles,
        "n_cache_loads": n_eager,
        "n_warm_hits": n_warm,
        "total_seconds": total,
        "cache_monitored": False,
        "graphs": graphs,
    }
    app._warmup_report = report
    if declare_steady:
        app.declare_steady_state()
        if reg.enabled:
            # the incident counter is served (at 0) from steady state on
            tmetrics.steady_state_recompiles_counter(reg)
    rec = _get_recorder()
    if rec.enabled:
        rec.instant("compile", cat="app", kind="precompile",
                    bucket=str(len(graphs)),
                    sig=f"compiles={n_compiles} loads={n_eager} "
                        f"warm={n_warm} total_s={total:.3f}")
    return report


# ---------------------------------------------------------------------------
# the device-memory ledger
# ---------------------------------------------------------------------------
def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def memory_ledger(adapter, *, registry=None,
                  graph_report: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """One live device-memory account over a
    :class:`~.adapter.PagedEngineAdapter`: parameter bytes, the KV pool
    split by block state (reconciling with
    ``adapter.debug_state()["blocks"]`` exactly), the spill tier's
    residency (reference :294-357), fragmentation, the admission headroom
    and which block allocator runs (``kv.allocator``: "native" or
    "python"). Sets the ``nxdi_hbm_*`` gauges when ``registry`` is live.
    With an observatory ``graph_report`` (nxdi-graph-report-v1,
    ``telemetry.observatory.analyze_app``) the ledger gets a ``graphs``
    section: each graph's ``memory.peak_bytes`` by its label (None for a
    graph that runs eagerly; the reference reads XLA's
    ``memory_analysis()``)."""
    app = adapter.app
    mgr = getattr(app, "kv_mgr", None)
    if mgr is None:
        # contiguous-layout adapter: no block accounting to reconcile;
        # each stack's bytes (the mixed cache's local k_l / v_l too)
        return {"schema": LEDGER_SCHEMA,
                "model_bytes": _tensor_bytes(app.params),
                "kv": {"pool_bytes": _tensor_bytes(app.cache),
                       "stacks": {k: _tensor_bytes(v)
                                  for k, v in app.cache.items()}},
                "spill": None,
                "headroom": admission_headroom(adapter)}
    spec = mgr.spec
    pool_bytes = _tensor_bytes(app.cache)
    block_bytes = pool_bytes // spec.num_blocks
    usable = spec.num_blocks - 1               # block 0 is the null block
    free = int(mgr.allocator.num_free)
    in_use = usable - free
    unwritten = len(adapter._unwritten)
    live_tokens = sum(int(st.position) for st in adapter.seqs.values())
    live_tokens += sum(int(cst.done)
                       for cst in getattr(adapter, "_chunks", {}).values())
    alloc_slots = in_use * spec.block_size
    frag = (1.0 - live_tokens / alloc_slots) if alloc_slots else 0.0
    frag = min(max(frag, 0.0), 1.0)
    tier = getattr(adapter, "_kv_tier", None)
    spilled_bytes = int(tier.nbytes) if tier is not None else 0
    ledger: Dict[str, Any] = {
        "schema": LEDGER_SCHEMA,
        "model_bytes": _tensor_bytes(app.params),
        "kv": {
            "pool_bytes": pool_bytes,
            "block_bytes": block_bytes,
            "block_size": int(spec.block_size),
            "blocks": {"usable": usable, "free": free, "in_use": in_use,
                       "unwritten": unwritten},
            "bytes": {"used": in_use * block_bytes,
                      "free": free * block_bytes,
                      "unwritten": unwritten * block_bytes,
                      "spilled": spilled_bytes},
            "live_tokens": live_tokens,
            "fragmentation_ratio": frag,
            "allocator": mgr.allocator_kind,
        },
        "spill": (None if tier is None else
                  {"blocks": len(tier), "bytes": spilled_bytes,
                   "stats": dict(tier.stats)}),
        "headroom": admission_headroom(adapter),
    }
    if graph_report is not None:
        ledger["graphs"] = {
            g["label"]: (g.get("memory") or {}).get("peak_bytes")
            for g in graph_report.get("graphs", [])}
    reg = registry
    if reg is not None and reg.enabled:
        tmetrics.hbm_model_bytes_gauge(reg).set(ledger["model_bytes"])
        kv_gauge = tmetrics.hbm_kv_bytes_gauge(reg)
        for state, nbytes in ledger["kv"]["bytes"].items():
            kv_gauge.set(nbytes, state=state)
        tmetrics.kv_fragmentation_ratio_gauge(reg).set(frag)
    return ledger


def admission_headroom(adapter) -> Dict[str, int]:
    """The scheduler's capacity-reject log line: free batch slots, free
    KV blocks, and the token headroom they represent."""
    out = {"free_slots": int(getattr(adapter, "free_capacity", 0))}
    mgr = getattr(getattr(adapter, "app", None), "kv_mgr", None)
    if mgr is not None:
        free = int(mgr.allocator.num_free)
        out["free_blocks"] = free
        out["headroom_tokens"] = free * int(mgr.spec.block_size)
    return out
