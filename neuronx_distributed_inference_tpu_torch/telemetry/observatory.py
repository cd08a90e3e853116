"""Compiled-graph observatory of the port: static truth about the serving
graphs (counterpart:
``neuronx_distributed_inference_tpu/telemetry/observatory.py`` —
``_cost`` :434, ``_memory`` :449, ``_graph_entries`` :475-583 and
``analyze_app`` :592-724; schema ``nxdi-graph-report-v1``).

:func:`analyze_app` walks the same (kind, bucket) graphs the reference
lowers from an application's bucket ladders and reports, per graph,
``compile_seconds``, ``flops``, ``bytes_accessed``, ``memory``,
``arithmetic_intensity`` and a ``roofline``, and sets the gauges
``nxdi_compile_seconds`` / ``nxdi_graph_flops`` / ``nxdi_graph_bytes`` /
``nxdi_graph_peak_bytes`` (labels ``kind`` + ``bucket``) on a live
registry.

PyTorch has no compiled program to ask, so the port counts the work
itself, and touches no device state: each graph's step function runs
under ``torch._subclasses.FakeTensorMode`` over fake copies of the
parameters and the cache (shapes, dtypes and devices, no storage; the
step's in-place cache writes land on the fakes), inside a counting
``TorchDispatchMode`` that adds up

  * ``flops``: the product ops' formulas of ``torch.utils.flop_counter``
    (matmuls, batched matmuls, convolutions, SDPA); elementwise ops count
    none, where XLA's cost analysis counts them too;
  * ``bytes_accessed``: each op's tensor inputs plus outputs, as XLA
    reckons an unfused op, except that views, allocations and metadata
    queries move nothing, a gather reads only what it gathers (its
    indices plus twice its output) and an in-place write moves twice the
    data it writes, not its destination.

The three hand-written kernels (``ops/decode_attention.
paged_decode_attention`` and ``decode_attention_stacked``,
``ops/flash_attention.flash_attention``) cannot run on fake tensors: given
fake inputs, each wrapper returns an empty output of its shape (launching
nothing, running no twin, counting no launch), and the counter, a
``decode_attention.kernel_work_listener``, hears the kernel's own work by
the formula its bound in PERF.md uses (``paged_decode_work``,
``stacked_decode_work``, ``flash_work``, beside the wrappers), taken at the
graph's capacity since a static graph knows no lengths. So the report
reads the same work on the CPU, where the wrappers would run their plain
twins, and on the card.

``compile_seconds`` and ``memory``: PyTorch eager builds nothing per
shape. A graph the app captured into a CUDA graph
(``models/cuda_graphs.py``) reports its capture's wall time (warm-up
calls plus capture) and ``memory`` = {``argument_bytes`` (parameters and
cache), ``pool_bytes`` (the capture's growth of
``torch.cuda.memory_allocated``), ``peak_bytes`` (their sum)}; an eager
graph reports ``compile_seconds`` 0.0 and ``memory`` None, and so does
every graph on the CPU.

The roofline takes the card's figures from :data:`DEVICE_PEAKS`, keyed by
``torch.cuda.get_device_name()`` (the H100 SXM data sheet: 3.35 TB/s HBM3,
989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32), at the
model dtype's rate; the keyword arguments override them. On the CPU or an
unknown card ``roofline`` is None; a zero figure means an unknown chip,
as in the reference.

The collective census (reference ``mesh_comm_labels`` :269,
``census_collectives`` :319, ``aggregate_census`` :361, ``_wire_factor``
/ ``_wire_bytes`` / ``_wire_bytes_saved`` :379-412,
``comm_roofline_seconds`` :414): over an app with a mesh every collective
of ``parallel/collectives`` the step makes on the fake copies is heard
(``collectives.collective_listener``) and recorded as the reference's
census entry {"kind", "comm", "dtype", "bytes", "elems", "elem_bytes",
"group_size"} (``comm`` the mesh axis, "tp"; the quantized ring's hops
``collective_permute``s of s8 / f8e4m3fn codes and f32 scales). Each
graph reports ``collectives`` (by "kind@comm@dtype"), ``collective_count``
and ``collective_bytes``, and the roofline's comm leg prices the ring
model's wire bytes at ``ici_gbps`` (the card's link figure: NVLink's 450
GB/s a direction on the H100 SXM) or, on an axis the topology marks,
``dcn_gbps``. Without a mesh they are None, and the single-device guard
stays: a ``c10d`` / ``_c10d_functional`` op seen while counting raises
``RuntimeError``, as the reference raises on a collective in an unsharded
graph. ``capture_compiler_stderr`` reads XLA's log and has no
counterpart here.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from . import metrics as tmetrics
from .registry import get_registry
from ..ops import decode_attention
from ..parallel import collectives as coll_mod
from ..parallel.mesh import Topology, topology_from_env

__all__ = ["analyze_app", "device_peaks", "DEVICE_PEAKS",
           "GRAPH_REPORT_SCHEMA", "aggregate_census", "census_collectives",
           "comm_roofline_seconds", "mesh_comm_labels"]

GRAPH_REPORT_SCHEMA = "nxdi-graph-report-v1"

#: Peak rates by card (a substring of ``torch.cuda.get_device_name()``):
#: HBM GB/s and TFLOP/s per dtype. The H100 SXM data sheet: 3.35 TB/s of
#: HBM3, 989 TFLOP/s dense bf16 (tensor cores), 67 TFLOP/s fp32 (CUDA
#: cores). ``chip_smoke.py``'s kernel bounds read them from here.
DEVICE_PEAKS: Dict[str, Dict[str, Any]] = {
    "H100": {"hbm_gbps": 3350.0, "link_gbps": 450.0,
             "peak_tflops": {"bfloat16": 989.0, "float32": 67.0}},
}

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_aten = torch.ops.aten
# ops that move no data (besides the views the schema marks)
_FREE = {_aten._unsafe_view, _aten.detach, _aten.lift_fresh,
         _aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided}
# ops that read only the rows they gather
_GATHERS = {_aten.index, _aten.index_select, _aten.gather,
            _aten.embedding}
# the products with an ``out_dtype`` (a bf16 pair into fp32 on the card,
# ``ops/attention._bmm_f32``): their result follows from the shapes, and
# the fake-tensor decomposition of some torch releases fails on them
_OUT_DTYPE = {getattr(getattr(_aten, op), ov)
              for op in ("mm", "addmm", "bmm", "baddbmm")
              for ov in ("dtype", "dtype_out")}


def device_peaks(device) -> Optional[Dict[str, Any]]:
    """The :data:`DEVICE_PEAKS` entry of ``device``'s card, or None (the
    CPU, an unknown card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in DEVICE_PEAKS.items():
        if key in name:
            return peaks
    return None


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class _WorkCounter(TorchDispatchMode):
    """Adds up the flops and bytes of every op dispatched under it (see the
    module docstring), plus the hand-written kernels' work handed over by
    their wrappers (:meth:`kernel`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NAMESPACES:
            raise RuntimeError(
                f"single-device graph runs the collective {func}: a "
                "process-group op leaked into the unsharded path")
        packet = func.overloadpacket
        if func in _OUT_DTYPE:
            out, flops = _product_out(func, args, kwargs)
            self.flops += flops
        else:
            out = func(*args, **kwargs)
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        self.bytes += _op_bytes(func, packet, args, kwargs, out)
        return out


def _named(func, args, kwargs) -> Dict[str, Any]:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    return named


def _product_out(func, args, kwargs):
    """(result, flops) of an ``out_dtype`` product without running it:
    its ``out``, or an empty tensor of the product's shape and dtype; 2 x
    the multiply-adds."""
    named = _named(func, args, kwargs)
    a, b = [v for k, v in named.items()
            if k in ("self", "mat1", "mat2", "batch1", "batch2")][-2:]
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    flops = 2 * int(np.prod(shape, dtype=np.int64)) * a.shape[-1]
    out = named.get("out")
    if out is None:
        out = torch.empty(shape, dtype=named["out_dtype"], device=a.device)
    return out, flops


def _op_bytes(func, packet, args, kwargs, out) -> int:
    if (func.is_view or packet in _FREE or func.namespace == "prim"
            or not _nbytes(out)):
        return 0                   # views, allocations, metadata queries
    if packet in _GATHERS:
        return _nbytes(list(args[1:])) + 2 * _nbytes(out)
    named = _named(func, args, kwargs)
    written = {a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    if written:
        return 2 * _nbytes([v for k, v in named.items()
                            if k not in written])
    return _nbytes(list(named.values())) + _nbytes(out)


# -- the collective census (reference :269-431) ------------------------------

# torch dtype names -> the reference's HLO element type names
_HLO_DTYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
               "int8": "s8", "uint8": "u8", "float8_e4m3fn": "f8e4m3fn",
               "int32": "s32", "int64": "s64", "bool": "pred"}


_AXES = ("dp", "cp", "ep", "tp")


def _mesh_shape(mesh) -> Tuple[int, ...]:
    return (mesh.dp, mesh.cp, mesh.ep, mesh.tp)


def mesh_comm_labels(mesh) -> Dict[frozenset, str]:
    """Replica-group signatures -> the mesh axes they ride (reference
    :269) over the port's live axes, in the counterpart's order (dp, cp,
    ep, tp; rank r = ((dp_rank·cp + cp_rank)·ep + ep_rank)·tp +
    tp_rank): ``{{0,1},{2,3}} -> "tp"``, ``{{0,2},{1,3}} -> "ep"``, the
    whole group ``"ep+tp"`` at ep 2 x tp 2, ``{{0,2},{1,3}} -> "dp"`` at dp
    2 x tp 2. Only axes with extent > 1 participate."""
    if mesh is None or mesh.size <= 1:
        return {}
    live = [i for i, n in enumerate(_mesh_shape(mesh)) if n > 1]
    out: Dict[frozenset, str] = {}
    for bits in range(1, 1 << len(live)):
        subset = [live[i] for i in range(len(live)) if bits & (1 << i)]
        out.setdefault(_signature(mesh, subset),
                       "+".join(_AXES[i] for i in subset))
    return out


def _signature(mesh, subset: List[int]) -> frozenset:
    """The replica groups of the mesh axes ``subset`` (indices into
    ``_AXES``): the sets of ranks that differ only along them."""
    shape = _mesh_shape(mesh)
    rest = [i for i in range(len(shape)) if i not in subset]
    grouped = np.arange(mesh.size).reshape(shape).transpose(
        rest + subset).reshape(-1, int(np.prod([shape[i] for i in subset])))
    return frozenset(frozenset(int(x) for x in row) for row in grouped)


def _group_sig(mesh, axis: str) -> frozenset:
    """The replica-group signature of the port's ``axis`` group ("mp":
    each replica's ep·tp ranks; "dp" / "cp": one axis)."""
    return _signature(mesh, [2, 3] if axis == "mp"
                      else [_AXES.index(axis)])


def census_collectives(heard: List[Dict[str, Any]], mesh
                       ) -> List[Dict[str, Any]]:
    """The census entries (reference :319) of the collectives heard on
    the fake copies: each op's kind, the axis it rides (the replica's
    model-parallel group, or the dp or cp group: the label of its
    replica-group signature), its wire dtype, elements, element bytes,
    result bytes and group size."""
    labels = mesh_comm_labels(mesh)
    comms = {axis: labels.get(_group_sig(mesh, axis), "other")
             for axis in ("mp", "dp", "cp")}
    return [{"kind": e["kind"], "comm": comms[e.get("axis", "mp")],
             "dtype": _HLO_DTYPES.get(e["dtype"], e["dtype"]),
             "bytes": e["elems"] * e["elem_bytes"], "elems": e["elems"],
             "elem_bytes": e["elem_bytes"], "group_size": e["group_size"]}
            for e in heard]


def aggregate_census(entries) -> Dict[str, Dict[str, Any]]:
    """``{"kind@comm@dtype": {"count", "bytes"}}`` (reference :361)."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        key = f"{e['kind']}@{e['comm']}@{e.get('dtype', 'f32')}"
        slot = out.setdefault(key, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += e["bytes"]
    return out


def _wire_factor(kind: str, group_size: int) -> float:
    """How many times an op's result bytes cross the wire a device under
    the ring model (reference :379)."""
    g = max(group_size, 2)
    if kind == "all_reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce_scatter":
        return float(g - 1)
    if kind == "collective_permute":
        return 1.0
    return (g - 1) / g


def _wire_bytes(entry: Dict[str, Any]) -> float:
    if "elems" in entry and "elem_bytes" in entry:
        b = float(entry["elems"] * entry["elem_bytes"])
    else:
        b = float(entry["bytes"])
    return _wire_factor(entry["kind"], entry["group_size"]) * b


def _wire_bytes_saved(entry: Dict[str, Any]) -> float:
    """Wire bytes a sub-fp32 numeric payload avoids against fp32 of the
    same shape (reference :400)."""
    eb = entry.get("elem_bytes", 4)
    if eb >= 4 or entry.get("dtype") == "pred" or "elems" not in entry:
        return 0.0
    return (_wire_factor(entry["kind"], entry["group_size"])
            * entry["elems"] * (4 - eb))


def comm_roofline_seconds(entries, ici_gbps: float, dcn_gbps: float,
                          topology: Optional[Topology] = None) -> float:
    """Wire time of one invocation's collectives (reference :414): an
    axis the ``topology`` marks as DCN-crossing at ``dcn_gbps``, every
    other at ``ici_gbps``."""
    if topology is None:
        topology = topology_from_env()
    total = 0.0
    for e in entries:
        axes = set(e["comm"].split("+"))
        bw = dcn_gbps if topology.is_dcn(axes) else ici_gbps
        if bw > 0:
            total += _wire_bytes(e) / (bw * 1e9)
    return total


# -- the graph list (reference _graph_entries :475-583) ---------------------

def _graph_entries(app) -> List[Tuple[str, str, Optional[tuple],
                                      Callable[[Callable], Any]]]:
    """(kind, bucket label, the app's graph key or None for an eager
    graph, run) for every graph of ``app``'s bucket ladders; ``run(f)``
    calls the step function with every tensor argument passed through
    ``f`` (the fake-copy conversion)."""
    from ..models import model_base
    cfg = app.tpu_config
    spec = app.spec
    chunk = max(cfg.decode_chunk_tokens, 1)
    entries: List[Tuple[str, str, Optional[tuple], Callable]] = []

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=app.device)

    def common(f, b):
        return (f(app.params), f(app.cache),
                f(app._default_sampling_params(b)), f(app._inv_freq))

    if getattr(cfg, "is_block_kv_layout", False):
        b = cfg.batch_size
        wbt = app.max_blocks
        mode, graphable = app._sampling_mode(None)
        seeds = app._stream_seeds(None, b)
        logits = bool(cfg.output_logits)

        def seeds_of(f):
            return None if seeds is None else f(torch.as_tensor(
                seeds, device=app.device))

        def paged(w):
            def run(f):
                params, cache, sp, inv = common(f, b)
                return model_base.paged_forward_step(
                    spec, cfg, params, cache, f(i32(b, w)), f(i32(b, w)),
                    f(i32(b, w, fill=-1)), f(i32(b, wbt)), f(i32(b)), sp,
                    app.generator, inv, seeds_of(f), None)
            return run

        for w in list(app.ctx_buckets) + [1]:
            key = (("paged", 1, (b, wbt, mode, logits, False))
                   if w == 1 and graphable else None)
            entries.append(("paged", f"w{w}xb{b}", key, paged(w)))
        if chunk > 1:
            def loop(f):
                params, cache, sp, inv = common(f, b)
                return model_base.paged_decode_loop(
                    spec, cfg, params, cache, f(i32(b)), f(i32(b)),
                    f(i32(b, wbt)), sp, app.generator, num_steps=chunk,
                    inv_freq=inv, row_seeds=seeds_of(f))
            entries.append(("paged_loop", f"k{chunk}xb{b}", None, loop))
        sw = 4                      # the default self-draft ladder top + 1

        def verify(f):
            params, cache, sp, inv = common(f, b)
            return model_base.paged_spec_verify(
                spec, cfg, params, cache, f(i32(b, sw)), f(i32(b, sw)),
                f(i32(b, sw, fill=-1)), f(i32(b, wbt)), f(i32(b, fill=1)),
                sp if seeds is not None else None, seeds_of(f), inv)
        entries.append(("spec_verify", f"W{sw}xb{b}", None, verify))

        def ragged(lora):
            def run(f):
                params, cache, sp, inv = common(f, b)
                return model_base.paged_ragged_step(
                    spec, cfg, params, cache, f(i32(b, sw)), f(i32(b, sw)),
                    f(i32(b, sw, fill=-1)), f(i32(b, wbt)),
                    f(i32(b, fill=1)), f(i32(b)), sp,
                    app.generator, inv, verify=False,
                    row_seeds=seeds_of(f),
                    adapter_ids=f(i32(b)) if lora else None)
            return run
        entries.append(("ragged", f"W{sw}xb{b}", None, ragged(False)))
        if spec.lora is not None:
            entries.append(("ragged_lora", f"W{sw}xb{b}", None,
                            ragged(True)))
        return entries

    cb = cfg.ctx_batch_size

    def prefill(s):
        def run(f):
            params, cache, sp, inv = common(f, cb)
            return model_base.context_encoding_step(
                spec, cfg, params, cache, f(i32(cb, s)), f(i32(cb, s)),
                f(torch.arange(cb, dtype=torch.int32, device=app.device)),
                f(i32(cb, fill=1)), sp, app.generator, inv, None)
        return run

    for s in app.ctx_buckets:
        entries.append(("prefill", f"ctx{s}xb{cb}", None, prefill(s)))
    logits = bool(cfg.output_logits)
    for bb in app.batch_buckets:
        sid = np.arange(bb, dtype=np.int32)
        identity = app._identity_rows(sid)
        kernel = model_base.use_contiguous_decode_kernel(
            spec, 1, bb, app.cache, identity)
        view = None if kernel else app._kv_bucket(cfg.seq_len)
        greedy = app._greedy(app._default_sampling_params(bb))
        key = (("decode", view, (bb, 1, identity, kernel, greedy, logits,
                                 False)) if greedy else None)

        def decode(f, bb=bb, sid=sid, view=view, identity=identity):
            params, cache, sp, inv = common(f, bb)
            return model_base.token_generation_step(
                spec, cfg, params, cache, f(i32(bb, 1)), f(i32(bb, 1)),
                f(torch.as_tensor(sid, device=app.device)), sp,
                app.generator, view, inv, None, identity=identity)
        entries.append(("decode", f"b{bb}", key, decode))
        if chunk > 1:
            def dloop(f, bb=bb, sid=sid):
                params, cache, sp, inv = common(f, bb)
                return model_base.decode_loop(
                    spec, cfg, params, cache, f(i32(bb)), f(i32(bb)),
                    f(torch.as_tensor(sid, device=app.device)), sp,
                    app.generator, num_steps=chunk,
                    kv_view=app._kv_bucket(cfg.seq_len), inv_freq=inv)
            entries.append(("decode_loop", f"b{bb}xk{chunk}", None, dloop))
    return entries


def _count(run, heard: Optional[List[Dict[str, Any]]] = None
           ) -> Tuple[int, int]:
    """(flops, bytes) of one step function over fake copies; the
    collectives it makes are appended to ``heard``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(x):
        if isinstance(x, torch.Tensor):
            return mode.from_tensor(x)
        if isinstance(x, dict):
            return {k: fake(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(fake(v) for v in x)
        return x

    counter = _WorkCounter()
    heard = [] if heard is None else heard
    with decode_attention.kernel_work_listener(counter.kernel), \
            coll_mod.collective_listener(heard.append), mode, counter:
        run(fake)
    return counter.flops, counter.bytes


def analyze_app(app, registry=None, hbm_gbps: Optional[float] = None,
                peak_tflops: Optional[float] = None,
                ici_gbps: Optional[float] = None,
                dcn_gbps: Optional[float] = None) -> Dict[str, Any]:
    """Count every bucket-ladder graph of ``app`` and return the graph
    report (see the module docstring). Gauges are recorded on
    ``registry`` (default: the process-global one) when it is enabled.
    ``hbm_gbps`` / ``peak_tflops`` override the card's figures;
    ``ici_gbps`` / ``dcn_gbps`` are recorded for the comm leg a mesh will
    price (default: the card's link figure, else ``NXDI_TPU_ICI_GBPS`` /
    ``NXDI_TPU_DCN_GBPS``, 200 / 25). Touches no device state: the
    parameters and the cache are read for their shapes only."""
    reg = registry if registry is not None else get_registry()
    if app.params is None:
        raise ValueError("load_weights() or init_random_weights() first")
    if app.cache is None:
        raise ValueError("init_cache() first")
    peaks = device_peaks(app.device) or {}
    dtype = str(app.spec.dtype).replace("torch.", "")
    if hbm_gbps is None:
        hbm_gbps = float(peaks.get("hbm_gbps", 0.0))
    if peak_tflops is None:
        peak_tflops = float(peaks.get("peak_tflops", {}).get(dtype, 0.0))
    if ici_gbps is None:
        ici_gbps = float(peaks.get("link_gbps") or os.environ.get(
            "NXDI_TPU_ICI_GBPS", "200"))
    if dcn_gbps is None:
        dcn_gbps = float(os.environ.get("NXDI_TPU_DCN_GBPS", "25"))
    mesh = getattr(app, "mesh", None)
    app_census: List[Dict[str, Any]] = []
    argument_bytes = _nbytes(app.params) + _nbytes(app.cache)
    graphs_cache = app.graphs
    captured = set(graphs_cache.signatures()) if graphs_cache else set()
    graphs: List[Dict[str, Any]] = []
    for kind, bucket, key, run in _graph_entries(app):
        heard: List[Dict[str, Any]] = []
        flops, bytes_acc = _count(run, heard)
        census = (census_collectives(heard, mesh) if mesh is not None
                  else None)
        if census:
            app_census.extend(census)
        compile_s, mem = 0.0, None
        if key in captured:
            compile_s = graphs_cache.capture_seconds(key)
            pool = graphs_cache.pool_bytes(key)
            mem = {"argument_bytes": argument_bytes, "pool_bytes": pool,
                   "peak_bytes": argument_bytes + pool}
        roofline = None
        if peak_tflops > 0 and hbm_gbps > 0:
            # a zero figure means "unknown chip": the counts stay valid
            t_compute = flops / (peak_tflops * 1e12)
            t_memory = bytes_acc / (hbm_gbps * 1e9)
            t_comm = (comm_roofline_seconds(census, ici_gbps, dcn_gbps)
                      if census else 0.0)
            saved = (sum(_wire_bytes_saved(e) for e in census)
                     if census else 0.0)
            legs = {"compute": t_compute, "memory": t_memory,
                    "comm": t_comm}
            roofline = {
                "est_step_ms": round(max(legs.values()) * 1e3, 6),
                "bound": max(legs, key=legs.get),
                "t_compute_ms": round(t_compute * 1e3, 6),
                "t_memory_ms": round(t_memory * 1e3, 6),
                "t_comm_ms": round(t_comm * 1e3, 6),
                "comm_bytes_saved": int(round(saved)),
            }
        graphs.append({
            "kind": kind,
            "bucket": bucket,
            "label": f"{kind}/{bucket}",
            "compile_seconds": round(compile_s, 4),
            "flops": float(flops),
            "bytes_accessed": float(bytes_acc),
            "memory": mem,
            "arithmetic_intensity": (round(flops / bytes_acc, 3)
                                     if bytes_acc else None),
            "collectives": (aggregate_census(census)
                            if census is not None else None),
            "collective_count": (len(census) if census is not None
                                 else None),
            "collective_bytes": (sum(e["bytes"] for e in census)
                                 if census is not None else None),
            "roofline": roofline,
        })
        if reg.enabled:
            peak = mem["peak_bytes"] if mem else 0
            tmetrics.compile_seconds_gauge(reg).set(compile_s, kind=kind,
                                                    bucket=bucket)
            tmetrics.graph_flops_gauge(reg).set(flops, kind=kind,
                                                bucket=bucket)
            tmetrics.graph_bytes_gauge(reg).set(bytes_acc, kind=kind,
                                                bucket=bucket)
            tmetrics.graph_peak_bytes_gauge(reg).set(peak, kind=kind,
                                                     bucket=bucket)
    if reg.enabled and mesh is not None:
        coll_g = tmetrics.graph_collectives_gauge(reg)
        bytes_g = tmetrics.graph_collective_bytes_gauge(reg)
        for ckey, slot in aggregate_census(app_census).items():
            ckind, comm, cdtype = ckey.split("@", 2)
            coll_g.set(slot["count"], kind=ckind, comm=comm, dtype=cdtype)
            bytes_g.set(slot["bytes"], kind=ckind, comm=comm, dtype=cdtype)
    has_mesh = mesh is not None
    return {
        "schema": GRAPH_REPORT_SCHEMA,
        "backend": app.device.type,
        "device": (torch.cuda.get_device_name(app.device)
                   if app.device.type == "cuda" else str(app.device)),
        "mesh": ({"devices": mesh.size,
                  "axes": {a: n for a, n in zip(_AXES, _mesh_shape(mesh))
                           if n > 1}}
                 if has_mesh else {"devices": 1, "axes": {}}),
        "assumptions": {"hbm_gbps": hbm_gbps, "peak_tflops": peak_tflops,
                        "ici_gbps": ici_gbps, "dcn_gbps": dcn_gbps},
        "graphs": graphs,
        "totals": {
            "graphs": len(graphs),
            "compile_seconds": round(sum(g["compile_seconds"]
                                         for g in graphs), 4),
            "flops": sum(g["flops"] for g in graphs),
            "bytes_accessed": sum(g["bytes_accessed"] for g in graphs),
            "collectives": len(app_census) if has_mesh else None,
            "collective_bytes": (sum(e["bytes"] for e in app_census)
                                 if has_mesh else None),
            "comm_bytes_saved": (int(round(sum(
                _wire_bytes_saved(e) for e in app_census)))
                if has_mesh else None),
        },
    }
