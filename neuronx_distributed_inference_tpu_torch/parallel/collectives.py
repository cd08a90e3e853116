"""The collectives of the tensor-parallel model (counterpart:
``neuronx_distributed_inference_tpu/parallel/collectives.py`` —
``require_supported_dtype`` :54, ``_quantize_wire`` :62,
``_dequantize_wire`` :82, ``_resolve_block`` :89, ``quantized_all_reduce``
:98, ``quantized_reduce_scatter`` :143, ``quantized_row_parallel`` :203).

Where GSPMD inserts a collective into the JAX package's graphs, the port's
model code calls one of these over the :class:`~.mesh.Mesh`'s group:

  * :func:`all_reduce` — the row-parallel outputs (o_proj, down_proj),
    the vocabulary-parallel embedding, the full-width q/k norm's sum of
    squares;
  * :func:`all_gather` — the vocabulary-parallel logits;
  * :func:`gather_dim` — over the dp group, a step's rows (each replica
    runs its own, ``models/model_base`` and ``models/application``); over
    the cp group, a prefill's sequence chunks (context-parallel prefill
    and sequence parallelism);
  * :func:`all_reduce` with ``axis="cp"`` — the flash-decoding merge of
    each cp rank's partial softmax (a max, then sums);
  * :func:`gather_rows_uneven` — a step's rows over dp when the replicas
    ran different row counts (the contiguous cache's rows);
  * :func:`broadcast_object` — a new schema of rank 0's dispatch records
    (``parallel/dispatch``), pickled once, over the world;
  * :func:`quantized_all_reduce` / :func:`quantized_reduce_scatter` — the
    EQuARX-style two-phase ring with an int8 or fp8 wire payload
    (blockwise absmax scales, the JAX ring's rounding): g - 1 hops of
    quantize -> ``batch_isend_irecv`` to rank + 1 from rank - 1 ->
    dequantize -> accumulate, then the owned chunk's codes quantized once
    and passed on for g - 1 more hops. Accumulation stays in the
    activation dtype; only the payload is quantized.

A gloo group moves CUDA tensors through the host for the collectives
gloo has no CUDA path for (all-gather, send, receive): by design, and only
for a gloo group, which the caller chose (``Mesh.host_route``). An NCCL
group never takes that route.

Given fake tensors (the observatory's count, ``telemetry/observatory``),
every collective runs nothing and tells each open
:func:`collective_listener` its kind, group size, elements and wire
element bytes, then returns a fake result of the right shape.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..resilience.errors import ConfigurationError

# dtype knob values -> (wire dtype, symmetric qmax), as the JAX ring's
WIRE_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
SUPPORTED_DTYPES = tuple(WIRE_DTYPES)
DEFAULT_BLOCK = 32

_LISTENERS: List[Callable[[dict], None]] = []


@contextlib.contextmanager
def collective_listener(fn: Callable[[dict], None]):
    """While open, ``fn(entry)`` hears every collective made on fake
    tensors: {"kind", "group_size", "elems", "elem_bytes", "dtype",
    "axis"} (``axis`` the mesh axis it rides: "mp", "dp" or "cp")."""
    _LISTENERS.append(fn)
    try:
        yield fn
    finally:
        _LISTENERS.remove(fn)


def _is_fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _tell(kind: str, g: int, x: torch.Tensor, elems: int = None,
          axis: str = "mp") -> None:
    entry = {"kind": kind, "group_size": int(g),
             "elems": int(x.numel() if elems is None else elems),
             "elem_bytes": int(x.element_size()),
             "dtype": str(x.dtype).replace("torch.", ""), "axis": axis}
    for fn in list(_LISTENERS):
        fn(entry)


def require_supported_dtype(dtype: str) -> None:
    """Typed refusal for unsupported wire dtypes."""
    if dtype not in WIRE_DTYPES:
        raise ConfigurationError(
            f"unsupported collective dtype {dtype!r}: quantized collectives "
            f"support {sorted(WIRE_DTYPES)} (None disables)")


def _quantize_wire(x: torch.Tensor, dtype: str, block: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric quantize along the last dim: one fp32 absmax
    scale per ``block`` contiguous elements. Returns (q (..., C), scale
    (..., C // block))."""
    wire_dtype, qmax = WIRE_DTYPES[dtype]
    *lead, c = x.shape
    grouped = x.float().reshape(*lead, c // block, block)
    amax = grouped.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    scaled = grouped / scale
    if wire_dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(wire_dtype)
    return q.reshape(*lead, c), scale[..., 0]


def _dequantize_wire(q: torch.Tensor, scale: torch.Tensor, block: int,
                     out_dtype) -> torch.Tensor:
    *lead, c = q.shape
    grouped = q.float().reshape(*lead, c // block, block)
    return (grouped * scale[..., None]).reshape(*lead, c).to(out_dtype)


def _resolve_block(chunk: int, block: int) -> int:
    blk = min(block, chunk)
    if blk < 1 or chunk % blk != 0:
        raise ConfigurationError(
            f"collective block size {block} does not tile the per-shard ring "
            f"chunk of {chunk} elements; pick a block dividing the chunk")
    return blk


# ---------------------------------------------------------------------------
# plain collectives
# ---------------------------------------------------------------------------

def _extent(mesh, axis: str) -> int:
    return {"mp": mesh.mp, "dp": mesh.dp, "cp": mesh.cp}[axis]


def all_reduce(x: torch.Tensor, mesh, axis: str = "mp",
               op: str = "sum") -> torch.Tensor:
    """Sum (or with ``op="max"`` the max) over the ``axis`` group (in
    place on a contiguous ``x``, returned). A dp or cp axis of one rank
    returns ``x``."""
    x = x.contiguous()
    g = _extent(mesh, axis)
    if _is_fake(x):
        _tell("all_reduce", g, x, axis=axis)
        return x
    if axis != "mp" and g == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.axis_group(axis))
    return x


def gather_dim(x: torch.Tensor, mesh, axis: str = "mp",
               dim: int = -1) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in the ``axis``
    group's rank order (every rank's ``x`` of one shape). A dp or cp axis
    of one rank returns ``x``."""
    g = _extent(mesh, axis)
    dim = dim % x.dim()
    x = x.contiguous()
    shape = list(x.shape)
    shape[dim] *= g
    if _is_fake(x):
        _tell("all_gather", g, x, x.numel() * g, axis=axis)
        return x.new_empty(shape)
    if g == 1:
        return x
    group = mesh.axis_group(axis)
    if mesh.backend == "nccl":
        out = x.new_empty((g, *x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        src = x.cpu() if mesh.host_route else x
        parts = [torch.empty_like(src) for _ in range(g)]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts).to(x.device)
    return torch.movedim(out, 0, dim).reshape(shape)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` (…, n) along the last dim, in rank
    order: (…, tp * n)."""
    return gather_dim(x, mesh, "mp", -1)


def gather_rows_uneven(out: Optional[Dict[str, torch.Tensor]],
                       counts: Sequence[int], mesh,
                       device) -> Dict[str, torch.Tensor]:
    """Every replica's rows of a step's outputs, over the dp group, when
    the replicas ran ``counts[i]`` rows each (a replica of no rows passes
    ``out`` None): each tensor (counts[i], …) comes back as (sum(counts),
    …), replica after replica. The first replica with rows sends the
    outputs' keys, shapes and dtypes (one pickled broadcast), each tensor
    travels padded to max(counts) rows (one all-gather each)."""
    src = next(i for i, n in enumerate(counts) if n)
    meta = None
    if mesh.dp_rank == src:
        meta = {k: (tuple(v.shape[1:]), v.dtype) for k, v in out.items()}
    meta = broadcast_object(meta, mesh, axis="dp", src_index=src)
    top = max(counts)
    res = {}
    for k in sorted(meta):
        tail, dtype = meta[k]
        pad = torch.zeros((top, *tail), dtype=dtype, device=device)
        if out is not None and counts[mesh.dp_rank]:
            pad[:counts[mesh.dp_rank]] = out[k]
        every = gather_dim(pad, mesh, "dp", 0).reshape(
            mesh.dp, top, *tail)
        res[k] = torch.cat([every[i, :n] for i, n in enumerate(counts)])
    return res


def broadcast_object(obj: Any, mesh, axis: str = "world",
                     src_index: int = 0) -> Any:
    """``obj`` of the ``axis`` group's rank ``src_index`` (by default the
    mesh's rank 0 over the world) on every rank of the group
    (pickled)."""
    box = [obj]
    dev = mesh.device if mesh.backend == "nccl" else None
    group = mesh.axis_group(axis)
    src = (mesh.src if axis == "world" else
           dist.get_global_rank(group, src_index) if group is not None
           else src_index)
    dist.broadcast_object_list(box, src=src, group=group, device=dev)
    return box[0]


# ---------------------------------------------------------------------------
# the quantized two-phase ring
# ---------------------------------------------------------------------------

def _ring_pass(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Send each tensor to rank + 1 and receive its counterpart from rank
    - 1 (one ``batch_isend_irecv``). fp8 payloads travel as bytes."""
    g, r = mesh.mp, mesh.rank
    group = mesh.group
    nxt = dist.get_global_rank(group, (r + 1) % g) if group else (r + 1) % g
    prv = dist.get_global_rank(group, (r - 1) % g) if group else (r - 1) % g
    dev = tensors[0].device
    send = []
    for t in tensors:
        t = t.contiguous()
        if t.dtype == torch.float8_e4m3fn:
            t = t.view(torch.uint8)
        send.append(t.cpu() if mesh.host_route else t)
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in send]
           + [dist.P2POp(dist.irecv, t, prv, group) for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = []
    for got, like in zip(recv, tensors):
        got = got.to(dev)
        out.append(got.view(like.dtype) if like.dtype == torch.float8_e4m3fn
                   else got)
    return out


def _ring_reduce_scatter(x, mesh, dtype, blk):
    g, r = mesh.mp, mesh.rank
    blocks = list(torch.chunk(x, g, dim=-1))
    cur = blocks[(r - 1) % g]
    for step in range(g - 1):
        q, scale = _quantize_wire(cur, dtype, blk)
        q, scale = _ring_pass([q, scale], mesh)
        recv = _dequantize_wire(q, scale, blk, x.dtype)
        cur = recv + blocks[(r - step - 2) % g]
    return cur


def _check_ring(x, g, what):
    n = x.shape[-1]
    if n % g != 0:
        raise ConfigurationError(
            f"quantized {what} needs the reduced dim ({n}) divisible by the "
            f"ring group size ({g})")
    return n


def _fake_ring(x, g, dtype, blk, out_elems, phases):
    wire = WIRE_DTYPES[dtype][0]
    chunk = x.numel() // g
    for _ in range(phases * (g - 1)):
        _tell("collective_permute", g, torch.empty((), dtype=wire), chunk)
        _tell("collective_permute", g, torch.empty((), dtype=torch.float32),
              chunk // blk)
    return x.new_empty(out_elems)


def quantized_all_reduce(x: torch.Tensor, mesh, *, dtype: str = "int8",
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Two-phase quantized ring all-reduce of the local partial sum ``x``
    over ``mesh``'s group; the last dim is split into ``tp`` ring chunks
    (it must divide). The group of one returns ``x``."""
    require_supported_dtype(dtype)
    g, r = mesh.mp, mesh.rank
    if g <= 1:
        return x
    n = _check_ring(x, g, "all-reduce")
    blk = _resolve_block(n // g, block)
    if _is_fake(x):
        return _fake_ring(x, g, dtype, blk, x.shape, 2)
    cur = _ring_reduce_scatter(x, mesh, dtype, blk)
    out = [None] * g
    out[r] = cur
    q, scale = _quantize_wire(cur, dtype, blk)
    for step in range(g - 1):
        q, scale = _ring_pass([q, scale], mesh)
        out[(r - step - 1) % g] = _dequantize_wire(q, scale, blk, x.dtype)
    return torch.cat(out, dim=-1)


def quantized_reduce_scatter(x: torch.Tensor, mesh, *, dtype: str = "int8",
                             block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Quantized ring reduce-scatter over the last dim: rank r returns the
    fully reduced chunk r, (…, n // tp)."""
    require_supported_dtype(dtype)
    g = mesh.mp
    if g <= 1:
        return x
    n = _check_ring(x, g, "reduce-scatter")
    blk = _resolve_block(n // g, block)
    if _is_fake(x):
        return _fake_ring(x, g, dtype, blk, (*x.shape[:-1], n // g), 1)
    return _ring_reduce_scatter(x, mesh, dtype, blk)


def quantized_row_parallel(x: torch.Tensor, w: Any, mesh, *, dtype: str,
                           block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """A row-parallel product with the quantized ring on its output: ``x``
    (…, K / tp) is the rank's slice of the contraction, ``w`` its rows of
    the weight (an fp tensor or an int8 / fp8 leaf-group). An MXFP4 leaf
    (two codes a byte along K) keeps the plain fp32 all-reduce, as the
    JAX ring does."""
    from ..modules.quantization import qlinear
    require_supported_dtype(dtype)
    y = qlinear(x, w)
    if isinstance(w, dict) and w["qweight"].dtype == torch.uint8:
        return all_reduce(y, mesh)
    if mesh.mp > 1:
        n = y.shape[-1]
        if n % mesh.mp:
            raise ConfigurationError(
                f"quantized collectives need the output dim ({n}) divisible "
                f"by the model-parallel extent ({mesh.mp})")
        _resolve_block(n // mesh.mp, block)
    return quantized_all_reduce(y, mesh, dtype=dtype, block=block)


__all__ = ["WIRE_DTYPES", "SUPPORTED_DTYPES", "DEFAULT_BLOCK",
           "collective_listener", "require_supported_dtype", "all_reduce",
           "all_gather", "gather_dim", "gather_rows_uneven",
           "broadcast_object", "quantized_all_reduce",
           "quantized_reduce_scatter", "quantized_row_parallel"]
