"""Parameter declarations, their tensor-parallel cut and the GQA head
layout (counterpart: ``neuronx_distributed_inference_tpu/parallel/
layers.py`` — ``ParamSpec`` :34, ``column_parallel`` :51, ``row_parallel``
:61, ``row_parallel_output`` :70, ``vocab_parallel_embedding`` :88, the
expert variants :94-117, ``replicated_param`` :118, ``GQASharding`` /
``resolve_gqa_sharding`` :127-196 and the host-side head placement helpers
after them).

A ``ParamSpec``'s ``cuts`` are the counterpart of its ``pspec``: one
``(axis, mesh axis)`` pair for each axis the mesh cuts (the axis negative,
from the last; the mesh axis ``"mp"`` for the combined model-parallel
axis, ``"ep"`` or ``"tp"``), each into contiguous slices, rank r keeping
its index's (``parallel/mesh.Mesh.cut``); no cut is a replicated leaf. An
expert leaf ``(L, E, in, out)`` has two: E over ep, then its intermediate
over tp. ``parts`` cuts a fused axis part by part: the fused
``qkv_proj``'s global ``[q | k | v]`` becomes ``[q_r | k_r | v_r]`` on
rank r, each part cut by heads (a contiguous chunk of the fused axis is
not a rank's heads). :func:`shard_tensor` makes one cut, :func:`resolve_cuts`
turns a spec's cuts into a rank's (axis, parts, degree, index) list, and
``modules/quantization.shard_leaf`` applies such a list to plain,
quantized and low-rank leaves.

The head layout pads and replicates heads so the KV heads divide the
model-parallel degree (the conversion of checkpoints and of the JAX
package's trees places them so); each rank then holds ``num_q_heads /
mp`` query heads and ``num_kv_heads / mp`` KV heads."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .mesh import (AXIS_EP as EP, AXIS_MP as MP, AXIS_TP as TP,
                   AXIS_TP_EP as TP_EP)

# (axis, parts, degree, index): one cut of one leaf for one rank
Cut = Tuple[int, Optional[Tuple[int, ...]], int, int]


@dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + random-init rule of one weight tensor, and the axes
    the mesh cuts (``cuts``: (axis, mesh axis) pairs; ``parts`` the fused
    parts of the ``"mp"`` cut)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"   # "normal" | "zeros" | "ones"
    cuts: Tuple[Tuple[int, str], ...] = ()
    parts: Optional[Tuple[int, ...]] = None

    @property
    def split(self) -> Optional[int]:
        """The model-parallel axis of a leaf cut over every rank (None for
        a replicated leaf or an expert leaf)."""
        return next((a for a, name in self.cuts if name == MP), None)

    def initializer(self, generator: Optional[torch.Generator],
                    device: torch.device, scale: float = 0.02
                    ) -> torch.Tensor:
        """The leaf, drawn in place in its own dtype: the draw makes no
        temporary, so a bf16 expert stack of 29 B parameters needs its
        58 GB and nothing beside it."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        return out.normal_(0.0, scale, generator=generator)


def column_parallel(shape: Tuple[int, ...], dtype=torch.bfloat16,
                    init: str = "normal",
                    parts: Optional[Tuple[int, ...]] = None) -> ParamSpec:
    """A weight (…, in, out) or bias (…, out) cut on its output dim over
    every rank (the analog of ColumnParallelLinear, gather_output=False)."""
    return ParamSpec(tuple(shape), dtype, init, ((-1, MP),), parts)


def row_parallel(shape: Tuple[int, ...], dtype=torch.bfloat16,
                 init: str = "normal") -> ParamSpec:
    """A weight (…, in, out) cut on its input dim over every rank
    (RowParallelLinear, input_is_parallel=True); its output is summed
    over the group (:func:`row_parallel_output`)."""
    return ParamSpec(tuple(shape), dtype, init, ((-2, MP),))


def vocab_parallel_embedding(vocab: int, hidden: int,
                             dtype=torch.bfloat16) -> ParamSpec:
    """The (V, H) table cut on V (ParallelEmbedding with vocab_parallel)."""
    return ParamSpec((vocab, hidden), dtype, "normal", ((-2, MP),))


def expert_column_parallel(shape: Tuple[int, ...], dtype=torch.bfloat16,
                           init: str = "normal",
                           bias: bool = False) -> ParamSpec:
    """An expert weight (…, E, in, out), or with ``bias`` a bias (…, E,
    out): experts cut over ep, the output (intermediate) dim over tp (the
    counterpart's ``P(None, "ep", None, "tp")``, layers.py:94-105)."""
    return ParamSpec(tuple(shape), dtype, init,
                     ((-2 if bias else -3, EP), (-1, TP)))


def expert_row_parallel(shape: Tuple[int, ...], dtype=torch.bfloat16
                        ) -> ParamSpec:
    """An expert weight (…, E, in, out): experts over ep, the input
    (intermediate) dim over tp (``P(None, "ep", "tp", None)``, :108-117)."""
    return ParamSpec(tuple(shape), dtype, "normal", ((-3, EP), (-2, TP)))


def resolve_cuts(cuts, parts, mesh) -> List[Cut]:
    """A spec's ``cuts`` as this rank's (axis, parts, degree, index) list
    (``parts`` go with the ``"mp"`` cut); none without a mesh."""
    if mesh is None:
        return []
    out = []
    for axis, name in cuts:
        degree, index = mesh.cut(name)
        if degree > 1:
            out.append((axis, parts if name == MP else None, degree, index))
    return out


def replicated_param(shape: Tuple[int, ...], dtype=torch.bfloat16,
                     init: str = "ones") -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, init)


def shard_tensor(t: torch.Tensor, axis: int,
                 parts: Optional[Tuple[int, ...]], tp: int,
                 rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``axis``, in a storage of its
    own (the full tensor can go): each of ``parts`` (when they tile the
    axis) cut into ``tp`` chunks, or the whole axis. An axis of extent 1
    (a per-channel scale across the contraction) is replicated."""
    n = t.shape[axis]
    if tp == 1 or n == 1:
        return t
    sizes = parts if parts is not None and sum(parts) == n else (n,)
    pieces, off = [], 0
    for p in sizes:
        if p % tp:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} (part of "
                             f"{p}) does not split over tp={tp}")
        c = p // tp
        pieces.append(t.narrow(axis, off + rank * c, c))
        off += p
    out = torch.cat(pieces, dim=axis) if len(pieces) > 1 else pieces[0]
    return out.clone(memory_format=torch.contiguous_format)


def row_parallel_output(x: torch.Tensor, w, mesh, *,
                        collective_dtype: Optional[str] = None,
                        collective_block: int = 32) -> torch.Tensor:
    """A row-parallel layer's output summed over ``mesh``'s group: ``x``
    (…, K / tp) the rank's slice of the contraction, ``w`` its rows. With
    ``collective_dtype`` None the plain all-reduce; "int8" / "fp8" the
    quantized ring (``parallel/collectives``). A low-rank leaf-group
    reduces its rank-r intermediate (x @ U) instead: its V half is
    replicated, so the product after it needs no collective."""
    from ..modules.quantization import qlinear
    from . import collectives
    if isinstance(w, dict) and "lr_u" in w:
        t = collectives.all_reduce(qlinear(x, w["lr_u"]), mesh)
        return qlinear(t, w["lr_v"])
    if collective_dtype is None:
        return collectives.all_reduce(qlinear(x, w), mesh)
    return collectives.quantized_row_parallel(
        x, w, mesh, dtype=collective_dtype, block=collective_block)


@dataclass(frozen=True)
class GQASharding:
    """Resolved GQA head layout for a tp degree (see the counterpart's
    docstring): padded KV slot s holds original KV head s // kv_replication;
    original Q head i lives at padded slot ``q_slot_map[i]``."""

    num_q_heads: int
    num_kv_heads: int
    orig_q_heads: int
    orig_kv_heads: int
    kv_replication: int
    tp: int

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def q_slot_map(self) -> Tuple[int, ...]:
        orig_qpk = self.orig_q_heads // self.orig_kv_heads
        rep, g = self.kv_replication, self.q_per_kv
        out = []
        for i in range(self.orig_q_heads):
            j, o = divmod(i, orig_qpk)
            out.append(j * rep * g + o)
        return tuple(out)

    @property
    def is_identity(self) -> bool:
        return (self.num_q_heads == self.orig_q_heads
                and self.num_kv_heads == self.orig_kv_heads)


def resolve_gqa_sharding(num_q_heads: int, num_kv_heads: int,
                         tp: int) -> GQASharding:
    """Padded/replicated head layout so kv heads divide tp."""
    if num_q_heads % num_kv_heads != 0:
        raise ValueError(f"num_q_heads {num_q_heads} must be a multiple of "
                         f"num_kv_heads {num_kv_heads}")
    orig_qpk = num_q_heads // num_kv_heads
    if num_kv_heads % tp == 0:
        rep = 1
        padded_kv = num_kv_heads
        g = orig_qpk
    elif tp % num_kv_heads == 0:
        rep = tp // num_kv_heads
        padded_kv = tp
        g = max(1, -(-orig_qpk // rep))
    else:
        raise ValueError(f"unsupported head/tp combination: "
                         f"kv={num_kv_heads} tp={tp}")
    return GQASharding(padded_kv * g, padded_kv, num_q_heads, num_kv_heads,
                       rep, tp)


def _to_heads(w: np.ndarray, n_heads: int, head_dim: int, axis: int):
    shape = list(w.shape)
    axis = axis % w.ndim
    if shape[axis] != n_heads * head_dim:
        raise ValueError(f"axis {axis} of {tuple(w.shape)} is not "
                         f"{n_heads} heads x {head_dim}")
    shape[axis] = n_heads
    shape.insert(axis + 1, head_dim)
    return w.reshape(shape), axis


def _from_heads(w: np.ndarray, axis: int):
    shape = list(w.shape)
    shape[axis] = shape[axis] * shape[axis + 1]
    shape.pop(axis + 1)
    return w.reshape(shape)


def replicate_kv_weight(w: np.ndarray, sharding: GQASharding, head_dim: int,
                        axis: int = -1) -> np.ndarray:
    """Expand a K or V projection weight (..., orig_kv*dh) to the
    replicated layout (..., num_kv*dh)."""
    if sharding.is_identity:
        return w
    w, axis = _to_heads(w, sharding.orig_kv_heads, head_dim, axis)
    w = np.repeat(w, sharding.kv_replication, axis=axis)
    return _from_heads(w, axis)


def place_q_weight(w: np.ndarray, sharding: GQASharding, head_dim: int,
                   axis: int = -1) -> np.ndarray:
    """Scatter original Q heads into their padded slots (zero elsewhere)."""
    if sharding.is_identity:
        return w
    w, axis = _to_heads(w, sharding.orig_q_heads, head_dim, axis)
    out_shape = list(w.shape)
    out_shape[axis] = sharding.num_q_heads
    out = np.zeros(out_shape, dtype=w.dtype)
    idx = [slice(None)] * w.ndim
    src = [slice(None)] * w.ndim
    for i, s in enumerate(sharding.q_slot_map):
        idx[axis] = s
        src[axis] = i
        out[tuple(idx)] = w[tuple(src)]
    return _from_heads(out, axis)
