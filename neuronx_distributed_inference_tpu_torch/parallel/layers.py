"""Parameter declarations and GQA head layout (counterpart:
``neuronx_distributed_inference_tpu/parallel/layers.py`` — ``ParamSpec``
:34, ``GQASharding`` / ``resolve_gqa_sharding`` :127-196 and the host-side
head placement helpers after them).

The port runs on one card (tp = 1), where the head layout is the
identity; the math is kept because the parameter layout, and so the
conversion of checkpoints and of the JAX package's parameter trees,
depends on it. A ``ParamSpec`` here has no sharding."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + random-init rule of one weight tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"   # "normal" | "zeros" | "ones"

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
