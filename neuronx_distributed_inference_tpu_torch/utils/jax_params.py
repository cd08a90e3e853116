"""Carry a parameter tree of the JAX package into the port (no counterpart).

``params_from_numpy(tree)`` takes the JAX application's parameter tree as
numpy arrays — ``jax.tree.map(np.asarray, app.params)`` — and returns the
port's parameter dict, so both packages compute with the same weights. The
port keeps the JAX tree's layout (stacked ``(L, …)`` layer leaves, fused
``qkv_proj`` and ``qkv_bias``, padded vocabulary), so the conversion is
leaf by leaf, every leaf of the tree included (biases, fp32 sinks,
routers, ALiBi slopes and xIELU rows, expert biases, position tables) in
its own dtype; bf16 and fp8 leaves (numpy's
``ml_dtypes`` types) are reinterpreted bit for bit.
This module imports neither jax nor the JAX package."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name in _BITCAST:
        raw, dt = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(raw).copy()).view(dt).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(np.asarray(node), dev)
    return conv(tree)
