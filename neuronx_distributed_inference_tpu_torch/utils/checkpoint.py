"""Checkpoint reading and writing (counterpart:
``neuronx_distributed_inference_tpu/utils/checkpoint.py`` —
``load_state_dict`` :26-90, ``save_state_dict_safetensors`` :90-116,
``device_put_params`` :118).

HF safetensors checkpoints, single or sharded through the index json,
load into a host dict of numpy arrays; bf16 and fp8 tensors come back as
float32 (numpy has no such dtypes) and are cast to the model dtype on
placement. ``keep_dtypes=True`` returns the stored torch tensors instead,
so a quantized checkpoint keeps its int8, uint8, ``float8_e4m3fn`` codes
and fp32 scales (an fp8 code read as float32 would look like an int8 leaf
to ``quantization._leaf_scheme``). ``skip`` names tensors not to read:
each stands as zeros of its shape (an expert another rank holds)."""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Optional

import numpy as np

SAFETENSORS_INDEX = "model.safetensors.index.json"


def load_state_dict(model_path: str, keep_dtypes: bool = False,
                    skip: Optional[Callable[[str], bool]] = None
                    ) -> Dict[str, Any]:
    if os.path.isfile(model_path):
        return _load_one(model_path, keep_dtypes, skip)
    idx = os.path.join(model_path, SAFETENSORS_INDEX)
    if os.path.exists(idx):
        with open(idx) as f:
            index = json.load(f)
        out: Dict[str, Any] = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(_load_one(os.path.join(model_path, shard),
                                 keep_dtypes, skip))
        return out
    st = os.path.join(model_path, "model.safetensors")
    if os.path.exists(st):
        return _load_one(st, keep_dtypes, skip)
    raise FileNotFoundError(f"no safetensors checkpoint under {model_path}")


def _load_one(path: str, keep_dtypes: bool = False,
              skip: Optional[Callable[[str], bool]] = None
              ) -> Dict[str, Any]:
    import torch
    from safetensors import safe_open
    if not path.endswith(".safetensors"):
        raise ValueError(f"{path}: only safetensors checkpoints are read")
    out = {}
    with safe_open(path, framework="pt") as f:
        for k in f.keys():
            if skip is not None and skip(k):
                out[k] = np.broadcast_to(np.zeros((), np.float32),
                                         f.get_slice(k).get_shape())
                continue
            t = f.get_tensor(k)
            if keep_dtypes:
                out[k] = t
                continue
            if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                           torch.float8_e5m2, torch.float16):
                t = t.float()
            out[k] = t.numpy()
    return out


def save_state_dict_safetensors(state_dict: Dict[str, Any], path: str,
                                max_shard_bytes: int = 5 * 2**30) -> None:
    """Save {name: tensor or numpy array} under directory ``path`` as
    ``model.safetensors``, or as shards of at most ``max_shard_bytes`` with
    the index json (reference :90-116). Tensors are written in their own
    dtypes (bf16 and fp8 included) from host copies."""
    import torch
    from safetensors.torch import save_file

    from .jax_params import tensor_from_numpy
    os.makedirs(path, exist_ok=True)
    shards, cur, cur_bytes = [], {}, 0
    for k, v in state_dict.items():
        t = (v if isinstance(v, torch.Tensor)
             else tensor_from_numpy(np.asarray(v), torch.device("cpu")))
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        if cur and cur_bytes + nbytes > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = t
        cur_bytes += nbytes
    shards.append(cur)
    if len(shards) == 1:
        save_file(shards[0], os.path.join(path, "model.safetensors"))
        return
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(path, name))
        for k in shard:
            weight_map[k] = name
    with open(os.path.join(path, SAFETENSORS_INDEX), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def expert_skip(num_experts: int, mesh) -> Optional[Callable[[str],
                                                               bool]]:
    """The checkpoint tensors a rank of ``mesh`` does not read: those of
    an ``experts.{e}.`` outside its expert slice ``[ep_rank·E/ep,
    (ep_rank + 1)·E/ep)``. None when the rank holds every expert."""
    if mesh is None or mesh.ep == 1:
        return None
    n = num_experts // mesh.ep
    lo = mesh.ep_rank * n
    pat = re.compile(r"\.experts\.(\d+)\.")

    def skip(name: str) -> bool:
        m = pat.search(name)
        return m is not None and not lo <= int(m.group(1)) < lo + n
    return skip


def _host_tensor(a):
    """A host numpy array as a CPU tensor, without a copy where torch can
    view it."""
    import torch

    from .jax_params import _BITCAST, tensor_from_numpy
    a = np.asarray(a)
    if a.dtype.name in _BITCAST or 0 in a.strides or not a.flags.writeable:
        return tensor_from_numpy(a, torch.device("cpu"))
    return torch.from_numpy(np.ascontiguousarray(a))


def device_put_params(host: Dict[str, Any], spec, device, mesh=None
                      ) -> Dict[str, Any]:
    """A converted host tree (fused q/k/v, laid out for the full ``spec``)
    onto ``device``, leaf by leaf: cast to its ``ParamSpec`` dtype (the
    model dtype, fp32 for an MoE router), factorized and quantized as the
    spec asks (``model_base.convert_leaf``), and over a ``mesh`` cut to
    the rank's slice (``model_base.rank_leaves``). The cuts are made on
    the host where conversion allows: every cut of a leaf that is not
    converted, and the expert cut of one that is (quantization is per
    expert), so the card holds the rank's slices and at most one
    converted leaf of the rank's experts beside them; a rank never holds
    another rank's experts. Quantized leaf-groups keep their own
    dtypes."""
    from ..models.model_base import (convert_leaf, decoder_param_specs,
                                     rank_leaves)
    from ..modules.quantization import shard_leaf
    from ..parallel.layers import EP, ParamSpec, resolve_cuts

    def converted(name):
        return ((spec.quant is not None and spec.quant.converts(name))
                or (spec.low_rank is not None
                    and spec.low_rank.converts(name)))

    def put_leaf(node, ps, name):
        dt = getattr(ps, "dtype", spec.dtype)
        cuts = ps.cuts if isinstance(ps, ParamSpec) else ()
        parts = ps.parts if isinstance(ps, ParamSpec) else None
        t = _host_tensor(node)
        if mesh is None:
            return {name: convert_leaf(spec, name, t.to(device).to(dt))}
        if not converted(name):
            return {k: v.to(device).to(dt) for k, v in rank_leaves(
                spec, name, ps, t, mesh).items()}
        t = shard_leaf(t, resolve_cuts([c for c in cuts if c[1] == EP],
                                       None, mesh))
        leaf = convert_leaf(spec, name, t.to(device).to(dt))
        return rank_leaves(spec, name, ps, leaf, mesh, cuts=resolve_cuts(
            [c for c in cuts if c[1] != EP], parts, mesh))

    def put(node, ps):
        out: Dict[str, Any] = {}
        for k, v in node.items():
            sub = (ps or {}).get(k)
            if isinstance(v, dict):
                out[k] = put(v, sub)
            else:
                out.update(put_leaf(v, sub, k))
        return out
    return put(host, decoder_param_specs(spec))
