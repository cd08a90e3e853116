"""Checkpoint reading (counterpart:
``neuronx_distributed_inference_tpu/utils/checkpoint.py:26-90``): HF
safetensors checkpoints, single or sharded through the index json, into a
host dict of numpy arrays; bf16 and fp8 tensors come back as float32
(numpy has no such dtypes) and are cast to the model dtype on placement."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

SAFETENSORS_INDEX = "model.safetensors.index.json"


def load_state_dict(model_path: str) -> Dict[str, np.ndarray]:
    if os.path.isfile(model_path):
        return _load_one(model_path)
    idx = os.path.join(model_path, SAFETENSORS_INDEX)
    if os.path.exists(idx):
        with open(idx) as f:
            index = json.load(f)
        out: Dict[str, np.ndarray] = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(_load_one(os.path.join(model_path, shard)))
        return out
    st = os.path.join(model_path, "model.safetensors")
    if os.path.exists(st):
        return _load_one(st)
    raise FileNotFoundError(f"no safetensors checkpoint under {model_path}")


def _load_one(path: str) -> Dict[str, np.ndarray]:
    import torch
    from safetensors import safe_open
    if not path.endswith(".safetensors"):
        raise ValueError(f"{path}: only safetensors checkpoints are read")
    out = {}
    with safe_open(path, framework="pt") as f:
        for k in f.keys():
            t = f.get_tensor(k)
            if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                           torch.float8_e5m2, torch.float16):
                t = t.float()
            out[k] = t.numpy()
    return out
