"""Multi-LoRA serving: stacked per-row adapters (counterpart:
``neuronx_distributed_inference_tpu/modules/lora.py`` — ``LoraSpec`` :36,
``lora_spec_from_config`` :48, ``lora_delta`` :58, ``apply_lora`` :69,
``load_peft_adapter`` :84, ``adapter_layer_arrays`` :98,
``set_adapter_slot`` :140).

Every targeted projection carries stacked adapter weights

    lora_A_<mod>: (L, max_loras, in, r)
    lora_B_<mod>: (L, max_loras, r, out)

and the per-row ``adapter_ids`` (B,) gather each row's factors inside the
step, so one dispatch mixes rows of different adapters. ``lora_alpha / r``
is folded into B at load time; slot 0 is the zero adapter (B = 0: the base
model, exactly). The delta is a gather and two batched products in fp32,
as the reference's (an XLA graph there, plain torch ops here: the
reference has no kernel for it).

An adapter swap writes a slot of the stacked tensors IN PLACE
(:func:`set_adapter_slot`): a captured CUDA graph holds the tensors'
addresses, so rebinding a leaf would leave every later replay serving the
old factors (the reference rebinds a fresh array, ``.at[:, slot].set``).
This module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DEFAULT_TARGET_MODULES = ("q_proj", "v_proj")


@dataclass(frozen=True)
class LoraSpec:
    """Static LoRA serving geometry."""

    max_loras: int = 1
    rank: int = 16
    target_modules: Tuple[str, ...] = DEFAULT_TARGET_MODULES

    def targets(self, name: str) -> bool:
        return name in self.target_modules


def lora_spec_from_config(tpu_config) -> Optional[LoraSpec]:
    lc = getattr(tpu_config, "lora_config", None)
    if lc is None:
        return None
    return LoraSpec(
        max_loras=lc.max_loras,
        rank=lc.max_lora_rank,
        target_modules=tuple(lc.target_modules or DEFAULT_TARGET_MODULES),
    )


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-row adapter delta: x (B, T, in); a (max_loras, in, r); b
    (max_loras, r, out) with the scale folded in; adapter_ids (B,). Each
    row gathers its factors, the products run in fp32, the delta is cast
    to ``x.dtype`` (reference :58-66)."""
    ids = adapter_ids.long()
    a_sel = a[ids].float()                              # (B, in, r)
    b_sel = b[ids].float()                              # (B, r, out)
    d = torch.bmm(torch.bmm(x.float(), a_sel), b_sel)   # (B, T, out)
    return d.to(x.dtype)


def apply_lora(spec_lora: Optional[LoraSpec], layer_w: Dict[str, Any],
               name: str, x: torch.Tensor, y: torch.Tensor,
               adapter_ids) -> torch.Tensor:
    """y = base(x) plus this module's adapter delta when serving LoRA."""
    if (spec_lora is None or adapter_ids is None
            or not spec_lora.targets(name)):
        return y
    return y + lora_delta(x, layer_w[f"lora_A_{name}"],
                          layer_w[f"lora_B_{name}"], adapter_ids)


# ---------------------------------------------------------------------------
# PEFT checkpoints
# ---------------------------------------------------------------------------

def load_peft_adapter(path: str) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, Any]]:
    """A PEFT adapter directory (``adapter_config.json`` +
    ``adapter_model.safetensors``) -> (state dict of fp32 numpy arrays,
    config). The reference also reads ``adapter_model.bin`` through torch
    pickles; the port reads safetensors only, as its checkpoints do."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    from ..utils.checkpoint import _load_one
    p = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(p):
        return _load_one(p), cfg
    raise FileNotFoundError(f"no adapter_model.safetensors under {path}")


def adapter_layer_arrays(sd: Dict[str, np.ndarray], cfg: Dict[str, Any],
                         num_layers: int, module: str, in_dim: int,
                         out_dim: int, max_rank: int, out_transform=None,
                         in_transform=None) -> Tuple[np.ndarray, np.ndarray]:
    """One module's A / B stacked over the layers from a PEFT state dict:
    rank zero-padded to ``max_rank`` (padded rank columns add nothing),
    alpha / r folded into B, and the head transforms of the base weights
    applied to B's out axis (``out_transform``) and A's in axis
    (``in_transform``). Returns A (L, in, max_rank), B (L, max_rank,
    out)."""
    r = int(cfg.get("r", max_rank))
    alpha = float(cfg.get("lora_alpha", r))
    scale = alpha / r
    a_out = np.zeros((num_layers, in_dim, max_rank), np.float32)
    b_out = np.zeros((num_layers, max_rank, out_dim), np.float32)
    found = False
    for i in range(num_layers):
        cand_a = [k for k in sd if f"layers.{i}." in k and module in k
                  and "lora_A" in k]
        cand_b = [k for k in sd if f"layers.{i}." in k and module in k
                  and "lora_B" in k]
        if not cand_a:
            continue
        found = True
        a = np.asarray(sd[cand_a[0]], np.float32)     # torch layout (r, in)
        b = np.asarray(sd[cand_b[0]], np.float32)     # (out, r)
        at = np.ascontiguousarray(a.T)                # (in, r)
        bt = np.ascontiguousarray(b.T) * scale        # (r, out)
        if in_transform is not None:
            at = in_transform(at)
        if out_transform is not None:
            bt = out_transform(bt)
        a_out[i, :at.shape[0], :at.shape[1]] = at
        b_out[i, :bt.shape[0], :bt.shape[1]] = bt
    if not found:
        raise KeyError(f"adapter has no weights for module {module!r}")
    return a_out, b_out


def set_adapter_slot(params: Dict[str, Any], layers_key: str, slot: int,
                     module: str, a, b) -> None:
    """Write adapter factors ``a`` (L, in, r) and ``b`` (L, r, out) into
    ``slot`` of the stacked tensors of ``params[layers_key]``, in place:
    the tensors keep their storage, so a captured graph that reads them
    serves the new factors at its next replay."""
    lw = params[layers_key]
    for key, x in ((f"lora_A_{module}", a), (f"lora_B_{module}", b)):
        leaf = lw[key]
        leaf[:, slot].copy_(torch.as_tensor(x).to(device=leaf.device,
                                                  dtype=leaf.dtype))
