"""Low-rank (SVD) MLP factors (counterpart:
``neuronx_distributed_inference_tpu/modules/low_rank.py`` —
``DEFAULT_LOW_RANK_MODULES`` :48, ``LowRankSpec`` :52,
``low_rank_spec_from_config`` :64, ``is_low_rank_leaf`` :72,
``factorize_tensor`` :81, ``_quantize_factor`` :97, ``factorize_params``
:113, ``reconstruction_error`` :152, ``compression_report`` :162).

A factorized weight (..., K, N) is the leaf-group ``{"lr_u": (..., K, r),
"lr_v": (..., r, N)}``, the best rank-r pair (Eckart-Young) with the
square root of each singular value on both factors, so their ranges stay
balanced for factor quantization. :func:`~.quantization.qlinear` runs it
as two skinny products. Factorizing runs before quantizing (the SVD needs
the fp weight) and quantizes the factors itself.

The SVD is ``torch.linalg.svd`` on the weight's device, in fp64 (the
reference's is numpy's fp32); singular vectors may differ in sign from
numpy's, so U·V (and everything computed from it) is what agrees with the
reference, not the factors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .quantization import (BLOCKWISE, MXFP4, PER_CHANNEL, QuantSpec,
                           dequantize, is_quantized_leaf, quantize_tensor)

# the MLP projections only (attention projections are small next to the
# MLP and rank-sensitive)
DEFAULT_LOW_RANK_MODULES = ("gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class LowRankSpec:
    """``rank``: the factors' rank r; ``modules``: the weight names to
    factorize."""

    rank: int
    modules: Tuple[str, ...] = DEFAULT_LOW_RANK_MODULES

    def converts(self, name: str) -> bool:
        return name in self.modules


def low_rank_spec_from_config(tpu_config) -> Optional[LowRankSpec]:
    """The LowRankSpec of the ``mlp_low_rank`` knob, None when unset."""
    rank = getattr(tpu_config, "mlp_low_rank", None)
    if not rank:
        return None
    return LowRankSpec(rank=int(rank))


def is_low_rank_leaf(w: Any) -> bool:
    return isinstance(w, dict) and "lr_u" in w


def factorize_tensor(w: torch.Tensor, rank: int) -> Dict[str, torch.Tensor]:
    """The best rank-``rank`` pair of a weight (..., K, N) (leading axes
    batch through the SVD), in the weight's dtype. The SVD runs in fp64:
    cuSOLVER's default fp32 SVD on the card rebuilt a 2048 x 8192 weight
    at full rank well short of fp32 accuracy (a 4-layer Llama-3.2-1B's
    logits moved by 1.5e-3 relative RMS), where numpy's fp32 LAPACK SVD
    is accurate to ~3e-6."""
    dt = w.dtype
    r = min(int(rank), w.shape[-2], w.shape[-1])
    u, s, vh = torch.linalg.svd(w.double(), full_matrices=False)
    root = torch.sqrt(s[..., :r])
    return {"lr_u": (u[..., :, :r] * root[..., None, :]).to(dt),
            "lr_v": (root[..., :, None] * vh[..., :r, :]).to(dt)}


def _quantize_factor(factor: torch.Tensor, qspec: QuantSpec) -> Any:
    """Quantize one factor; where the rank-r contraction axis cannot hold
    the scheme's groups, blockwise becomes per-channel and mxfp4 leaves
    the factor in full precision (the reference's rule)."""
    k = factor.shape[-2]
    if qspec.dtype == MXFP4:
        if k % qspec.group_size:
            return factor
        return quantize_tensor(factor, qspec)
    if qspec.scheme == BLOCKWISE and k % qspec.group_size:
        qspec = dataclasses.replace(qspec, scheme=PER_CHANNEL)
    return quantize_tensor(factor, qspec)


def factorize_params(params: Dict[str, Any], spec: LowRankSpec,
                     quant: Optional[QuantSpec] = None) -> Dict[str, Any]:
    """Replace every weight ``spec`` converts with its factor pair; when
    ``quant`` converts the weight too, each factor is quantized. Run
    before :func:`~.quantization.quantize_params` (a factor pair holds no
    convertible name, so that walk leaves it alone)."""

    def convert(tree):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict) and not is_low_rank_leaf(v) \
                    and not is_quantized_leaf(v):
                out[name] = convert(v)
            elif spec.converts(name) and not isinstance(v, dict):
                leaf = factorize_tensor(v, spec.rank)
                if quant is not None and quant.converts(name):
                    leaf = {k: _quantize_factor(f, quant)
                            for k, f in leaf.items()}
                out[name] = leaf
            else:
                out[name] = v
        return out

    return convert(params)


def _factor_dense(factor: Any) -> torch.Tensor:
    if is_quantized_leaf(factor):
        return dequantize(factor, torch.float32)
    return factor.float()


def reconstruction_error(w: torch.Tensor, leaf: Dict[str, Any]) -> float:
    """Relative Frobenius error ||W - U·V|| / ||W|| of one factor pair
    (possibly quantized) against the dense weight."""
    wf = w.float()
    approx = _factor_dense(leaf["lr_u"]) @ _factor_dense(leaf["lr_v"])
    denom = float(torch.linalg.norm(wf))
    return float(torch.linalg.norm(wf - approx)) / max(denom, 1e-30)


def compression_report(hidden_size: int, intermediate_size: int,
                       num_layers: int, rank: int, glu: bool = True,
                       bytes_per_param: float = 4.0) -> Dict[str, Any]:
    """Analytic bytes and operations per decoded token of the dense MLP
    (L · n_proj · H · I weights) against the factor pairs (L · n_proj ·
    r · (H + I)); operations are two per weight."""
    h, i, r = hidden_size, intermediate_size, int(rank)
    n_proj = 3 if glu else 2
    dense_params = num_layers * n_proj * h * i
    lr_params = num_layers * n_proj * r * (h + i)
    ratio = lr_params / dense_params
    return {
        "rank": r,
        "mlp_projections": num_layers * n_proj,
        "dense_mlp_bytes": int(dense_params * bytes_per_param),
        "low_rank_mlp_bytes": int(lr_params * bytes_per_param),
        "dense_mlp_flops_per_token": 2 * dense_params,
        "low_rank_mlp_flops_per_token": 2 * lr_params,
        "bytes_ratio": round(ratio, 4),
        "flops_ratio": round(ratio, 4),
        "projected_decode_mlp_speedup": round(1.0 / max(ratio, 1e-9), 2),
    }
