"""RMSNorm and LayerNorm (counterpart: ``neuronx_distributed_inference_tpu/
ops/normalization.py`` — ``rms_norm`` :13, ``layer_norm`` :24). Computed in
fp32 and cast back to the input dtype, as the JAX ops do."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm. ``offset`` = 1.0 gives the (1+w) Gemma variant."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * (weight.float() + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis (DBRX's has no bias): fp32 mean and
    (biased) variance, then the weight and the optional bias, then the
    cast."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
