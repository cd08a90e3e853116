"""RMSNorm (counterpart: ``neuronx_distributed_inference_tpu/ops/
normalization.py:13``). Computed in fp32 and cast back to the input dtype,
as the JAX op does."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm. ``offset`` = 1.0 gives the (1+w) Gemma variant."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * (weight.float() + offset)).to(x.dtype)
