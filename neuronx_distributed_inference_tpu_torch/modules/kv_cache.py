"""KV quantisation helpers (counterpart:
``neuronx_distributed_inference_tpu/modules/kv_cache.py:183-197``). The
contiguous-cache layout of that module waits for the contiguous app."""

from __future__ import annotations

from typing import Optional

import torch


def quantize_kv(x: torch.Tensor, dtype: torch.dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """KV quantisation on write: direct cast (scale None or 1.0) or scaled
    mode — store x / scale (in fp32) so the fp8 range covers the values."""
    if scale is not None and scale != 1.0:
        x = x.float() / scale
    return x.to(dtype)


def dequantize_kv(x: torch.Tensor, dtype: torch.dtype,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` on read."""
    if scale is not None and scale != 1.0:
        return (x.float() * scale).to(dtype)
    return x.to(dtype)
