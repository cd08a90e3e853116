"""Rotary position embeddings (counterpart:
``neuronx_distributed_inference_tpu/ops/rope.py:27-215``).

cos/sin are computed from the position ids in fp32. This slice carries the
default (unscaled), linear and llama3 frequency schemes — Llama-3.2-1B uses
llama3. yarn, longrope and M-RoPE wait for the families that need them;
:func:`compute_inv_freq` refuses them by name."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    rope_theta: float = 10000.0
    rotary_dim: Optional[int] = None
    scaling_type: Optional[str] = None   # None | "linear" | "llama3"
    scaling_factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192

    @property
    def dim(self) -> int:
        return self.rotary_dim or self.head_dim


SUPPORTED_SCALING = (None, "default", "linear", "llama3")


def _base_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    d = cfg.dim
    return 1.0 / (cfg.rope_theta
                  ** (torch.arange(0, d, 2, dtype=torch.float32) / d))


def compute_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    """(dim/2,) fp32 inverse frequencies, on the CPU."""
    if cfg.scaling_type not in SUPPORTED_SCALING:
        raise NotImplementedError(
            f"rope scaling type {cfg.scaling_type!r} is not ported yet "
            f"(supported: {SUPPORTED_SCALING})")
    inv_freq = _base_inv_freq(cfg)
    if cfg.scaling_type == "linear":
        inv_freq = inv_freq / cfg.scaling_factor
    elif cfg.scaling_type == "llama3":
        low_wavelen = cfg.original_max_position / cfg.low_freq_factor
        high_wavelen = cfg.original_max_position / cfg.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / cfg.scaling_factor
        smooth = (cfg.original_max_position / wavelen
                  - cfg.low_freq_factor) / (cfg.high_freq_factor
                                            - cfg.low_freq_factor)
        mid = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen < high_wavelen, inv_freq,
                               torch.where(wavelen > low_wavelen, scaled,
                                           mid))
    return inv_freq


def rope_cos_sin(position_ids: torch.Tensor, cfg: RopeConfig,
                 inv_freq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> cos/sin of shape (B, S, dim/2), fp32, on the
    positions' device. ``inv_freq`` may be passed precomputed (on that
    device) to skip the host-side table build."""
    if inv_freq is None:
        inv_freq = compute_inv_freq(cfg).to(position_ids.device)
    angles = position_ids.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, d/2), d = rotary dim (may be < D).
    HF "half" convention (rotate_half), computed in fp32."""
    d2 = cos.shape[-1]
    d = 2 * d2
    x_rot, x_pass = x[..., :d], x[..., d:]
    xf = x_rot.float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
