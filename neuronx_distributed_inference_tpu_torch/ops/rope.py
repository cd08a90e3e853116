"""Rotary position embeddings (counterpart:
``neuronx_distributed_inference_tpu/ops/rope.py:27-215``), with the
half (rotate_half) and the interleaved pairing of :func:`apply_rope`.

cos/sin are computed from the position ids in fp32. The port carries the
default (unscaled), linear, llama3, yarn and longrope frequency schemes —
Llama-3.x uses llama3, GPT-OSS and DeepSeek yarn, whose attention factor
scales cos and sin (``_yarn_inv_freq`` :72-92, ``yarn_attention_factor``
:56-69, ``rope_cos_sin`` :174-176), Phi-3 longrope, one rescale factor per
frequency slot with its own attention factor (:120-125, :177-184). M-RoPE
waits for the families that need it; :func:`compute_inv_freq` refuses it
by name."""

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
    # None | "linear" | "llama3" | "yarn" | "longrope"
    scaling_type: Optional[str] = None
    scaling_factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    # yarn (gpt-oss, deepseek; HF _compute_yarn_parameters semantics)
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    # cos/sin multiplier; None = derived from the factor and mscales
    attention_factor: Optional[float] = None
    truncate: bool = True
    # longrope (phi-3): one rescale factor per frequency slot; the long
    # list applies when the deployed ``max_position`` exceeds
    # ``original_max_position``
    short_factor: Optional[Tuple[float, ...]] = None
    long_factor: Optional[Tuple[float, ...]] = None
    max_position: int = 0

    @property
    def dim(self) -> int:
        return self.rotary_dim or self.head_dim


SUPPORTED_SCALING = (None, "default", "linear", "llama3", "yarn",
                     "longrope")


def _pos_freqs(cfg: RopeConfig) -> torch.Tensor:
    """theta ** (2i / dim) in fp32. The power is taken in fp64 and rounded
    once, which gives XLA's fp32 ``pow`` bit for bit; torch's fp32 ``pow``
    is an ulp off for some thetas (150000 at dim 64), which moves cos/sin
    by ~1e-3 at position 1e5."""
    d = cfg.dim
    x = torch.arange(0, d, 2, dtype=torch.float32) / d
    return (cfg.rope_theta ** x.double()).float()


def _base_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    return 1.0 / _pos_freqs(cfg)


def yarn_attention_factor(cfg: RopeConfig) -> float:
    """The YaRN attention temperature that multiplies cos and sin."""
    if cfg.attention_factor is not None:
        return float(cfg.attention_factor)

    def get_mscale(scale: float, m: float = 1.0) -> float:
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    if cfg.mscale and cfg.mscale_all_dim:
        return get_mscale(cfg.scaling_factor, cfg.mscale) / get_mscale(
            cfg.scaling_factor, cfg.mscale_all_dim)
    return get_mscale(cfg.scaling_factor)


def _yarn_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    """Interpolated frequencies below the ``beta_slow`` rotation count,
    extrapolated ones above ``beta_fast``, a linear ramp between (bounds
    rounded outward when ``truncate``)."""
    d = cfg.dim
    pos_freqs = _pos_freqs(cfg)
    inv_extrap = 1.0 / pos_freqs
    inv_interp = 1.0 / (cfg.scaling_factor * pos_freqs)

    def corr_dim(n_rot: float) -> float:
        return (d * math.log(cfg.original_max_position
                             / (n_rot * 2 * math.pi))
                ) / (2 * math.log(cfg.rope_theta))

    low, high = corr_dim(cfg.beta_fast), corr_dim(cfg.beta_slow)
    if cfg.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extrap_factor = 1.0 - ramp
    return inv_interp * (1 - extrap_factor) + inv_extrap * extrap_factor


def compute_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    """(dim/2,) fp32 inverse frequencies, on the CPU."""
    if cfg.scaling_type not in SUPPORTED_SCALING:
        raise NotImplementedError(
            f"rope scaling type {cfg.scaling_type!r} is not ported yet "
            f"(supported: {SUPPORTED_SCALING})")
    if cfg.scaling_type == "yarn":
        return _yarn_inv_freq(cfg)
    if cfg.scaling_type == "longrope":
        use_long = (cfg.max_position > cfg.original_max_position
                    and cfg.long_factor is not None)
        ext = torch.tensor(cfg.long_factor if use_long else cfg.short_factor,
                           dtype=torch.float32)
        return _base_inv_freq(cfg) / ext
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


def longrope_attention_factor(cfg: RopeConfig) -> float:
    """The longrope cos/sin multiplier: ``attention_factor``, else
    sqrt(1 + ln(f) / ln(original)) with f = max / original positions (1
    when f <= 1)."""
    if cfg.attention_factor is not None:
        return float(cfg.attention_factor)
    factor = max(cfg.max_position / cfg.original_max_position, 1.0)
    if factor <= 1.0:
        return 1.0
    return math.sqrt(1.0 + math.log(factor)
                     / math.log(cfg.original_max_position))


def rope_cos_sin(position_ids: torch.Tensor, cfg: RopeConfig,
                 inv_freq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) int positions -> cos/sin of shape (B, S, dim/2), fp32, on the
    positions' device. ``inv_freq`` may be passed precomputed (on that
    device) to skip the host-side table build."""
    if inv_freq is None:
        inv_freq = compute_inv_freq(cfg).to(position_ids.device)
    angles = position_ids.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if cfg.scaling_type == "yarn":
        f = yarn_attention_factor(cfg)
        cos, sin = cos * f, sin * f
    elif cfg.scaling_type == "longrope":
        f = longrope_attention_factor(cfg)
        cos, sin = cos * f, sin * f
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, d/2), d = rotary dim (may be < D).
    HF "half" convention (rotate_half) by default; ``interleaved`` pairs
    x[..., 0::2] with x[..., 1::2] and re-interleaves the result (the
    GPT-NeoX pairing DeepSeek's ``rope_interleave`` selects; the layout
    stays interleaved, as the counterpart keeps it, :188-215). Computed in
    fp32."""
    d2 = cos.shape[-1]
    d = 2 * d2
    x_rot, x_pass = x[..., :d], x[..., d:]
    xf = x_rot.float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    else:
        x1, x2 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    out = out.to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
