"""Weight-only quantization (counterpart:
``neuronx_distributed_inference_tpu/modules/quantization.py`` — the
constants and ``DEFAULT_QUANT_MODULES`` :40-66, ``QuantSpec`` :69,
``quant_spec_from_config`` :88, ``is_quantized_leaf`` / ``_absmax_scale``
/ ``quantize_tensor`` :101-152, ``quantize_mxfp4`` :155, ``_leaf_scheme``
:180, ``quantize_params`` :191, ``dequant_oai_mxfp4_blocks`` :209,
``dequantize`` :232, ``qlinear`` :258, ``qeinsum`` :286, the mesh
shardings of quantized and low-rank trees ``_qleaf_shardings`` :312,
``_low_rank_leaf_shardings`` :328, ``quantized_shardings`` :352, here
:func:`shard_leaf`, one rank's cuts).

A quantized weight is a dict leaf-group

    {"qweight": int8 / float8_e4m3fn / uint8 (two fp4 codes a byte),
     "scale": fp32}

made by :func:`quantize_params` (or loaded from a quantized checkpoint)
and read by :func:`qlinear`, :func:`qmatmul` and :func:`qeinsum`. The
contraction axis is the weight's second-to-last; leading axes (the layer
stack, the experts) are never reduced, so a per-tensor scale is one per
(layer, expert) matrix and :func:`quantize_tensor` may run one leading
slice at a time (bounding the temporaries of a 19-billion-value expert
stack on the card) with the same result.

The quantizers take torch tensors and run on the tensor's device; on the
CPU they give the reference's numpy output bit for bit: ``torch.round``
rounds half to even as ``np.round`` does, the fp8 cast rounds to nearest
even in both, an fp4 value tie goes to the smaller magnitude (the
reference's first ``argmin``), a negative value that rounds to 0 keeps
code 8 (-0.0), and the MXFP4 exponent ``ceil(log2(amax / 6))`` is the
ceiling of the fp32-rounded logarithm (taken in fp64 and rounded once, so
the card and the CPU agree).

In the graph, int8 and fp8 per-channel / per-tensor products are ``x @
q.to(x.dtype)`` times the fp32 scale, as the reference computes them (the
activations stay in the model dtype); MXFP4 and blockwise weights are
dequantized, then multiplied. There is no fused dequant-GEMM: on the card
each product materializes the weight in the model dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from itertools import product
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

INT8 = "int8"
FP8 = "fp8"
MXFP4 = "mxfp4"

PER_TENSOR = "per_tensor_symmetric"
PER_CHANNEL = "per_channel_symmetric"
# one scale per ``group_size`` contraction channels per output channel
BLOCKWISE = "blockwise_symmetric"

# the weights a layer stack may quantize; ``modules_to_not_convert``
# subtracts from it. q/k/v are fused into ``qkv_proj`` before quantization,
# so only MLA's bare ``q_proj`` is ever quantized of the three. Routers
# stay in full precision.
DEFAULT_QUANT_MODULES = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    "expert_gate", "expert_up", "expert_down",
    "shared_gate", "shared_up", "shared_down",
)

# the 16 fp4 (e2m1) values, indexed by the 4-bit code: sign x {0, .5, 1,
# 1.5, 2, 3, 4, 6}
_FP4_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], dtype=np.float32)
# midpoints between neighbouring fp4 magnitudes: a magnitude equal to one
# goes to the smaller value (bucketize with right=False)
_FP4_MIDPOINTS = (_FP4_VALUES[1:8] + _FP4_VALUES[0:7]) / 2

_QMAX = {INT8: 127.0, FP8: 448.0}     # int8 range; e4m3's largest normal


@dataclass(frozen=True)
class QuantSpec:
    """Static quantization description: ``dtype`` "int8" | "fp8" |
    "mxfp4", ``scheme`` per-tensor / per-channel / blockwise, and
    ``group_size`` for mxfp4 and blockwise (contraction channels a
    scale)."""

    dtype: str = INT8
    scheme: str = PER_CHANNEL
    group_size: int = 32
    modules_to_not_convert: Tuple[str, ...] = ()

    def converts(self, name: str) -> bool:
        return (name in DEFAULT_QUANT_MODULES
                and name not in self.modules_to_not_convert)


def quant_spec_from_config(tpu_config) -> Optional[QuantSpec]:
    """The QuantSpec of the ``quantized`` / ``quantization_dtype`` /
    ``quantization_type`` / ``modules_to_not_convert`` knobs, None when
    not quantized."""
    if not getattr(tpu_config, "quantized", False):
        return None
    dtype = tpu_config.quantization_dtype
    if dtype in ("f8e4m3", "float8_e4m3fn"):
        dtype = FP8
    skip = tuple(tpu_config.modules_to_not_convert or ())
    return QuantSpec(dtype=dtype, scheme=tpu_config.quantization_type,
                     modules_to_not_convert=skip)


def is_quantized_leaf(w: Any) -> bool:
    return isinstance(w, dict) and "qweight" in w


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as numpy divides: on CUDA, dividing a
    tensor by a Python scalar multiplies by the scalar's reciprocal (an
    ulp off for some values), so the divisor is a tensor."""
    return x / torch.full_like(x, d)


def _absmax_scale(w: torch.Tensor, dims, qmax: float) -> torch.Tensor:
    amax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    return _true_div(torch.clamp(amax, min=1e-8), qmax)


def _to_code(scaled: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == INT8:
        return torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return scaled.to(torch.float8_e4m3fn)


def _quantize_matrix(w: torch.Tensor, spec: QuantSpec
                     ) -> Dict[str, torch.Tensor]:
    """One (K, N) matrix in fp32."""
    if spec.dtype == MXFP4:
        return quantize_mxfp4(w, spec.group_size)
    if spec.dtype not in _QMAX:
        raise ValueError(f"unknown quantization dtype {spec.dtype!r}")
    qmax = _QMAX[spec.dtype]
    if spec.scheme == BLOCKWISE:
        k, n = w.shape
        g = spec.group_size
        assert k % g == 0, (k, g)
        grouped = w.reshape(k // g, g, n)
        scale = _absmax_scale(grouped, (1,), qmax)         # (K//G, 1, N)
        q = _to_code(grouped / scale, spec.dtype)
        return {"qweight": q.reshape(k, n),
                "scale": scale.reshape(k // g, n)}
    dims = (0, 1) if spec.scheme == PER_TENSOR else (0,)
    scale = _absmax_scale(w, dims, qmax)
    return {"qweight": _to_code(w / scale, spec.dtype), "scale": scale}


def quantize_tensor(w: torch.Tensor, spec: QuantSpec
                    ) -> Dict[str, torch.Tensor]:
    """Quantize one weight (..., K, N) on its device, one leading slice
    (layer, expert) at a time, each in fp32."""
    lead = tuple(w.shape[:-2])
    parts = [_quantize_matrix(w[idx].float(), spec)
             for idx in product(*(range(n) for n in lead))]
    return {key: torch.stack([p[key] for p in parts]).reshape(
        *lead, *parts[0][key].shape) for key in ("qweight", "scale")}


def quantize_mxfp4(w: torch.Tensor, group_size: int = 32
                   ) -> Dict[str, torch.Tensor]:
    """MXFP4: e2m1 codes with one power-of-two scale per ``group_size``
    channels of the contraction axis, two codes a byte along it.

    w (..., K, N) -> qweight uint8 (..., K // 2, N) [low nibble = even k,
    high nibble = odd k], scale fp32 (..., K // group_size, N)."""
    *lead, k, n = w.shape
    assert k % group_size == 0, (k, group_size)
    g = w.float().contiguous().reshape(*lead, k // group_size, group_size,
                                       n)
    amax = torch.amax(torch.abs(g), dim=-2, keepdim=True)
    ratio = _true_div(torch.clamp(amax, min=1e-30), 6.0)
    exp = torch.ceil(torch.log2(ratio.double()).float())
    scale = torch.exp2(exp.double()).float()
    scaled = g / scale
    mids = torch.as_tensor(_FP4_MIDPOINTS, device=w.device)
    code = torch.bucketize(torch.abs(scaled), mids).to(torch.uint8)
    code = (code + (scaled < 0).to(torch.uint8) * 8).reshape(*lead, k, n)
    packed = code[..., 0::2, :] | (code[..., 1::2, :] << 4)
    return {"qweight": packed,
            "scale": scale.reshape(*lead, k // group_size, n)}


def _leaf_scheme(leaf: Dict[str, Any]) -> str:
    """uint8 = packed fp4 codes; a scale with more than one row in its
    contraction slot = blockwise; else fp8 or int8 by the code dtype."""
    dt = leaf["qweight"].dtype
    if dt == torch.uint8:
        return MXFP4
    if leaf["scale"].ndim >= 2 and leaf["scale"].shape[-2] > 1:
        return BLOCKWISE
    return FP8 if dt == torch.float8_e4m3fn else INT8


def quantize_params(params: Dict[str, Any], spec: QuantSpec
                    ) -> Dict[str, Any]:
    """Replace every weight ``spec`` converts with its quantized
    leaf-group, on the weights' device. Already quantized leaves and
    low-rank factor pairs (no convertible name inside) are kept."""

    def convert(tree):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict) and not is_quantized_leaf(v):
                out[name] = convert(v)
            elif spec.converts(name) and not is_quantized_leaf(v):
                out[name] = quantize_tensor(v, spec)
            else:
                out[name] = v
        return out

    return convert(params)


def shard_leaf(leaf: Any, cuts) -> Any:
    """A rank's slice of a converted leaf, its fp weight cut as ``cuts``
    say (``parallel/layers.resolve_cuts``: (axis, parts, degree, index)
    each, applied one after the other). A quantized leaf-group is
    quantized whole, then cut: the codes as the weight, the scale on the
    same axes where it has extent there (a column weight's per-channel
    scale follows its columns, a blockwise or MXFP4 scale its row blocks,
    so a cut of the contraction falls on a block edge) and replicated
    where it has one row (a row-parallel weight's per-output scale). A
    low-rank pair keeps the contraction's cut on U (…, K, r) and the
    output's on V (…, r, N): a column weight cuts V, a row weight cuts U,
    the other factor is replicated, so a row weight's sum lands on the
    rank-r intermediate."""
    from ..parallel.layers import shard_tensor
    if not cuts:
        return leaf
    if isinstance(leaf, dict) and "lr_u" in leaf:
        return {"lr_u": shard_leaf(leaf["lr_u"],
                                   [c for c in cuts if c[0] != -1]),
                "lr_v": shard_leaf(leaf["lr_v"],
                                   [c for c in cuts if c[0] != -2])}
    if is_quantized_leaf(leaf):
        return {k: shard_leaf(v, cuts) for k, v in leaf.items()}
    for axis, parts, degree, index in cuts:
        leaf = shard_tensor(leaf, axis, parts, degree, index)
    return leaf


def dequant_oai_mxfp4_blocks(blocks: np.ndarray,
                             scales: np.ndarray) -> np.ndarray:
    """Decode the gpt-oss checkpoint's MXFP4 layout to fp32 (numpy).

    blocks: uint8 (..., rows, n_groups, group_bytes), two fp4 codes a
    byte, the LOW nibble first; scales: uint8 (..., rows, n_groups) e8m0
    exponents biased by 127. Returns (..., rows,
    n_groups * group_bytes * 2)."""
    blocks = np.asarray(blocks)
    scales = np.asarray(scales).astype(np.int32) - 127
    lo = _FP4_VALUES[(blocks & 0x0F).astype(np.int32)]
    hi = _FP4_VALUES[(blocks >> 4).astype(np.int32)]
    vals = np.stack([lo, hi], axis=-1).reshape(*blocks.shape[:-1], -1)
    return (vals * np.exp2(scales)[..., None]).reshape(
        *blocks.shape[:-2], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# in the graph
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fp4_pair_table(dtype, device) -> torch.Tensor:
    """(256, 2): the two fp4 values of each byte, low nibble first; one
    table per (dtype, device), made at the first (eager) call, so a CUDA
    graph capture copies nothing from the host."""
    codes = np.arange(256)
    pairs = np.stack([_FP4_VALUES[codes & 0x0F], _FP4_VALUES[codes >> 4]],
                     axis=-1)
    return torch.as_tensor(pairs, device=device).to(dtype)


def _decode_mxfp4(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Packed codes (..., K // 2, N) and scales (..., K // G, N) -> values
    (..., K, N): one gather of each byte's value pair, then the scale
    product written straight into the (K, N) layout (byte j's pair is
    channels 2j and 2j + 1)."""
    *lead, kh, n = q.shape
    k = 2 * kh
    group = k // scale.shape[-2]
    pairs = torch.index_select(_fp4_pair_table(dtype, q.device), 0,
                               q.reshape(-1).int())
    pairs = pairs.view(*lead, k // group, group // 2, n, 2).transpose(-1, -2)
    out = torch.empty((*lead, k // group, group // 2, 2, n), dtype=dtype,
                      device=q.device)
    torch.mul(pairs, scale.to(dtype)[..., :, None, None, :], out=out)
    return out.view(*lead, k, n)


def dequantize(leaf: Dict[str, Any], dtype=torch.bfloat16) -> torch.Tensor:
    """The weight in ``dtype``. int8 / fp8 / blockwise codes times their
    scale in fp32, then cast. An fp4 value (at most two significant bits)
    times a power-of-two scale is exact in any dtype with fp32's exponent
    range, so MXFP4 decodes straight into bf16 or fp32: the same bits as
    the reference's fp32 product cast, without an fp32 copy."""
    q, scale = leaf["qweight"], leaf["scale"]
    scheme = _leaf_scheme(leaf)
    if scheme == MXFP4:
        work = dtype if dtype in (torch.bfloat16, torch.float32) \
            else torch.float32
        return _decode_mxfp4(q, scale, work).to(dtype)
    if scheme == BLOCKWISE:
        *lead, k, n = q.shape
        group = k // scale.shape[-2]
        vals = q.float().reshape(*lead, k // group, group, n)
        vals = vals * scale[..., :, None, :]
        return vals.reshape(*lead, k, n).to(dtype)
    return (q.float() * scale).to(dtype)


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight, with matmul's
    broadcasting: a weight (K, N) under x (..., K), or an expert stack
    (E, K, N) under x (1 or E, M, K). An int8 / fp8 per-channel scale
    (..., 1, N) or per-tensor scale (..., 1, 1) then broadcasts over the
    product (..., M, N) as it is stored."""
    if not is_quantized_leaf(w):
        return x @ w
    if _leaf_scheme(w) in (MXFP4, BLOCKWISE):
        return x @ dequantize(w, x.dtype)
    y = x @ w["qweight"].to(x.dtype)
    return (y.float() * w["scale"]).to(x.dtype)


def qlinear(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Linear over a plain weight, a quantized leaf-group or a low-rank
    factor pair ``{"lr_u", "lr_v"}`` (two skinny products through the
    rank; each factor may itself be quantized)."""
    if isinstance(w, dict) and "lr_u" in w:
        return qlinear(qlinear(x, w["lr_u"]), w["lr_v"])
    return qmatmul(x, w)


def qeinsum(pattern: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``torch.einsum(pattern, x, w)`` over a plain or quantized expert
    weight whose output axis is the pattern's last: an int8 / fp8
    per-channel scale (..., 1, N) drops its contraction slot and
    broadcasts over the output's trailing (E, N) (the reference's rule
    for its (B, T, E, ·) layouts)."""
    if not is_quantized_leaf(w):
        return torch.einsum(pattern, x, w)
    if _leaf_scheme(w) in (MXFP4, BLOCKWISE):
        return torch.einsum(pattern, x, dequantize(w, x.dtype))
    scale = w["scale"]
    y = torch.einsum(pattern, x, w["qweight"].to(x.dtype))
    s = scale[..., 0, :] if scale.ndim >= 2 else scale
    return (y.float() * s).to(x.dtype)
