"""Causal flash attention for contiguous prefill (counterpart:
``neuronx_distributed_inference_tpu/ops/flash_attention.py`` — the Pallas
kernel ``_flash_kernel`` :28-84, its wrapper ``flash_attention`` :91-149
and the gate ``supports`` :195).

q (B, S, Hq, D) attends causally over k/v (B, S, Hkv, D), query head h
reading KV head h // (Hq/Hkv), with an optional static sliding window
(attend iff qpos - kpos < window) and tanh soft-cap; softmax in fp32,
output in q's dtype. Positions are the array indices (the caller admits
the kernel only for arange positions).

On CUDA tensors :func:`flash_attention` launches a hand-written Hopper
kernel of ``csrc/flash_attention.cu``: for bf16 the tensor-core kernel
(TMA, wgmma), for fp32 the CUDA-core kernel (its header says what bounds
them on the H100 and what the designs do about that); on CPU tensors it runs
:func:`flash_attention_plain`. There is no fall back from one to the
other. On fake tensors it returns an empty output of its shape and hands
its work (:func:`flash_work`) to ``decode_attention``'s listeners."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from . import attention as attn_ops
from . import decode_attention

KERNEL_NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# S must be a multiple of the kernel's query tile: 128 for bf16 (the
# tensor-core kernel), 64 for fp32 (the CUDA-core kernel)
_SEQ_TILE = {torch.bfloat16: 128, torch.float32: 64}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, window: int = 0,
                          soft_cap: Optional[float] = None) -> torch.Tensor:
    """Plain-PyTorch twin: the model's masked ``mha`` over
    ``prefill_causal_mask``, all in fp32 as the kernel computes (the
    probabilities are not rounded to a bf16 input's dtype), cast to q's
    dtype once at the end."""
    b, s = q.shape[:2]
    pos = torch.arange(s, device=q.device)[None, :].expand(b, s)
    mask = attn_ops.prefill_causal_mask(pos, window)
    return attn_ops.mha(q.float(), k.float(), v.float(), mask, scale,
                        logits_soft_cap=soft_cap).to(q.dtype)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, S, Hq, D) and k/v (B, S, Hkv, D)")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, S, Hkv, D) = {(b, s, hkv, d)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of {tuple(_DTYPES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all inputs must be on one device")


def check_kernel_shapes(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on what the kernels do not take (the wrapper checks this before
    a launch; q/k/v already passed ``_check_inputs``): S a multiple of the
    dtype's query tile (``_SEQ_TILE``), head_dim 64 or 128, the head dim
    contiguous, and every row and stride a multiple of 16 bytes (the bf16
    kernel's TMA boxes and the fp32 kernel's 16-byte loads)."""
    s, d = q.shape[1], q.shape[3]
    tile = _SEQ_TILE[q.dtype]
    if s % tile or d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes S a multiple of {tile} for "
                         f"{q.dtype} and head_dim in {_HEAD_DIMS} (got "
                         f"S={s}, D={d})")
    epv = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % epv for st in t.stride()[:3])):
            raise ValueError(f"{name}: the kernel reads rows as 16-byte "
                             "vectors; the head dim must be contiguous and "
                             "every row 16-byte aligned")


def flash_work(q, k, v, *, window=0) -> Tuple[int, int]:
    """(flops, bytes) of one :func:`flash_attention` call, the formula of
    its bound in PERF.md: QK and PV over the causal (windowed) keys of
    every query; q, k, v read and the output written once."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    window = int(window)
    if 0 < window < s:
        keys = window * (window + 1) // 2 + (s - window) * window
    else:
        keys = s * (s + 1) // 2
    flops = 4 * b * hq * d * keys
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * q.element_size()
    return flops, nbytes


def _kernel_fn():
    fn = _build.load(KERNEL_NAME).nxdi_flash_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 4 + [i] * 5 + [p, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: int = 0,
                    soft_cap: Optional[float] = None) -> torch.Tensor:
    """q (B, S, Hq, D); k/v (B, S, Hkv, D), views with any batch, sequence
    and head strides (the head dim contiguous) -> (B, S, Hq, D) in q's
    dtype, contiguous.

    CUDA tensors launch the kernel on the current stream and add one to
    ``flash_attention.launches`` (``.captured`` inside a CUDA-graph
    capture); they must meet the kernel's shape gate
    (:func:`check_kernel_shapes`). CPU tensors run
    :func:`flash_attention_plain`; fake tensors an empty output
    (``decode_attention.fake_result``)."""
    _check_inputs(q, k, v)
    if decode_attention.is_fake(q):
        return decode_attention.fake_result("flash_attention", flash_work,
                                            q, q, k, v, window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, window=window,
                                     soft_cap=soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_shapes(q, k, v)
    b, s, hq, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, out)
                                      for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d, ctypes.addressof(strides), int(window),
            float(scale), float(soft_cap) if soft_cap is not None else 0.0,
            _DTYPES[q.dtype], stream)
    if rc != 0:
        why = {-2: "the driver offers no cuTensorMapEncodeTiled",
               -3: "the driver refused a TMA tensor map"}.get(
                   rc, f"cudaError {rc}")
        raise RuntimeError(f"flash_attention kernel launch failed ({why})")
    decode_attention.count_launch(flash_attention)
    return out


flash_attention.launches = 0
flash_attention.captured = 0


def supports(seq_len: int, head_dim: int, has_sink: bool, chunk: int,
             block: int = 128) -> bool:
    """The JAX gate (flash_attention.py:195) narrowed to what the kernel
    takes: head_dim 64 or 128 (JAX: any multiple of 64)."""
    return (seq_len % block == 0 and seq_len >= block
            and head_dim in _HEAD_DIMS and not has_sink and chunk == 0)
