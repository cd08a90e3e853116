"""Weight quantization (counterpart:
``neuronx_distributed_inference_tpu/modules/quantization.py``): only the
decoder of the gpt-oss checkpoint's MXFP4 expert layout (``_FP4_VALUES``
:63, ``dequant_oai_mxfp4_blocks`` :209-225), in numpy, so that the GPT-OSS
converter reads ``*_blocks`` / ``*_scales`` tensors into plain weights.
Quantized weights in the graph (``qlinear``, int8 / fp8 / packed mxfp4
leaves) wait for ROADMAP A11."""

from __future__ import annotations

import numpy as np

# the 16 fp4 (e2m1) values, indexed by the 4-bit code
_FP4_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], dtype=np.float32)


def dequant_oai_mxfp4_blocks(blocks: np.ndarray,
                             scales: np.ndarray) -> np.ndarray:
    """Decode the gpt-oss MXFP4 layout to fp32.

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
