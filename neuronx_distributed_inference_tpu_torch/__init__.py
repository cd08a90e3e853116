"""PyTorch / CUDA port of ``neuronx_distributed_inference_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside this one is the reference: each module here names
its counterpart file. This package imports ``torch`` and never ``jax`` or
anything of the JAX package. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``device.resolve_device``); each of
the JAX package's three TPU kernels (the paged and the contiguous decode
attention in ``ops/decode_attention.py``, the flash prefill in
``ops/flash_attention.py``) is a hand-written CUDA kernel in ``csrc/``,
built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

from .config import (InferenceConfig, OnDeviceSamplingConfig, TpuConfig,
                     load_pretrained_config)
from .device import resolve_device

__all__ = ["TpuConfig", "InferenceConfig", "OnDeviceSamplingConfig",
           "load_pretrained_config", "resolve_device"]
