"""Device resolution for the port's entry points (no counterpart in the JAX
package, whose mesh picks the devices).

Entry points run on the CUDA card unless the caller asks for the CPU. A
missing card is an error, never a silent fall back to the CPU: a run that
was meant to measure the card must not quietly measure the host."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` only when the caller names it.
    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and this process has no CUDA card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run its plain-PyTorch path on "
            "the host")
    return dev
