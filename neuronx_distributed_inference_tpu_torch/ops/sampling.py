"""On-device sampling (counterpart:
``neuronx_distributed_inference_tpu/ops/sampling.py:24-100`` and ``sample``
:169): greedy argmax, or per-request top-k / top-p / temperature sampling
over a (B, 3) ``[top_k, top_p, temperature]`` parameter tensor.

Random draws come from an explicit ``torch.Generator``; they are not the
JAX package's threefry bits, so sampled streams of the two packages differ
(tests compare greedy streams and the truncated distributions). The
positionally coupled draw (``coupled_sample``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import OnDeviceSamplingConfig


def prepare_sampling_params(batch_size: int, top_k=1, top_p=1.0,
                            temperature=1.0) -> np.ndarray:
    """Host helper -> (B, 3) fp32 [top_k, top_p, temperature]."""

    def _bcast(v):
        a = np.asarray(v, dtype=np.float32).reshape(-1)
        if a.size == 1:
            a = np.full((batch_size,), a[0], dtype=np.float32)
        if a.size != batch_size:
            raise ValueError(f"sampling param batch {a.size} != "
                             f"{batch_size}")
        return a

    return np.stack([_bcast(top_k), _bcast(top_p), _bcast(temperature)],
                    axis=1)


def mask_padded_logits(logits: torch.Tensor, pad_size: int) -> torch.Tensor:
    """Mask the vocab-padding columns (the vocabulary is padded to a
    multiple of 128) with the dtype's most negative finite value."""
    if pad_size == 0:
        return logits
    v = logits.shape[-1]
    col = torch.arange(v, device=logits.device) >= (v - pad_size)
    return logits.masked_fill(col, torch.finfo(logits.dtype).min)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) -> (…,) int32 argmax (first index on ties, like jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def truncated_probs(logits: torch.Tensor, sampling_params: torch.Tensor,
                    global_topk: int = 256):
    """logits (B, V) + sampling_params (B, 3) -> (probs, top_idx), both
    (B, k) with k = min(global_topk, V), probs renormalized over the kept
    prefix. top_k <= 0 means no k truncation beyond ``global_topk``."""
    b, v = logits.shape
    k = min(global_topk, v)
    lf = logits.float()
    top_vals, top_idx = torch.topk(lf, k, dim=-1)     # sorted descending
    sp = sampling_params.to(device=lf.device, dtype=torch.float32)
    req_k, req_p = sp[:, 0], sp[:, 1]
    temp = torch.clamp(sp[:, 2], min=1e-6)
    ranks = torch.arange(k, dtype=torch.float32, device=lf.device)[None, :]
    kmask = torch.where(req_k[:, None] > 0, ranks < req_k[:, None],
                        torch.ones_like(ranks, dtype=torch.bool))
    scaled = top_vals / temp[:, None]
    probs = torch.softmax(scaled.masked_fill(~kmask, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    pmask = (cum - probs) < req_p[:, None]
    probs = torch.where(pmask & kmask, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs, top_idx


def topk_topp_sample(logits: torch.Tensor, sampling_params: torch.Tensor,
                     generator: Optional[torch.Generator],
                     global_topk: int = 256,
                     deterministic: bool = False) -> torch.Tensor:
    """Per-request top-k/top-p/temperature sampling: a gumbel-max draw over
    the truncated distribution, noise from ``generator``."""
    probs, top_idx = truncated_probs(logits, sampling_params, global_topk)
    if deterministic:
        choice = torch.argmax(probs, dim=-1)
    else:
        u = torch.rand(probs.shape, generator=generator,
                       device=probs.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        g = -torch.log(-torch.log(u.clamp(min=tiny)))
        score = torch.where(probs > 0, torch.log(probs) + g,
                            torch.full_like(probs, float("-inf")))
        choice = torch.argmax(score, dim=-1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)


def sample(logits: torch.Tensor, config: Optional[OnDeviceSamplingConfig],
           sampling_params: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy vs multinomial; (B, V) or (B, T, V) logits -> int32 tokens."""
    shape = logits.shape[:-1]
    logits = logits.reshape(-1, logits.shape[-1])
    if sampling_params is None and (config is None or not config.do_sample):
        toks = greedy_sample(logits)
    else:
        if sampling_params is None:
            sampling_params = torch.tensor(
                [[config.top_k, config.top_p, config.temperature]],
                dtype=torch.float32, device=logits.device).expand(
                    logits.shape[0], 3)
        elif sampling_params.shape[0] != logits.shape[0]:
            sampling_params = torch.repeat_interleave(
                sampling_params,
                logits.shape[0] // sampling_params.shape[0], dim=0)
        toks = topk_topp_sample(
            logits, sampling_params, generator,
            config.global_topk if config else 256,
            config.deterministic if config else False)
    return toks.reshape(shape)
