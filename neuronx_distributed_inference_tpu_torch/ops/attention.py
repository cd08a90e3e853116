"""Attention cores and masks of the XLA-equivalent paths (counterpart:
``neuronx_distributed_inference_tpu/ops/attention.py`` — ``repeat_kv``
:29, ``mha`` :77, ``mha_hl`` :128, ``mha_decode_merged`` :168, masks
:232-283; the chunked-attention masks wait for the families that use
them).

Layouts as in the JAX package: q (B, T, Hq, D); k/v (B, S, Hkv, D), or the
contiguous cache's native layouts for ``mha_hl`` (K transposed (B, Hkv, D,
S), V (B, Hkv, S, D)); mask (B, T, S) boolean, True = attend. Scores and softmax in fp32; the value
product takes the probabilities in v's dtype and accumulates in fp32, as
the JAX einsums with ``preferred_element_type=float32`` do.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -30000.0   # finite large-negative fill (the JAX package's value)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], scale: float,
        logits_soft_cap: Optional[float] = None,
        sink: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked multi-head attention with GQA grouping (q head i reads KV
    head i // (Hq/Hkv)). q (B,T,Hq,D), k/v (B,S,Hkv,D) -> (B,T,Hq,D).
    ``sink``: per-head learned softmax sink logits (Hq,), entering the
    denominator only."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qk = q.reshape(b, t, hkv, g, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qk, k.float()) * scale
    if logits_soft_cap is not None:
        scores = logits_soft_cap * torch.tanh(scores / logits_soft_cap)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    if sink is not None:
        sink_col = sink.float().reshape(1, hkv, g, 1, 1).expand(
            b, hkv, g, t, 1)
        scores_all = torch.cat([scores, sink_col], dim=-1)
        m = scores_all.amax(dim=-1, keepdim=True)
        e = torch.exp(scores_all - m)
        probs = (e / e.sum(dim=-1, keepdim=True))[..., :-1]
    else:
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, t, hq, v.shape[-1]).to(q.dtype)


def mha_hl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], scale: float,
           logits_soft_cap: Optional[float] = None,
           sink: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mha` over the cache's native layouts: k TRANSPOSED (B, Hkv,
    D, S), v (B, Hkv, S, D) (read through views)."""
    return mha(q, k.permute(0, 3, 1, 2), v.transpose(1, 2), mask, scale,
               logits_soft_cap=logits_soft_cap, sink=sink)


def mha_decode_merged(q: torch.Tensor, k_prior: torch.Tensor,
                      v_prior: torch.Tensor, mask_prior: torch.Tensor,
                      k_side: torch.Tensor, v_side: torch.Tensor,
                      mask_side: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, scale: float,
                      logits_soft_cap: Optional[float] = None,
                      sink: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over a read-only prior cache plus the current
    decode chunk's side buffer plus the active token, in one softmax.

    q (B,1,Hq,D); k_prior (B,Hkv,D,S) transposed; v_prior (B,Hkv,S,D);
    k_side (B,Hkv,D,C); v_side (B,Hkv,C,D); mask_prior (B,1,S) excludes
    every slot the side buffer covers; mask_side (B,1,C) selects the side
    entries written so far; k_new/v_new (B,1,Hkv,D) the active token."""
    b, t, hq, d = q.shape
    hkv = k_prior.shape[1]
    g = hq // hkv
    qk = q.reshape(b, t, hkv, g, d).float()
    sp = torch.einsum("bthgd,bhds->bhgts", qk, k_prior.float()) * scale
    ss = torch.einsum("bthgd,bhdc->bhgtc", qk, k_side.float()) * scale
    sa = torch.einsum("bthgd,bthd->bhgt", qk,
                      k_new.float())[..., None] * scale
    if logits_soft_cap is not None:
        sp = logits_soft_cap * torch.tanh(sp / logits_soft_cap)
        ss = logits_soft_cap * torch.tanh(ss / logits_soft_cap)
        sa = logits_soft_cap * torch.tanh(sa / logits_soft_cap)
    sp = sp.masked_fill(~mask_prior[:, None, None, :, :], NEG_INF)
    ss = ss.masked_fill(~mask_side[:, None, None, :, :], NEG_INF)
    m = torch.maximum(torch.maximum(sp.amax(dim=-1, keepdim=True),
                                    ss.amax(dim=-1, keepdim=True)), sa)
    if sink is not None:
        sink_b = sink.float().reshape(1, hkv, g, 1, 1)
        m = torch.maximum(m, sink_b)
    ep, es, ea = torch.exp(sp - m), torch.exp(ss - m), torch.exp(sa - m)
    den = ep.sum(dim=-1, keepdim=True) + es.sum(dim=-1, keepdim=True) + ea
    if sink is not None:
        den = den + torch.exp(sink_b - m)
    out = torch.einsum("bhgts,bhsd->bthgd",
                       (ep / den).to(v_prior.dtype).float(), v_prior.float())
    out = out + torch.einsum("bhgtc,bhcd->bthgd",
                             (es / den).to(v_side.dtype).float(),
                             v_side.float())
    coeff = (ea / den).permute(0, 3, 1, 2, 4)             # (B,T,Hkv,G,1)
    out = out + coeff * v_new[:, :, :, None, :].float()
    return out.reshape(b, t, hq, v_new.shape[-1]).to(q.dtype)


def causal_mask(position_ids: torch.Tensor, kv_positions: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """(B, T, S) attend-mask from query positions (B, T) and key positions
    (B, S); ``window`` > 0 adds the sliding window 0 <= qpos-kpos < window.
    (Chunked attention waits for the families that use it.)"""
    qp = position_ids[:, :, None]
    kp = kv_positions[:, None, :]
    m = kp <= qp
    if window > 0:
        m &= (qp - kp) < window
    return m


def prefill_causal_mask(position_ids: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """In-context causal mask: query and key positions are both
    ``position_ids`` (B, S)."""
    return causal_mask(position_ids, position_ids, window)


def decode_mask(position_ids: torch.Tensor, cache_len: int,
                window: int = 0) -> torch.Tensor:
    """Mask over a contiguous (or gathered) view of ``cache_len`` slots
    whose slot i holds position i. position_ids (B, T)."""
    kv_pos = torch.arange(cache_len, dtype=position_ids.dtype,
                          device=position_ids.device)[None, :]
    kv_pos = kv_pos.expand(position_ids.shape[0], cache_len)
    return causal_mask(position_ids, kv_pos, window)
