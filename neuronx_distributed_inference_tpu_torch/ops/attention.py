"""Attention cores and masks of the XLA-equivalent paths (counterpart:
``neuronx_distributed_inference_tpu/ops/attention.py`` — ``repeat_kv``
:29, ``alibi_slopes`` :39, ``_alibi_bias`` :69, ``mha`` :77, ``mha_hl``
:128, ``mha_decode_merged`` :168, masks :232-283 with
``rolling_decode_mask`` :261 and ``speculation_mask`` :283).

Layouts as in the JAX package: q (B, T, Hq, D); k/v (B, S, Hkv, D), or the
contiguous cache's native layouts for ``mha_hl`` (K transposed (B, Hkv, D,
S), V (B, Hkv, S, D)); mask (B, T, S) boolean, True = attend. As the
JAX einsums with ``preferred_element_type=float32`` do, both products take
their operands in the storage dtype (the probabilities rounded to v's
dtype) and accumulate into fp32; scores and softmax are fp32. On the card
the bf16 products run on the tensor cores with an fp32 result and no fp32
copy of K or V; the CPU multiplies fp32 copies (:func:`_bmm_f32`).

ALiBi (BLOOM, MPT): ``mha`` and ``mha_hl`` take ``alibi`` = (slopes (Hq,),
key positions (B, S) or (1, S)) and add ``slope_h * kpos`` to the scaled
fp32 scores before the soft-cap and the mask; the softmax's shift
invariance makes it the relative ``slope_h * (kpos - qpos)``. No kernel
takes ALiBi (the model's gates keep such layers on these cores).
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import numpy as np
import torch

NEG_INF = -30000.0   # finite large-negative fill (the JAX package's value)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def alibi_slopes(num_heads: int, variant: str = "bloom") -> np.ndarray:
    """Per-head ALiBi slopes, fp32 (counterpart :39-66): the closest power
    of two below ``num_heads`` plus interleaved extra slopes (HF
    ``build_alibi_tensor``). The counterpart's ``"mpt"`` variant (the next
    power of two up with ``alibi_bias_max`` 8, odd slopes first, HF
    ``build_mpt_alibi_tensor``) gives the same fp32 slopes at every head
    count from 1 to 512, so one formula serves both names."""
    if variant not in ("bloom", "mpt"):
        raise ValueError(f"unknown alibi variant {variant!r}")
    cp2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = base ** np.arange(1, cp2 + 1, dtype=np.float64)
    if cp2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        n_extra = min(2 * cp2, num_heads) - cp2
        extra = extra_base ** np.arange(1, 2 * n_extra, 2, dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def _alibi_bias(alibi, hkv: int, g: int) -> torch.Tensor:
    """(slopes (Hq,), key positions (B, S) or (1, S)) -> the additive fp32
    score bias (B, Hkv, G, 1, S) (counterpart :69-74)."""
    slopes, kv_pos = alibi
    sl = slopes.float().reshape(1, hkv, g, 1, 1)
    return sl * kv_pos.float()[:, None, None, None, :]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor,
             alpha: Optional[float] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched product with fp32 output, (N, M, K) x (N, K, P), times
    ``alpha`` when given (the scores' scale, applied in the product's fp32
    epilogue: one rounding of alpha * sum, as a separate fp32 multiply
    gives, without another pass over the output). On CUDA a bf16 / fp16
    pair multiplies on the tensor cores in its storage dtype with fp32
    accumulation and an fp32 result (``aten::baddbmm.dtype`` /
    ``aten::bmm.dtype``, the counterpart of
    ``preferred_element_type=float32``); nothing is copied to fp32. Every
    other pair, and every pair on the CPU (which has no ``.dtype`` kernel),
    multiplies fp32 copies: a product of two bf16 values is exact in fp32,
    so the two routes differ only in the order of the fp32 sums. With
    ``alpha``, ``out`` may be given: an fp32 (N, M, P) view whose rows may
    be strided (a product writes rows of a wider buffer in place)."""
    low = (a.device.type == "cuda" and a.dtype == b.dtype
           and a.dtype in (torch.bfloat16, torch.float16))
    if alpha is None:
        if low:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())
    if out is None:
        out = torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                          dtype=torch.float32, device=a.device)
    # beta = 0: the uninitialised ``out`` is not read
    if low:
        return torch.baddbmm(out, a, b, beta=0.0, alpha=alpha,
                             out_dtype=torch.float32, out=out)
    return torch.baddbmm(out, a.float(), b.float(), beta=0.0, alpha=alpha,
                         out=out)


def _softcap_(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is not None:
        scores.div_(cap).tanh_().mul_(cap)
    return scores


def _core(q: torch.Tensor, kt: torch.Tensor, vv: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float,
          logits_soft_cap: Optional[float], sink: Optional[torch.Tensor],
          out_dtype: torch.dtype, alibi=None) -> torch.Tensor:
    """The attention core over GQA groups flattened into the batch: q (B,
    T, Hq, D), kt (B * Hkv, D, S) and vv (B * Hkv, S, Dv) -> (B, T, Hq,
    Dv). Besides the products the fp32 scores take the mask in place and
    one softmax; the scale rides the score product's epilogue. A sink
    joins the softmax as one more column of the scores' buffer: the score
    product writes the rows of a buffer ``s + 1`` wide (rounded up to 32
    bytes, so its fp32 and bf16 rows stay 16-byte aligned for the
    products; the padding at NEG_INF) whose column ``s`` holds the head's
    sink logit, so the same three contiguous passes (mask, softmax, cast)
    run with or without it; the products read only the first ``s``
    columns of the probabilities. ``alibi`` adds its bias
    (:func:`_alibi_bias`) to the scaled scores in place, before the
    soft-cap and the mask (counterpart :99-104)."""
    b, t, hq, d = q.shape
    n, _, s = kt.shape
    hkv = n // b
    g = hq // hkv
    qg = (q.reshape(b, t, hkv, g, d).permute(0, 2, 3, 1, 4)
          .reshape(n, g * t, d))
    width = s
    if sink is None:
        full = scores = _bmm_f32(qg, kt, scale)         # (B*Hkv, G*T, S)
    else:
        width = -(-(s + 1) // 8) * 8
        full = torch.empty((n, g * t, width), dtype=torch.float32,
                           device=q.device)
        scores = _bmm_f32(qg, kt, scale, out=full[..., :s])
        full[..., s + 1:] = NEG_INF
        full.view(b, hkv, g, t, width)[..., s] = sink.float().reshape(
            1, hkv, g, 1)
        if mask is not None:
            wide = mask.new_ones((b, t, width))
            wide[..., :s] = mask
            mask = wide
    if alibi is not None:
        full.view(b, hkv, g, t, width)[..., :s].add_(
            _alibi_bias(alibi, hkv, g))
    _softcap_(scores, logits_soft_cap)
    if mask is not None:
        full.view(b, hkv, g, t, width).masked_fill_(
            ~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(full, dim=-1)
    del full, scores            # the scores' memory serves the cast
    probs = probs.to(vv.dtype)[..., :s].reshape(n, g * t, s)
    out = _bmm_f32(probs, vv)                           # (B*Hkv, G*T, Dv)
    dv = vv.shape[-1]
    return (out.view(b, hkv, g, t, dv).permute(0, 3, 1, 2, 4)
            .reshape(b, t, hq, dv).to(out_dtype))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], scale: float,
        logits_soft_cap: Optional[float] = None,
        sink: Optional[torch.Tensor] = None, alibi=None) -> torch.Tensor:
    """Masked multi-head attention with GQA grouping (q head i reads KV
    head i // (Hq/Hkv)). q (B,T,Hq,D), k/v (B,S,Hkv,D) -> (B,T,Hq,D).
    ``sink``: per-head learned softmax sink logits (Hq,), entering the
    denominator only; ``alibi``: (slopes (Hq,), key positions (B or 1, S)).
    K and V are relaid out per KV head in their own dtype (one copy each,
    as the products need a batch of matrices)."""
    b, s, hkv, d = k.shape
    kt = k.permute(0, 2, 3, 1).reshape(b * hkv, d, s)
    vv = v.permute(0, 2, 1, 3).reshape(b * hkv, s, v.shape[-1])
    return _core(q, kt, vv, mask, scale, logits_soft_cap, sink, q.dtype,
                 alibi)


def mha_hl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], scale: float,
           logits_soft_cap: Optional[float] = None,
           sink: Optional[torch.Tensor] = None,
           alibi=None) -> torch.Tensor:
    """:func:`mha` over the cache's native layouts: k TRANSPOSED (B, Hkv,
    D, S), v (B, Hkv, S, D). A layer read of the cache (cut at the view)
    flattens to the products' batches without a copy."""
    b, hkv, d, s = k.shape
    return _core(q, k.reshape(b * hkv, d, s),
                 v.reshape(b * hkv, s, v.shape[-1]), mask, scale,
                 logits_soft_cap, sink, q.dtype, alibi)


def mha_hl_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   logits_soft_cap: Optional[float] = None, alibi=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's share of :func:`mha_hl` (flash decoding: the cache's
    slots cut over the cp ranks): the fp32 scores of q (B, T, Hq, D)
    against this shard's keys k (B, Hkv, D, S) take the scale, ALiBi, the
    soft-cap and the mask (masked scores at ``NEG_INF``) as :func:`_core`
    gives them, without the softmax. Returns the unnormalised output
    ``sum_s exp(score - m) v`` (B, T, Hq, Dv) fp32, the row max ``m`` and
    the sum ``l = sum_s exp(score - m)`` (B, T, Hq) fp32. A shard whose
    keys are all masked has ``m = NEG_INF``: merged with a live shard its
    weight ``exp(NEG_INF - M)`` is 0, and when every shard is dead the
    merge spreads over every slot as :func:`_core`'s softmax does."""
    b, t, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[3]
    g = hq // hkv
    n = b * hkv
    qg = (q.reshape(b, t, hkv, g, d).permute(0, 2, 3, 1, 4)
          .reshape(n, g * t, d))
    scores = _bmm_f32(qg, k.reshape(n, d, s), scale)
    view = scores.view(b, hkv, g, t, s)
    if alibi is not None:
        view.add_(_alibi_bias(alibi, hkv, g))
    _softcap_(scores, logits_soft_cap)
    if mask is not None:
        view.masked_fill_(~mask[:, None, None, :, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_sum = p.sum(dim=-1)
    o = _bmm_f32(p.to(v.dtype), v.reshape(n, s, v.shape[-1]))
    dv = v.shape[-1]

    def heads(x, w):
        return (x.view(b, hkv, g, t, w).permute(0, 3, 1, 2, 4)
                .reshape(b, t, hq, w))
    return heads(o, dv), heads(m, 1)[..., 0], heads(l_sum[..., None],
                                                    1)[..., 0]


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
    entries written so far; k_new/v_new (B,1,Hkv,D) the active token.
    The prior and side scores are products in the storage dtype with fp32
    output (:func:`_bmm_f32`); only the one active token is upcast."""
    b, t, hq, d = q.shape
    hkv = k_prior.shape[1]
    g = hq // hkv
    s, c = k_prior.shape[3], k_side.shape[3]
    n = b * hkv
    qg = (q.reshape(b, t, hkv, g, d).permute(0, 2, 3, 1, 4)
          .reshape(n, g * t, d))
    sp = _bmm_f32(qg, k_prior.reshape(n, d, s), scale)
    ss = _bmm_f32(qg, k_side.reshape(n, d, c), scale)
    sa = torch.einsum("bthgd,bthd->bhgt", q.reshape(b, t, hkv, g, d).float(),
                      k_new.float())[..., None] * scale
    _softcap_(sp, logits_soft_cap)
    _softcap_(ss, logits_soft_cap)
    if logits_soft_cap is not None:
        sa = logits_soft_cap * torch.tanh(sa / logits_soft_cap)
    sp = sp.view(b, hkv, g, t, s).masked_fill_(
        ~mask_prior[:, None, None, :, :], NEG_INF)
    ss = ss.view(b, hkv, g, t, c).masked_fill_(
        ~mask_side[:, None, None, :, :], NEG_INF)
    m = torch.maximum(torch.maximum(sp.amax(dim=-1, keepdim=True),
                                    ss.amax(dim=-1, keepdim=True)), sa)
    if sink is not None:
        sink_b = sink.float().reshape(1, hkv, g, 1, 1)
        m = torch.maximum(m, sink_b)
    ep = sp.sub_(m).exp_()
    es = ss.sub_(m).exp_()
    ea = torch.exp(sa - m)
    den = ep.sum(dim=-1, keepdim=True) + es.sum(dim=-1, keepdim=True) + ea
    if sink is not None:
        den = den + torch.exp(sink_b - m)
    dv = v_new.shape[-1]
    pp = ep.div_(den).to(v_prior.dtype).reshape(n, g * t, s)
    ps = es.div_(den).to(v_side.dtype).reshape(n, g * t, c)
    out = (_bmm_f32(pp, v_prior.reshape(n, s, dv))
           + _bmm_f32(ps, v_side.reshape(n, c, dv)))
    out = out.view(b, hkv, g, t, dv).permute(0, 3, 1, 2, 4)  # (B,T,Hkv,G,Dv)
    coeff = (ea / den).permute(0, 3, 1, 2, 4)             # (B,T,Hkv,G,1)
    out = out + coeff * v_new[:, :, :, None, :].float()
    return out.reshape(b, t, hq, dv).to(q.dtype)


def causal_mask(position_ids: torch.Tensor, kv_positions: torch.Tensor,
                window: int = 0, chunk: int = 0) -> torch.Tensor:
    """(B, T, S) attend-mask from query positions (B, T) and key positions
    (B, S); ``window`` > 0 adds the sliding window 0 <= qpos-kpos < window,
    ``chunk`` > 0 Llama4's chunked attention (attend iff both positions
    lie in the same chunk: qpos // chunk == kpos // chunk, floor division
    as the counterpart's). Built from the position tensors on their
    device, so a captured graph recomputes it from each replay's
    positions."""
    qp = position_ids[:, :, None]
    kp = kv_positions[:, None, :]
    m = kp <= qp
    if window > 0:
        m &= (qp - kp) < window
    if chunk > 0:
        m &= (torch.div(qp, chunk, rounding_mode="floor")
              == torch.div(kp, chunk, rounding_mode="floor"))
    return m


def prefill_causal_mask(position_ids: torch.Tensor, window: int = 0,
                        chunk: int = 0) -> torch.Tensor:
    """In-context causal mask: query and key positions are both
    ``position_ids`` (B, S)."""
    return causal_mask(position_ids, position_ids, window, chunk)


def rolling_decode_mask(position_ids: torch.Tensor,
                        window: int) -> torch.Tensor:
    """(B, T, window) mask over a ROLLING cache of ``window`` slots, where
    slot j holds position p_j = P - ((P - j) mod window) for the current
    position P: attend iff p_j >= 0 (the window is inherent to the
    layout). Built from the position tensor on its device, so a captured
    graph recomputes it from each replay's positions."""
    qp = position_ids[:, :, None]
    j = torch.arange(window, dtype=position_ids.dtype,
                     device=position_ids.device)[None, None, :]
    return (qp - torch.remainder(qp - j, window)) >= 0


def decode_mask(position_ids: torch.Tensor, cache_len: int,
                window: int = 0, chunk: int = 0,
                offset: int = 0) -> torch.Tensor:
    """Mask over a contiguous (or gathered) view of ``cache_len`` slots
    whose slot i holds position ``offset + i`` (``offset``: a flash-decoding
    shard's first position). position_ids (B, T)."""
    kv_pos = torch.arange(offset, offset + cache_len,
                          dtype=position_ids.dtype,
                          device=position_ids.device)[None, :]
    kv_pos = kv_pos.expand(position_ids.shape[0], cache_len)
    return causal_mask(position_ids, kv_pos, window, chunk)


def speculation_mask(position_ids: torch.Tensor, cache_len: int,
                     window: int = 0) -> torch.Tensor:
    """Mask of a block of k speculative tokens (B, k) against the cache:
    the decode mask under its own name, as the counterpart keeps it for
    the reference's speculation branch."""
    return decode_mask(position_ids, cache_len, window)
