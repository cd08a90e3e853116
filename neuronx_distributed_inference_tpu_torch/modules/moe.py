"""Mixture-of-Experts block (counterpart:
``neuronx_distributed_inference_tpu/modules/moe.py`` — ``MoESpec`` :42,
``route`` :101, ``_sparsemixer_route`` :150, ``combine_matrix`` :187,
``_glu`` :196, ``experts_dense`` :204, ``experts_ragged`` :244,
``moe_block`` :293, ``_shared_experts`` :342).

The reference's design, on one card:

  * Router: an fp32 (H, E) product, softmax / sigmoid / top-k over raw
    logits, the router bias in its two modes, group-limited selection,
    renormalisation and routed scaling. Top-k keeps ``jax.lax.top_k``'s
    order (descending, the lower index first among equal scores) through a
    stable descending sort: ``torch.topk`` does not promise an order for
    ties.
  * Dense path (B·T of the padded grid at most ``dense_max_tokens``):
    every expert runs on every token, combined with the (B, T, E) routing
    weights in fp32. The products are ``(1, BT, H) @ (E, H, I)`` batched
    matmuls that read each expert's weight in place (``torch.einsum`` of
    the reference's subscripts copies the whole weight first).
  * Ragged path: token copies sorted by expert (stable), one grouped
    product per projection (``torch._grouped_mm`` with the group ends
    left on the device, the counterpart of ``jax.lax.ragged_dot``),
    unsorted and combined in fp32. No device value is read on the host.
  * Shared experts: a dense GLU MLP added to the routed output.
  * Quantized expert leaves (``modules/quantization.py``): the dense path
    applies the reference's ``qeinsum`` rule through ``qmatmul`` (int8 /
    fp8 codes cast to the activation dtype, the fp32 scale (E, 1, ·)
    broadcast over the (E, B·T, ·) product; MXFP4 and blockwise weights
    dequantized first); the ragged path dequantizes every expert weight
    before its grouped product; shared experts go through ``qlinear``.

Across a mesh (``mesh=``, ``parallel/mesh.Mesh``; the counterpart's
``shard_constraint`` calls) a rank holds the experts
``[ep_rank·E/ep, (ep_rank + 1)·E/ep)`` with their intermediate axis cut
over tp, and its slice of the shared experts' intermediate (cut over
every rank). The router is replicated and routes every token on every
rank (the same fp32 input, the same stable sorts). Each path computes the
rank's experts only: the dense path takes the combine matrix's local
columns, the ragged path sends only the token copies routed to local
experts into the grouped products (group ends over the local experts;
the other copies sort after them and add nothing). The block returns the
rank's PARTIAL sum (routed plus shared); the caller reduces it once over
the whole model-parallel group (``models/model_base._mlp_block``), as
GSPMD's psum over ``("ep", "tp")`` does. Per-expert down biases are added
on the ranks of tp index 0 only (every tp rank of an expert would add
them otherwise). With ``tkg_experts_local`` (``moe_tkg_ep_degree=1``) a
decode step on the dense path reads the hybrid copy made once at load
(``expert_*_tkg``: every expert, the intermediate cut tp-major over
``(tp, ep)``, index ``tp_rank·ep + ep_rank``; the counterpart's
moe.py:305-336): the copy is taken by T = 1 steps of the contiguous
decode and of the paged path alike (the counterpart re-lays out the
contiguous decode only; the layout changes no value). Quantized expert
leaves have no such copy and keep the stored layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.sampling import top_k
from .quantization import dequantize, is_quantized_leaf, qlinear, qmatmul

# the hybrid decode copy of an expert leaf (moe_tkg_ep_degree=1)
TKG = "_tkg"


@dataclass(frozen=True)
class MoESpec:
    """Static MoE architecture (the counterpart's fields and defaults)."""

    num_experts: int
    top_k: int
    intermediate_size: int           # per-expert intermediate
    normalize_topk: bool = True      # renormalize top-k affinities
    routed_scaling: Optional[float] = None
    # "softmax" | "sigmoid" | "sparsemixer" (phimoe inference routing)
    router_act: str = "softmax"
    sparsemixer_eps: float = 0.01
    pre_softmax_topk: bool = False   # top-k on raw logits, then act over k
    shared_intermediate: int = 0     # 0 = no shared experts
    act: str = "silu"
    # bias added to router scores: "select" = for selection only
    # (DeepSeek-V3), "logits" = part of the logits (gpt-oss)
    has_router_bias: bool = False
    router_bias_mode: str = "select"
    expert_bias: bool = False        # per-expert projection biases
    # "gated" = act(gate) * up; "oss_clamp" = gpt-oss clamped swiglu
    glu_style: str = "gated"
    glu_alpha: float = 1.702
    glu_limit: float = 7.0
    # group-limited routing (DeepSeek-V3)
    n_group: int = 1
    topk_group: int = 1
    # llama4: the routing weight scales the expert INPUT
    input_scaled: bool = False
    # B*T threshold at or below which the dense all-experts path runs
    dense_max_tokens: int = 64
    # the hybrid decode layout across a mesh (moe_tkg_ep_degree=1): T = 1
    # steps on the dense path read the every-expert copy ``expert_*_tkg``
    tkg_experts_local: bool = False


def _act_fn(name: str):
    from ..models.model_base import ACT_FNS
    return ACT_FNS[name]


def route(moe: MoESpec, h: torch.Tensor, router_w: torch.Tensor,
          router_bias: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, T, H), router_w (H, E) -> (top_vals (B, T, k) fp32
    affinities, top_idx (B, T, k) int64 expert ids)."""
    logits = h.float() @ router_w.float()                        # (B,T,E)
    if moe.router_act == "sparsemixer":
        return _sparsemixer_route(moe, logits)
    if router_bias is not None and moe.router_bias_mode == "logits":
        logits = logits + router_bias
        router_bias = None
    if moe.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
    elif moe.pre_softmax_topk:
        scores = logits
    else:
        scores = torch.softmax(logits, dim=-1)
    select = scores + router_bias if router_bias is not None else scores
    if moe.n_group > 1:
        # group-limited greedy: rank groups by the sum of their top-2
        # biased scores, zero out the losing groups
        b, t, e = select.shape
        g = moe.n_group
        grouped = select.reshape(b, t, g, e // g)
        top2, _ = top_k(grouped, 2)
        _, group_idx = top_k(top2.sum(dim=-1), moe.topk_group)
        group_mask = torch.zeros((b, t, g), dtype=torch.bool,
                                 device=select.device).scatter_(
            -1, group_idx, True)
        mask = group_mask[..., None].expand(grouped.shape).reshape(b, t, e)
        select = torch.where(mask, select, torch.zeros_like(select))
    _, top_idx = top_k(select, moe.top_k)
    top_vals = torch.gather(scores, -1, top_idx)
    if moe.pre_softmax_topk and moe.router_act != "sigmoid":
        top_vals = torch.softmax(top_vals, dim=-1)
    if moe.normalize_topk:
        top_vals = top_vals / torch.clamp(
            top_vals.sum(dim=-1, keepdim=True), min=1e-20)
    if moe.routed_scaling is not None:
        top_vals = top_vals * moe.routed_scaling
    return top_vals, top_idx


def _sparsemixer_pick(scores: torch.Tensor, ref: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sparsemixer selection over ``scores``: the jitter threshold and
    the |.| stabiliser come from ``ref`` (the original logits), the max,
    argmax and softmax from ``scores``."""
    mx = scores.max(dim=-1, keepdim=True).values
    factor = torch.maximum(ref.abs(), mx)
    masked = torch.where((mx - ref) / factor > 2 * eps,
                         torch.full_like(scores, float("-inf")), scores)
    idx = scores.argmax(dim=-1)
    gates = torch.softmax(masked, dim=-1)
    return torch.gather(gates, -1, idx[..., None])[..., 0], idx


def _sparsemixer_route(moe: MoESpec, logits: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phi-3.5-MoE sparsemixer routing, inference path: expert i is the
    argmax of the remaining scores; its affinity a softmax over the scores
    with entries masked where (max - s) / max(|s|, max) > 2 * eps. top_k
    must be 2."""
    if moe.top_k != 2:
        raise NotImplementedError(
            f"sparsemixer routing is defined for top_k=2 (got {moe.top_k})")
    eps = moe.sparsemixer_eps
    v1, i1 = _sparsemixer_pick(logits, logits, eps)
    # second pass: the winner masked out, threshold against the remaining
    # max, stabiliser still |original logits|
    winner = torch.nn.functional.one_hot(i1, logits.shape[-1]).bool()
    rest = torch.where(winner, torch.full_like(logits, float("-inf")),
                       logits)
    v2, i2 = _sparsemixer_pick(rest, logits, eps)
    return torch.stack([v1, v2], dim=-1), torch.stack([i1, i2], dim=-1)


def combine_matrix(num_experts: int, top_vals: torch.Tensor,
                   top_idx: torch.Tensor) -> torch.Tensor:
    """Scatter (B, T, k) affinities into a dense (B, T, E) fp32 matrix."""
    b, t, _ = top_vals.shape
    out = torch.zeros((b, t, num_experts), dtype=torch.float32,
                      device=top_vals.device)
    return out.scatter_add_(-1, top_idx, top_vals.float())


def _glu(moe: MoESpec, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if moe.glu_style == "oss_clamp":
        gate = torch.clamp(gate, max=moe.glu_limit)
        up = torch.clamp(up, -moe.glu_limit, moe.glu_limit)
        return (up + 1.0) * (gate * torch.sigmoid(gate * moe.glu_alpha))
    return _act_fn(moe.act)(gate) * up


def _num_experts(w) -> int:
    """The experts a plain or quantized (…, E, K, N) stack holds."""
    return (w["qweight"] if is_quantized_leaf(w) else w).shape[-3]


def experts_dense(moe: MoESpec, x: torch.Tensor, top_vals: torch.Tensor,
                  top_idx: torch.Tensor, wg, wu, wd, bg=None, bu=None,
                  bd=None, start: int = 0) -> torch.Tensor:
    """All-experts dense compute. x (B, T, H); wg / wu (E', H, I); wd
    (E', I, H), plain or quantized; b* optional (E', ·) biases: the
    experts ``[start, start + E')`` (every expert on one card).
    Intermediates are laid out (E', B·T, ·), the reference's (B, T, E, ·)
    transposed."""
    b, t, h = x.shape
    dt = x.dtype
    n = _num_experts(wd)
    combine = combine_matrix(moe.num_experts, top_vals, top_idx)
    combine = combine.reshape(b * t, moe.num_experts)[:, start:start + n]
    if moe.input_scaled:
        # llama4: scale the expert INPUT by the affinity, combine with 1s
        xe = (x.reshape(b * t, 1, h).float()
              * combine[..., None]).to(dt).transpose(0, 1)       # (E,BT,H)
        gate = qmatmul(xe, wg)
        up = qmatmul(xe, wu)
        combine = (combine > 0).float()
    else:
        xf = x.reshape(1, b * t, h)
        gate = qmatmul(xf, wg)                                    # (E,BT,I)
        up = qmatmul(xf, wu)
    if bg is not None:
        gate = gate + bg[:, None, :]
        up = up + bu[:, None, :]
    outs = qmatmul(_glu(moe, gate, up), wd)                       # (E,BT,H)
    if bd is not None:
        outs = outs + bd[:, None, :]
    y = torch.einsum("ebh,be->bh", outs.float(), combine)
    return y.reshape(b, t, h).to(dt)


def group_ends(sorted_expert: torch.Tensor, num_experts: int
               ) -> torch.Tensor:
    """(E,) int32 end offsets of each expert's group in the ascending
    ``sorted_expert``, computed on the device (no host read)."""
    experts = torch.arange(num_experts, device=sorted_expert.device,
                           dtype=sorted_expert.dtype)
    return torch.searchsorted(sorted_expert, experts, right=True,
                              out_int32=True)


def grouped_mm(a: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """Rows [ends[e-1], ends[e]) of ``a`` (N, K) times ``w[e]`` (K, M):
    the counterpart of ``jax.lax.ragged_dot``. Rows past ``ends[-1]`` are
    not computed."""
    return torch._grouped_mm(a, w, offs=ends)


def experts_ragged(moe: MoESpec, x: torch.Tensor, top_vals: torch.Tensor,
                   top_idx: torch.Tensor, wg, wu, wd, bg=None, bu=None,
                   bd=None, start: int = 0) -> torch.Tensor:
    """Dropless grouped-product path: sort the B·T·k token copies by
    expert (stable), one grouped product per projection, unsort and
    combine in fp32. Shapes are static: N = B·T·k rows. Quantized expert
    weights are dequantized to the activation dtype first (the grouped
    product takes plain weights). With E' < E local experts ``[start,
    start + E')`` the copies routed elsewhere sort after the local groups
    (key E'), lie past the last group end and add nothing."""
    b, t, h = x.shape
    k = moe.top_k
    dt = x.dtype
    wg, wu, wd = (dequantize(w, dt) if is_quantized_leaf(w) else w
                  for w in (wg, wu, wd))
    n = wd.shape[0]
    flat_x = x.reshape(b * t, h)
    flat_expert = top_idx.reshape(-1)                         # (N,)
    flat_weight = top_vals.reshape(-1)                        # (N,) fp32
    local = None
    if n < moe.num_experts:
        key = flat_expert - start
        local = (key >= 0) & (key < n)
        flat_expert = torch.where(local, key, torch.full_like(key, n))
    order = torch.argsort(flat_expert, stable=True)
    inv = torch.argsort(order)
    sorted_expert = flat_expert[order]
    sorted_tokens = flat_x[order // k]                        # (N, H)
    ends = group_ends(sorted_expert, n)
    if moe.input_scaled:
        sorted_tokens = (sorted_tokens.float()
                         * flat_weight[order][:, None]).to(dt)
        flat_weight = torch.ones_like(flat_weight)
    if local is not None:
        sorted_expert = sorted_expert.clamp(max=n - 1)
    gate = grouped_mm(sorted_tokens, wg, ends)
    up = grouped_mm(sorted_tokens, wu, ends)
    if bg is not None:
        gate = gate + bg[sorted_expert]
        up = up + bu[sorted_expert]
    outs = grouped_mm(_glu(moe, gate, up), wd, ends)          # (N, H)
    if bd is not None:
        outs = outs + bd[sorted_expert]
    outs = outs[inv].float()
    if local is not None:
        # rows past the last group end are not computed: select, never
        # multiply (their contents are undefined)
        outs = torch.where(local[:, None], outs, torch.zeros_like(outs))
    outs = outs * flat_weight[:, None]
    y = outs.reshape(b * t, k, h).sum(dim=1).reshape(b, t, h)
    return y.to(dt)


EXPERT_LEAVES = ("expert_gate", "expert_up", "expert_down")
EXPERT_BIASES = ("expert_gate_bias", "expert_up_bias", "expert_down_bias")


def moe_block(moe: MoESpec, x: torch.Tensor, layer_w: Dict[str, Any],
              phase: str = "prefill", mesh=None) -> torch.Tensor:
    """Route + experts (+ shared experts). x (B, T, H). The dense path
    runs when B·T is at most ``dense_max_tokens``, else the ragged one.
    Over a ``mesh`` the result is the rank's partial sum (its experts and
    its shared-expert slice), to be reduced over the group by the
    caller."""
    router_bias = layer_w.get("router_bias") if moe.has_router_bias else None
    top_vals, top_idx = route(moe, x, layer_w["router"], router_bias)
    experts = (experts_dense if x.shape[0] * x.shape[1] <= moe.dense_max_tokens
               else experts_ragged)
    # the hybrid decode copy: a T = 1 step of the contiguous decode or the
    # paged path on the dense path, the copy made at load over the mesh
    tkg = (mesh is not None and moe.tkg_experts_local
           and phase in ("decode", "paged") and x.shape[1] == 1
           and experts is experts_dense and "expert_gate" + TKG in layer_w)
    suffix = TKG if tkg else ""
    ws = [layer_w[n + suffix] for n in EXPERT_LEAVES]
    biases = ([layer_w[n + suffix] for n in EXPERT_BIASES]
              if moe.expert_bias else [None, None, None])
    start = 0
    if mesh is not None:
        # the down bias is added once over the group: on tp index 0 of
        # each expert's ranks, or on the hybrid copy's index 0 (rank 0)
        if not (mesh.rank == 0 if tkg else mesh.tp_rank == 0):
            biases[2] = None
        if not tkg:
            start = mesh.ep_rank * _num_experts(ws[2])
    y = experts(moe, x, top_vals, top_idx, *ws, *biases, start=start)
    return _shared_experts(moe, x, y, layer_w)


def _shared_experts(moe: MoESpec, x: torch.Tensor, y: torch.Tensor,
                    layer_w: Dict[str, Any]) -> torch.Tensor:
    """Add the always-on shared-expert branch (DeepSeek / GLM style); over
    a mesh the rank's slice of its intermediate (a partial sum too)."""
    if moe.shared_intermediate > 0:
        act = _act_fn(moe.act)
        s = (act(qlinear(x, layer_w["shared_gate"]))
             * qlinear(x, layer_w["shared_up"]))
        y = y + qlinear(s, layer_w["shared_down"])
    return y
