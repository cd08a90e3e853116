"""Decoder over the contiguous and the paged KV cache (counterpart:
``neuronx_distributed_inference_tpu/models/model_base.py`` — ``ACT_FNS``
:66, ``DecoderSpec`` :98, ``pad_vocab`` :350, the parameter specs :360-590
(``_attn_param_specs`` :360, ``_moe_param_specs`` :478), ``fuse_qkv_host``
:618, ``attn_inputs`` :720,
``_layer_body`` :753, ``_mlp_block`` :889 (dense GLU, plain MLP, xIELU or
the MoE block),
``_attn_block`` :943-1280 (the per-head q/k RMSNorm :1014-1024, paged
:1058-1103, prefill :1104-1156, decode :1157-1272), ``run_layers`` :1296 / ``run_layer_slice`` :1414,
``run_layers_mixed_decode`` :1577, ``fold_mixed_prefill`` :1611,
``_norm`` :681, ``_embed`` :1656, ``_lm_head`` :1671,
``context_encoding_step`` :1686,
``token_generation_step`` :1789, ``token_generation_multi`` :1846,
``paged_forward_step`` :1883,
``decode_loop`` :1939, ``paged_decode_loop`` :2058,
``paged_spec_draft_loop`` :2091, ``paged_spec_verify`` :2141,
``paged_ragged_step`` :2222, ``spec_from_config`` :2346, its cache-layout
decisions :2513-2554; ``MLASpec`` :78, ``_mla_qkv`` :686;
``_add_lora_specs`` :431, ``stack_lora_host`` :641; tensor parallelism:
the spec fields ``vocab_parallel`` :234, ``collective_dtype`` /
``collective_block`` :285-286, ``param_shardings`` :661 (here each
``ParamSpec``'s ``split`` and :func:`shard_params`), ``_row_parallel_out``
:869-885, ``_embed`` :1656, ``_lm_head`` :1671).

The MLP slot is a dense GLU MLP or a routed mixture of experts
(``spec.moe``, ``modules/moe.py``). A mixed stack (DeepSeek's
``first_dense``, Llama4's interleaved ``moe_pattern``) keeps its dense
layers in ``params["layers"]`` and its MoE layers in
``params["moe_layers"]``, each in order of appearance; the layer loop
walks the layers in order, with the cache's layer index the absolute layer
(:func:`layer_plan`). Attention may alternate: with a ``layer_pattern``
(GPT-OSS, Llama4) a local layer attends within ``sliding_window`` or,
with ``attn_chunk``, within its chunk of positions, and a global layer
over the whole context. Learned
per-head sinks join every softmax denominator (``attn_sink``), and q/k/v
and o projections may carry biases. Multi-head latent attention
(``spec.mla``, DeepSeek) projects q through an optional q-LoRA and K/V
from a compressed latent plus one shared rope head; its K heads are
``head_dim`` wide and its V heads ``v_head_dim``, so the cache's V is
narrower than its K and neither kernel takes it (the gather path).

The dense families' knobs (Qwen2, Granite, Phi-3, OLMo-2, Gemma-2,
Gemma-3) shape the same layer: the MLP activation (``act``), Gemma's
(1 + w) RMSNorm on every block, final and q/k norm (``norm_offset``),
sandwich norms on the attention and MLP outputs, OLMo-2's post-norm
layer (``norm_position="post"``) with its full-width q/k norm
(``qk_norm_full``), Granite's ``residual_multiplier``, ``embed_scale``
and ``logits_divide``, the tanh soft-caps of the attention scores (into
every attention call, kernels included) and of the logits, and Gemma-3's
second rotation for its local layers (``local_rope``).

Llama4's knobs: chunked attention on the local layers (``attn_chunk``:
attend iff the query and key positions share a chunk), NoPE global layers
(``nope_global``: no rotation), the weightless q/k RMS norm after RoPE on
the local layers (``qk_l2_norm``) and the attention temperature of the
NoPE layers (``attn_temp``, from the positions on the device). DBRX's:
LayerNorm in every block norm and the final norm (``norm_type``) and the
clamp of the q/k/v projections (``qkv_clip``). No kernel takes a chunked
layer: both decode gates and the flash gate refuse ``attn_chunk``.
Phi-3.5-MoE's: a learned bias on every LayerNorm (``norm_bias``) and on
the lm-head (``lm_head_bias``); GLM-4-MoE's partial rotary is the rope's
``rotary_dim``.

The contrib dense families' (GPT-2, GPT-NeoX, Falcon, BLOOM, MPT, ...):
plain two-layer MLPs (``mlp_glu`` False, fc1 / fc2 in the gate / down
slots) and MLP biases, no rotation (``no_rope``), a learned position
table added at each step's positions (``learned_pos``), the embeddings'
LayerNorm (``embed_norm``), parallel blocks (``block_style``), GPT-1's
post-residual LayerNorms and missing final norm (``norm_position=
"post_residual"``, ``skip_final_norm``), the per-head q/k norm after RoPE
or as a LayerNorm (``qk_norm_after_rope``, ``qk_norm_type``), Apertus's
learned xIELU, and ALiBi (``alibi``: the layer's fp32 slopes times the
key positions, added to the scores of the gather paths' ``mha`` /
``mha_hl``). No kernel takes ALiBi: every kernel gate refuses it, as
the reference's do.

Multi-LoRA (``spec.lora``, ``modules/lora.py``): every targeted
projection has stacked factors ``lora_A_<mod>`` (L, max_loras, in, r) and
``lora_B_<mod>`` (L, max_loras, r, out) (none on MLA projections or an
MoE layer's MLP), and every step takes ``adapter_ids`` (B,), each row's
slot, carried to the layers in ``ai["adapter_ids"]``. Without ids a step
adds no delta at all (the LoRA-free graph); slot 0 is the zero adapter.

The contiguous cache takes one of three layouts (:func:`cache_layout`,
the reference's decisions):

  * full rows of ``seq_len`` slots, slot = position;
  * ``rolling_window``: a uniform sliding-window model above its window
    keeps ``sliding_window`` slots a row, written at ``pos % w``; the
    prefill writes only each row's last ``w`` positions, decode reads all
    slots through ``ops.attention.rolling_decode_mask`` on the gather
    path (the decode kernel addresses slot = position, so it is off);
  * ``mixed_kv``: a layer pattern above its window keeps the global
    layers' full rows in ``{"k", "v"}`` and the local layers' rolling
    rows in ``{"k_l", "v_l"}``; the prefill runs every layer on a
    full-length scratch and folds it (:func:`fold_mixed_prefill`), decode
    walks the two stacks (:func:`run_layers_mixed_decode`), the global
    layers through the decode kernel at their index within the global
    stack.

The model is a set of plain functions over a dict of parameter tensors
laid out as the JAX package's tree (stacked ``(L, …)`` layer leaves, fused
``qkv_proj``, vocabulary padded to a multiple of 128), so a JAX parameter
tree converts by renaming (``utils/jax_params.py``). The JAX ``lax.scan``
loops (over layers, over decode steps) are Python loops; the KV cache is
written IN PLACE (the JAX graphs donated it).

Tensor and expert parallelism (SPMD, one process a rank): the
application keeps the full spec (the layout the converters and the JAX
package's tree at the mesh use, resolved at ``mp = ep·tp``, every rank)
and runs each step on the rank's own spec (:func:`local_spec`): its
``num_q_heads / mp`` and ``num_kv_heads / mp`` heads, ``intermediate_size
/ mp`` MLP columns and ``padded_vocab / mp`` vocabulary rows, its experts
(``E / ep`` of them, their intermediate cut over tp) and shared-expert
columns, with the :class:`~..parallel.mesh.Mesh` whose group (all mp
ranks) runs the collectives. Every kernel gate and cache then reads local
heads. Where GSPMD puts the JAX package's collectives, the steps call
``parallel/collectives``: the row-parallel o_proj and down_proj outputs
are summed over the group (``_row_out``; the quantized ring in the decode
and paged phases under ``collective_dtype``), their biases added once
after the sum; an MoE block's partial sum (its experts and its
shared-expert slice) is summed once, by the plain all-reduce; a parallel
block sums its attention and MLP outputs each where it is made, then adds
them; the vocabulary-parallel embedding looks up the rank's rows (zero
elsewhere) and sums; the logits are gathered over the vocabulary before
the divide, the soft-cap and the padded-vocabulary mask; a full-width q/k
norm (OLMo-2, OLMoE) sums its squares over the group. MLA runs on the
rank's heads (``q_b_proj`` / ``q_proj`` and ``kv_b_proj`` cut by heads,
the latent replicated). A spec with a mesh calls the collectives at any
degree, one included (an identity over one rank).

Attention, by phase:

  * ``prefill`` (contiguous): the causal flash kernel when the spec asks
    for it (``attn_kernel_enabled``) and :func:`ops.flash_attention.supports`
    admits the bucket, else the masked ``mha``; then the window is written
    into the cache;
  * ``decode`` (contiguous): the step's K/V are written first; the
    contiguous decode kernel runs under the rule of model_base.py:1175-1197
    (static batch over the whole cache, no side buffer; on by default for
    every model it admits, where the reference's auto rule admits only
    sliding-window models), else the layer is read in its native
    layout (``read_layer_hl``, cut to ``kv_view``; rows gathered under
    continuous batching) into ``mha_hl``, or ``mha_decode_merged`` with the
    chunked side buffer of :func:`decode_loop`;
  * ``paged``: the step's K/V are written at ``slot_mapping``; a
    single-token step runs the paged decode kernel (the rule of
    model_base.py:1071-1077), every other step gathers the block table
    into contiguous K/V for the masked ``mha``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import InferenceConfig, TpuConfig
from ..modules import block_kv_cache as bkv
from ..modules import kv_cache as kv
from ..modules import low_rank as low_rank_mod
from ..modules import moe as moe_mod
from ..modules.lora import LoraSpec, apply_lora, lora_spec_from_config
from ..modules import quantization as quant_mod
from ..modules.quantization import qlinear
from ..ops import attention as attn_ops
from ..ops import decode_attention, flash_attention
from ..ops import sampling as sampling_ops
from ..ops.normalization import layer_norm, rms_norm
from ..ops.rope import (SUPPORTED_SCALING, RopeConfig, apply_rope,
                        compute_inv_freq, rope_cos_sin)
from ..parallel import collectives
from ..parallel.layers import (EP, TP_EP, GQASharding, ParamSpec,
                               column_parallel, expert_column_parallel,
                               expert_row_parallel, resolve_cuts,
                               replicated_param, resolve_gqa_sharding,
                               row_parallel, row_parallel_output,
                               vocab_parallel_embedding)
from ..resilience.errors import ConfigurationError

logger = logging.getLogger("nxdi_torch")

def xielu(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Apertus's xIELU with learned alphas (model_base.py:894-909):
    ``params`` = the layer's fp32 [alpha_p_raw, alpha_n_raw, beta, eps];
    alpha_p = softplus(alpha_p_raw), alpha_n = beta + softplus(alpha_n_raw);
    alpha_p x^2 + beta x where x > 0, else (expm1(min(x, eps)) - x) alpha_n
    + beta x, in fp32, then the cast."""
    p = params.float()
    alpha_p = F.softplus(p[0])
    beta, eps = p[2], p[3]
    alpha_n = beta + F.softplus(p[1])
    xf = x.float()
    y = torch.where(xf > 0, alpha_p * xf * xf + beta * xf,
                    (torch.expm1(torch.minimum(xf, eps)) - xf) * alpha_n
                    + beta * xf)
    return y.to(x.dtype)


ACT_FNS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="none"),
    "gelu_new": functools.partial(F.gelu, approximate="tanh"),
    "gelu_pytorch_tanh": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    # squared ReLU (nemotron / arcee plain MLPs)
    "relu2": lambda x: torch.square(F.relu(x)),
    # learned per layer: _mlp_block binds the layer's "xielu" row
    "xielu": xielu,
}


@dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention geometry (counterpart: model_base.py:78):
    K/V compressed to ``kv_lora_rank`` plus a shared rope head of
    ``qk_rope_head_dim``, Q optionally through ``q_lora_rank``. K heads are
    [nope | rope], V heads ``v_head_dim`` wide."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    q_lora_rank: Optional[int] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class DecoderSpec:
    """Static architecture of the Llama-shaped decoder, resolved from an
    InferenceConfig (the fields of the counterpart that this path
    reads)."""

    num_layers: int
    hidden_size: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int
    padded_vocab: int
    rms_eps: float
    rope: RopeConfig
    gqa: GQASharding
    tie_word_embeddings: bool = False
    sliding_window: int = 0              # 0 = full attention
    attn_scale: Optional[float] = None   # None => head_dim ** -0.5
    # flash prefill kernel: True = on where flash_attention.supports() holds
    flash_prefill: bool = False
    # decode kernels: None = default admission, True = always where
    # supports() holds, False = never
    decode_kernel: Optional[bool] = None
    dtype: torch.dtype = torch.bfloat16
    kv_dtype: torch.dtype = torch.bfloat16
    # scaled KV quantisation: values stored as x / kv_scale
    kv_scale: Optional[float] = None
    # weight-only quantization: the converted weights are {"qweight",
    # "scale"} leaf-groups (modules/quantization.py)
    quant: Optional[quant_mod.QuantSpec] = None
    # low-rank MLP: gate / up / down as {"lr_u", "lr_v"} factor pairs of
    # this rank (modules/low_rank.py)
    low_rank: Optional[low_rank_mod.LowRankSpec] = None
    # qwen3-style per-head q/k RMSNorm (after the head split, before RoPE)
    qk_norm: bool = False
    # routed mixture of experts in the MLP slot (``moe.intermediate_size``
    # is the per-expert width); with ``first_dense`` > 0 the first
    # ``first_dense`` layers keep a dense MLP of ``intermediate_size``
    moe: Optional[moe_mod.MoESpec] = None
    first_dense: int = 0
    # multi-head latent attention (DeepSeek); head_dim is then
    # mla.qk_head_dim and V heads are mla.v_head_dim wide
    mla: Optional[MLASpec] = None
    # the interleaved (GPT-NeoX pair) RoPE convention (DeepSeek's
    # rope_interleave)
    rope_interleaved: bool = False
    # per-layer attention (gpt-oss alternating sliding / full layers):
    # layer_pattern[i] True = layer i is LOCAL (attends within
    # sliding_window), False = global (whole context); None = uniform
    # (sliding_window, if set, applies to every layer)
    layer_pattern: Optional[Tuple[bool, ...]] = None
    # learned per-head softmax sinks: a (L, Hq) fp32 "sink" leaf whose
    # logit joins the softmax denominator only
    attn_sink: bool = False
    # biases of the fused q/k/v projection and of o_proj
    qkv_bias: bool = False
    o_bias: bool = False
    # the rolling cache: ``sliding_window`` slots a row, written pos % w
    rolling_window: bool = False
    # the mixed per-layer cache: local layers' rolling rows in
    # {"k_l", "v_l"}, global layers' full rows in {"k", "v"}
    mixed_kv: bool = False
    # the dense families' knobs (model_base.py:115-175): the MLP
    # activation (a key of ACT_FNS)
    act: str = "silu"
    # RMSNorm weight offset: 1.0 gives Gemma's (1 + w) on every block
    # norm, the final norm and the per-head / full-width q/k norms
    norm_offset: float = 0.0
    # Gemma's sandwich norms: post_attn_norm on the attention output,
    # post_ff_norm on the MLP output, before each residual add
    sandwich_norm: bool = False
    # "pre" (Llama) or "post" (OLMo-2: no pre-norms; the sandwich norms
    # on the block outputs)
    norm_position: str = "pre"
    # OLMo-2: RMSNorm over the whole q / k projection before the head split
    qk_norm_full: bool = False
    # Granite: each block output is scaled before its residual add, and
    # the lm-head logits divided
    residual_multiplier: float = 1.0
    logits_divide: Optional[float] = None
    # Gemma-2: tanh soft-caps of the lm-head logits and the attention
    # scores (cap * tanh(x / cap))
    logits_soft_cap: Optional[float] = None
    attn_soft_cap: Optional[float] = None
    # Gemma / Granite: the embeddings are multiplied by this (in fp32)
    embed_scale: Optional[float] = None
    # Gemma-3: the rotation of the local layers of ``layer_pattern``
    # (None: they rotate as the global ones)
    local_rope: Optional[RopeConfig] = None
    # Llama4 (model_base.py:155-170): the local layers attend within their
    # chunk of ``attn_chunk`` positions (0 = no chunking)
    attn_chunk: int = 0
    # the global layers of ``layer_pattern`` take no rotation (NoPE)
    nope_global: bool = False
    # weightless q/k RMS norm after RoPE, on the local layers only
    qk_l2_norm: bool = False
    # (floor_scale, attn_scale): the NoPE layers' q times
    # log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1
    attn_temp: Optional[Tuple[float, float]] = None
    # interleaved dense / MoE layers: moe_pattern[i] True = layer i is MoE
    moe_pattern: Optional[Tuple[bool, ...]] = None
    # DBRX (model_base.py:208, 241): "rms" or "layernorm" (bias-free) in
    # every block norm and the final norm; q/k/v clamped to +-qkv_clip
    norm_type: str = "rms"
    qkv_clip: Optional[float] = None
    # Phi-3.5-MoE (model_base.py:218, 230): the LayerNorms carry a learned
    # bias (``input_norm_b``, ``post_norm_b``, ``final_norm_b``), and the
    # untied lm-head a bias (``lm_head_b``) added to the fp32 logits
    norm_bias: bool = False
    lm_head_bias: bool = False
    # Medusa speculation heads (model_base.py:251-253): head j = a
    # ResBlock (H -> H) and its own lm head, predicting position +j+2
    medusa_heads: int = 0
    # multi-LoRA serving (model_base.py:254-256): stacked per-adapter
    # factors, each row's picked by its ``adapter_ids`` entry
    lora: Optional[LoraSpec] = None
    # the contrib dense families' knobs (model_base.py:119, :179-186,
    # :209-249): a GLU MLP act(x @ gate) * (x @ up) @ down, or with
    # ``mlp_glu`` False the plain act(x @ fc1) @ fc2 in the gate / down
    # slots; ``mlp_bias`` adds the MLP projections' biases
    mlp_glu: bool = True
    mlp_bias: bool = False
    # no rotation at all (learned-position and ALiBi models)
    no_rope: bool = False
    # a learned absolute position table of this many rows ("pos_embed"),
    # gathered at the positions (clamped to its last row) and added to the
    # token embeddings; 0 = none
    learned_pos: int = 0
    # a LayerNorm with bias over the token embeddings (BLOOM's
    # word_embeddings_layernorm: "embed_norm", "embed_norm_b")
    embed_norm: bool = False
    # no final norm before the lm-head (GPT-1's post-LN blocks end normed)
    skip_final_norm: bool = False
    # ALiBi (BLOOM, MPT): score += slope_h * (kpos - qpos) with the (L, Hq)
    # fp32 "alibi_slopes" leaf; no kernel takes such a layer
    alibi: bool = False
    # "sequential" (Llama), "parallel_shared" (one norm feeds attention
    # and the MLP: Falcon-7B, Phi, Cohere) or "parallel_dual" (the MLP's
    # own post_norm, also over the block input: GPT-NeoX, Falcon-40B)
    block_style: str = "sequential"
    # the per-head q/k norm after RoPE (HunYuan) instead of before, and its
    # kind: "rms" or "layernorm" with the biases q_norm_b / k_norm_b
    # (Persimmon)
    qk_norm_after_rope: bool = False
    qk_norm_type: str = "rms"
    # tensor parallelism (model_base.py:234, :285-286): the embedding cut on
    # its vocabulary (False: replicated); the quantized ring's wire dtype
    # ("int8" / "fp8", the decode and paged phases' row-parallel sums;
    # None: the plain all-reduce) and block
    vocab_parallel: bool = True
    collective_dtype: Optional[str] = None
    collective_block: int = 32
    # the cp axis (model_base.py:260-271): SP keeps the prefill's residual
    # stream cut on the sequence over cp between blocks; CP prefill cuts
    # the queries on the sequence over cp against the whole K/V (the
    # reference's all-gather-KV strategy); flash decoding cuts the
    # contiguous cache's slots over cp and merges each rank's partial
    # softmax. Each acts over a mesh with cp > 1 only.
    seq_parallel: bool = False
    cp_prefill: bool = False
    flash_decoding: bool = False

    # no mesh: one card (a rank's own spec, RankSpec, carries its mesh)
    mesh = None

    @property
    def scale(self) -> float:
        return (self.attn_scale if self.attn_scale is not None
                else self.head_dim ** -0.5)

    @property
    def q_size(self) -> int:
        return self.gqa.num_q_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.gqa.num_kv_heads * self.head_dim

    @property
    def v_head_dim(self) -> int:
        return self.mla.v_head_dim if self.mla is not None else self.head_dim

    def is_local(self, layer: int) -> bool:
        """Whether ``layer`` is a local layer of the ``layer_pattern``."""
        return self.layer_pattern is not None and self.layer_pattern[layer]

    def window(self, is_local: bool) -> int:
        """The sliding window of a layer (0 = none): ``sliding_window`` on
        every layer of a uniform stack; with a ``layer_pattern`` on local
        layers only (model_base.py:1071-1092)."""
        if self.layer_pattern is None or is_local:
            return self.sliding_window
        return 0


@dataclass(frozen=True)
class RankSpec(DecoderSpec):
    """One rank's own spec over a mesh (:func:`local_spec`): its heads,
    MLP columns and vocabulary rows, and the mesh whose group runs the
    step's collectives. ``gqa.tp`` is the degree the layout is cut for."""

    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def pad_vocab(vocab: int, tp: int = 1, multiple: int = 128) -> int:
    m = max(tp, 1) * multiple
    return -(-vocab // m) * m


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _moe_param_specs(spec: DecoderSpec, L: int) -> Dict[str, ParamSpec]:
    """The MoE MLP slot (model_base.py:478-505): an fp32 router (L, H, E),
    replicated; expert stacks (L, E, H, I) / (L, E, I, H) in the model
    dtype, experts cut over ep and the intermediate over tp; the optional
    biases (gate / up cut as their weights, down by experts) and shared
    experts (cut over every rank, as a dense MLP). On a rank's own spec
    the shapes are the rank's slices."""
    m = spec.moe
    H, dt = spec.hidden_size, spec.dtype
    E, Ie, Is = m.num_experts, m.intermediate_size, m.shared_intermediate
    if spec.mesh is not None:
        E, Ie, Is = E // spec.mesh.ep, Ie // spec.mesh.tp, Is // spec.mesh.mp
    layers: Dict[str, ParamSpec] = {
        "router": ParamSpec((L, H, m.num_experts), torch.float32),
        "expert_gate": expert_column_parallel((L, E, H, Ie), dt),
        "expert_up": expert_column_parallel((L, E, H, Ie), dt),
        "expert_down": expert_row_parallel((L, E, Ie, H), dt),
    }
    if m.has_router_bias:
        layers["router_bias"] = ParamSpec((L, m.num_experts), torch.float32,
                                          "zeros")
    if m.expert_bias:
        layers["expert_gate_bias"] = expert_column_parallel(
            (L, E, Ie), dt, "zeros", bias=True)
        layers["expert_up_bias"] = expert_column_parallel(
            (L, E, Ie), dt, "zeros", bias=True)
        layers["expert_down_bias"] = ParamSpec((L, E, H), dt, "zeros",
                                               ((-2, EP),))
    if Is > 0:
        layers.update({
            "shared_gate": column_parallel((L, H, Is), dt),
            "shared_up": column_parallel((L, H, Is), dt),
            "shared_down": row_parallel((L, Is, H), dt),
        })
    return layers


# the hybrid decode copy's cut of each expert leaf (moe_tkg_ep_degree=1;
# the counterpart's moe.py:326-333): every expert, the intermediate over
# (tp, ep) tp-major; the down bias whole
TKG_CUTS = {"expert_gate": ((-1, TP_EP),), "expert_up": ((-1, TP_EP),),
            "expert_down": ((-2, TP_EP),),
            "expert_gate_bias": ((-1, TP_EP),),
            "expert_up_bias": ((-1, TP_EP),), "expert_down_bias": ()}


def wants_tkg_copy(spec: DecoderSpec, mesh) -> bool:
    """Whether a rank keeps the hybrid decode copy of its expert leaves:
    ``tkg_experts_local`` over a mesh with ep > 1 (at ep 1 the stored
    layout is that copy), for plain expert weights (quantized ones keep
    the stored layout, biases included)."""
    return (mesh is not None and mesh.ep > 1 and spec.moe is not None
            and spec.moe.tkg_experts_local
            and (spec.quant is None
                 or not spec.quant.converts("expert_gate")))


def rank_leaves(spec: DecoderSpec, name: str, ps, leaf, mesh,
                cuts=None) -> Dict[str, Any]:
    """``{name: the rank's slice of a converted leaf}`` (``cuts``: the
    spec's, resolved for ``mesh``, unless given), and where
    :func:`wants_tkg_copy` a plain expert leaf's hybrid decode copy
    under ``name + "_tkg"``, cut from the same full leaf once, at load."""
    if cuts is None:
        cuts = (resolve_cuts(ps.cuts, ps.parts, mesh)
                if isinstance(ps, ParamSpec) else [])
    out = {name: quant_mod.shard_leaf(leaf, cuts)}
    if wants_tkg_copy(spec, mesh) and name in TKG_CUTS:
        out[name + moe_mod.TKG] = quant_mod.shard_leaf(
            leaf, resolve_cuts(TKG_CUTS[name], None, mesh))
    return out


def _mla_param_specs(spec: DecoderSpec, L: int) -> Dict[str, ParamSpec]:
    """The MLA projections (model_base.py:370-385): ``q_proj``, or
    ``q_a_proj`` / ``q_a_norm`` / ``q_b_proj`` through the q-LoRA, then
    ``kv_a_proj`` (latent + rope head), ``kv_a_norm``, ``kv_b_proj`` (every
    head's nope K and V) and ``o_proj`` from the V heads. Tensor
    parallelism cuts ``q_b_proj`` (or ``q_proj``) and ``kv_b_proj`` by
    heads (their output axis is head-major) and o_proj by its input rows;
    the latent projections and norms are replicated."""
    m, H, dt = spec.mla, spec.hidden_size, spec.dtype
    nh = spec.gqa.num_q_heads
    layers: Dict[str, ParamSpec] = {}
    if m.q_lora_rank:
        layers["q_a_proj"] = ParamSpec((L, H, m.q_lora_rank), dt)
        layers["q_a_norm"] = ParamSpec((L, m.q_lora_rank), dt, "ones")
        layers["q_b_proj"] = column_parallel(
            (L, m.q_lora_rank, nh * m.qk_head_dim), dt)
    else:
        layers["q_proj"] = column_parallel((L, H, nh * m.qk_head_dim), dt)
    layers.update({
        "kv_a_proj": ParamSpec(
            (L, H, m.kv_lora_rank + m.qk_rope_head_dim), dt),
        "kv_a_norm": ParamSpec((L, m.kv_lora_rank), dt, "ones"),
        "kv_b_proj": column_parallel(
            (L, m.kv_lora_rank, nh * (m.qk_nope_head_dim + m.v_head_dim)),
            dt),
        "o_proj": row_parallel((L, nh * m.v_head_dim, H), dt),
    })
    return layers


def _attn_param_specs(spec: DecoderSpec, L: int) -> Dict[str, ParamSpec]:
    """The attention half of a layer (model_base.py:360-432): norms, the
    fused q/k/v and o projections (or the MLA projections), and the
    optional norm biases, q/k norms (per head, or full width; a per-head
    LayerNorm with its biases), biases (zeros), sandwich norms, fp32 sinks
    and fp32 ALiBi slopes (zeros). Tensor parallelism cuts the fused q/k/v
    and its bias part by part by heads, o_proj by its input rows, the
    full-width q/k norms, the sinks and the ALiBi slopes by heads; the
    o_proj bias is replicated and added after the sum."""
    H, dt = spec.hidden_size, spec.dtype
    layers = {
        "input_norm": replicated_param((L, H), dt),
        "post_norm": replicated_param((L, H), dt),
    }
    if spec.norm_bias:
        layers["input_norm_b"] = replicated_param((L, H), dt, "zeros")
        layers["post_norm_b"] = replicated_param((L, H), dt, "zeros")
    parts = (spec.q_size, spec.kv_size, spec.kv_size)
    if spec.mla is not None:
        layers.update(_mla_param_specs(spec, L))
    else:
        layers["qkv_proj"] = column_parallel((L, H, sum(parts)), dt,
                                             parts=parts)
        layers["o_proj"] = row_parallel((L, spec.q_size, H), dt)
    if spec.qkv_bias:
        layers["qkv_bias"] = column_parallel((L, sum(parts)), dt, "zeros",
                                             parts)
    if spec.qk_norm:
        layers["q_norm"] = replicated_param((L, spec.head_dim), dt)
        layers["k_norm"] = replicated_param((L, spec.head_dim), dt)
    if spec.qk_norm_full:
        layers["q_norm"] = column_parallel((L, spec.q_size), dt, "ones")
        layers["k_norm"] = column_parallel((L, spec.kv_size), dt, "ones")
    if spec.qk_norm and spec.qk_norm_type == "layernorm":
        layers["q_norm_b"] = replicated_param((L, spec.head_dim), dt,
                                              "zeros")
        layers["k_norm_b"] = replicated_param((L, spec.head_dim), dt,
                                              "zeros")
    if spec.o_bias:
        layers["o_bias"] = replicated_param((L, H), dt, "zeros")
    if spec.sandwich_norm:
        layers["post_attn_norm"] = replicated_param((L, H), dt)
        layers["post_ff_norm"] = replicated_param((L, H), dt)
    if spec.attn_sink:
        layers["sink"] = column_parallel((L, spec.gqa.num_q_heads),
                                         torch.float32, "zeros")
    if spec.alibi:
        layers["alibi_slopes"] = column_parallel((L, spec.gqa.num_q_heads),
                                                 torch.float32, "zeros")
    if spec.lora is not None and spec.mla is None:
        _add_lora_specs(spec, layers, L, {
            "q_proj": (H, spec.q_size), "k_proj": (H, spec.kv_size),
            "v_proj": (H, spec.kv_size), "o_proj": (spec.q_size, H)})
    return layers


def _add_lora_specs(spec: DecoderSpec, layers: Dict[str, ParamSpec], L: int,
                    dims: Dict[str, Tuple[int, int]]) -> None:
    """Stacked adapter factors of each targeted module (model_base.py:
    431-449): A (L, max_loras, in, r) and B (L, max_loras, r, out) in the
    model dtype, zeros (every slot the zero adapter until one is
    written)."""
    lo = spec.lora
    for mod, (d_in, d_out) in dims.items():
        if not lo.targets(mod):
            continue
        layers[f"lora_A_{mod}"] = ParamSpec(
            (L, lo.max_loras, d_in, lo.rank), spec.dtype, "zeros")
        layers[f"lora_B_{mod}"] = ParamSpec(
            (L, lo.max_loras, lo.rank, d_out), spec.dtype, "zeros")


def _dense_mlp_param_specs(spec: DecoderSpec,
                           L: int) -> Dict[str, ParamSpec]:
    """The dense MLP slot (model_base.py:452-475): gate / up / down of
    ``intermediate_size`` (a plain MLP has no up: its fc1 / fc2 sit in the
    gate / down slots), their biases (zeros) under ``mlp_bias``, xIELU's
    fp32 (L, 4) [alpha_p_raw, alpha_n_raw, beta, eps] (ones), and the
    adapter factors under LoRA (:470-474; an MoE layer takes none).
    Tensor parallelism cuts gate / up and their biases by columns and down
    by rows; the down bias is replicated, added after the sum."""
    H, I, dt = spec.hidden_size, spec.intermediate_size, spec.dtype
    layers = {"gate_proj": column_parallel((L, H, I), dt),
              "down_proj": row_parallel((L, I, H), dt)}
    if spec.mlp_glu:
        layers["up_proj"] = column_parallel((L, H, I), dt)
    if spec.mlp_bias:
        layers["gate_bias"] = column_parallel((L, I), dt, "zeros")
        layers["down_bias"] = replicated_param((L, H), dt, "zeros")
        if spec.mlp_glu:
            layers["up_bias"] = column_parallel((L, I), dt, "zeros")
    if spec.act == "xielu":
        layers["xielu"] = replicated_param((L, 4), torch.float32)
    if spec.lora is not None:
        dims = {"gate_proj": (H, I), "down_proj": (I, H)}
        if spec.mlp_glu:
            dims["up_proj"] = (H, I)
        _add_lora_specs(spec, layers, L, dims)
    return layers


def decoder_param_specs(spec: DecoderSpec) -> Dict[str, Any]:
    """Shapes of the parameter tree, the counterpart's (model_base.py:
    520-549): one ``"layers"`` stack, or for a mixed stack the dense
    layers in ``"layers"`` and the MoE layers in ``"moe_layers"``
    (:func:`layer_plan`); the final norm unless ``skip_final_norm``, with
    ``norm_bias`` its bias, with ``lm_head_bias`` the untied head's (:521-
    529, :579-580); the ``learned_pos`` table ``pos_embed``, BLOOM's
    ``embed_norm`` / ``embed_norm_b``; with ``medusa_heads`` M the heads'
    ``medusa_blocks`` (M, H, H), ``medusa_bias`` (M, H) and ``medusa_lm``
    (M, H, padded vocab) (:582-587).

    On a rank's own spec (:func:`local_spec`) the shapes are the rank's
    slices: heads, MLP columns and, cut on the vocabulary, the embedding
    (under ``vocab_parallel``) and the untied head. The head's bias stays
    whole, added after the logits are gathered."""
    H, dt = spec.hidden_size, spec.dtype
    vocab = spec.padded_vocab // (spec.mesh.mp if spec.mesh is not None
                                  else 1)
    out: Dict[str, Any] = {
        "embed": (vocab_parallel_embedding(vocab, H, dt)
                  if spec.vocab_parallel
                  else ParamSpec((spec.padded_vocab, H), dt))}
    if not spec.skip_final_norm:
        out["final_norm"] = replicated_param((H,), dt)
        if spec.norm_bias:
            out["final_norm_b"] = replicated_param((H,), dt, "zeros")
    if spec.learned_pos:
        out["pos_embed"] = ParamSpec((spec.learned_pos, H), dt)
    if spec.embed_norm:
        out["embed_norm"] = replicated_param((H,), dt)
        out["embed_norm_b"] = replicated_param((H,), dt, "zeros")
    plan = layer_plan(spec)
    kinds = {key: kind for key, _, _, kind in plan}
    for key, kind in kinds.items():
        n = sum(1 for k, *_ in plan if k == key)
        out[key] = _attn_param_specs(spec, n)
        out[key].update(_dense_mlp_param_specs(spec, n) if kind == "dense"
                        else _moe_param_specs(spec, n))
    if not spec.tie_word_embeddings:
        out["lm_head"] = column_parallel((H, vocab), dt)
        if spec.lm_head_bias:
            out["lm_head_b"] = ParamSpec((spec.padded_vocab,), dt, "zeros")
    if spec.medusa_heads > 0:
        M = spec.medusa_heads
        out["medusa_blocks"] = ParamSpec((M, H, H), dt)
        out["medusa_bias"] = ParamSpec((M, H), dt, "zeros")
        out["medusa_lm"] = ParamSpec((M, H, spec.padded_vocab), dt)
    return out


def convert_leaf(spec: DecoderSpec, name: str, w: torch.Tensor) -> Any:
    """The reference's weight conversion after the fused q/k/v and the
    cast to the model dtype (application.py:127-151), for one named leaf
    on its device: factorize a low-rank MLP weight (quantizing its
    factors), then quantize what ``spec.quant`` converts; any other leaf
    is returned as it is. Conversion is leaf by leaf, so a tree converted
    a leaf at a time is the same tree, and only one unconverted leaf needs
    room beside it."""
    tree = {name: w}
    if spec.low_rank is not None:
        tree = low_rank_mod.factorize_params(tree, spec.low_rank,
                                             quant=spec.quant)
    if spec.quant is not None:
        tree = quant_mod.quantize_params(tree, spec.quant)
    return tree[name]


def init_params(spec: DecoderSpec, seed: int, device: torch.device,
                mesh=None) -> Dict[str, Any]:
    """Random weights made on ``device`` from one ``torch.Generator``
    seeded with ``seed`` (normal(0, 0.02) matrices, unit norms), each
    converted (:func:`convert_leaf`) as soon as it is drawn. They are not
    the JAX package's values for the same seed. With a ``mesh`` (``spec``
    the full spec) every rank draws each full leaf, converts it and keeps
    its slice (and its hybrid decode copy, :func:`rank_leaves`), one leaf
    at a time: a rank's shard is the slice of the tp = 1 draw wherever the
    layout pads nothing."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(node):
        out: Dict[str, Any] = {}
        for k, v in sorted(node.items()):
            if isinstance(v, ParamSpec):
                out.update(rank_leaves(spec, k, v, convert_leaf(
                    spec, k, v.initializer(gen, device)), mesh))
            else:
                out[k] = build(v)
        return out
    return build(decoder_param_specs(spec))


def _leaf_group(node) -> bool:
    return isinstance(node, dict) and ("qweight" in node or "lr_u" in node)


def shard_params(spec: DecoderSpec, params: Dict[str, Any],
                 mesh) -> Dict[str, Any]:
    """Rank ``mesh.rank``'s slice of every leaf of a converted tree laid
    out for the full ``spec`` (the counterpart's ``param_shardings`` :661
    with ``device_put``): each leaf cut on its ``ParamSpec.cuts``, a
    quantized or low-rank leaf-group by ``quantization.shard_leaf``, plus
    the hybrid decode copies (:func:`rank_leaves`)."""
    def walk(node, ps):
        out: Dict[str, Any] = {}
        for k, v in node.items():
            sub = (ps or {}).get(k)
            if isinstance(v, dict) and not _leaf_group(v):
                out[k] = walk(v, sub)
            else:
                out.update(rank_leaves(spec, k, sub, v, mesh))
        return out
    return walk(params, decoder_param_specs(spec))


def local_spec(spec: DecoderSpec, mesh) -> RankSpec:
    """A rank's own spec: ``spec`` (laid out for ``mesh.mp``, every rank)
    with its ``num_q_heads / mp`` and ``num_kv_heads / mp`` heads, its
    ``intermediate_size / mp`` MLP columns and the mesh (its experts'
    shapes follow from the mesh, :func:`_moe_param_specs`). Raises
    :class:`ConfigurationError` for a layout the degrees do not cut."""
    mp, g = mesh.mp, spec.gqa
    if g.tp != mp:
        raise ConfigurationError(f"the spec is laid out for tp={g.tp}, "
                                 f"the mesh has tp={mp}")
    cuts = [("query heads", g.num_q_heads, mp), ("KV heads", g.num_kv_heads,
                                                 mp),
            ("intermediate_size", spec.intermediate_size, mp),
            ("padded vocabulary", spec.padded_vocab, mp)]
    if spec.moe is not None:
        cuts += [("num_experts", spec.moe.num_experts, mesh.ep),
                 ("the expert intermediate", spec.moe.intermediate_size,
                  mesh.tp),
                 ("the shared-expert intermediate",
                  spec.moe.shared_intermediate, mp)]
    bad = [f"{what} {n} (over {d})" for what, n, d in cuts if n % d]
    if bad:
        raise ConfigurationError(f"the mesh (ep={mesh.ep}, tp={mesh.tp}) "
                                 "does not divide the " + ", ".join(bad))
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(DecoderSpec)}
    fields.update(
        gqa=dataclasses.replace(g, num_q_heads=g.num_q_heads // mp,
                                num_kv_heads=g.num_kv_heads // mp),
        intermediate_size=spec.intermediate_size // mp)
    return RankSpec(**fields, mesh=mesh)


def stack_lora_host(spec: DecoderSpec, host: Dict[str, Any]) -> Dict[str, Any]:
    """Backfill the stacked ``lora_A_<mod>`` / ``lora_B_<mod>`` host
    leaves a checkpoint never carries (model_base.py:641-658): a state dict
    holds the base weights only, adapters arrive at serving time, so every
    load path stacks zeroed ``(L, max_loras, ...)`` factors here (slot 0 is
    the zero adapter). A no-op without ``spec.lora`` or where the leaves
    are present already."""
    if spec.lora is None:
        return host
    for group, d in decoder_param_specs(spec).items():
        if not isinstance(d, dict) or not isinstance(host.get(group), dict):
            continue
        for k, ps in d.items():
            if k.startswith("lora_") and k not in host[group]:
                host[group][k] = np.zeros(ps.shape, np.float32)
    return host


def fuse_qkv_host(host: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse per-projection q/k/v host weights (as the family converter
    emits them, matching the checkpoint) into the stacked ``qkv_proj``, and
    their biases into ``qkv_bias`` in the same order, in each layer stack
    (model_base.py:618-637). MLA layers (a bare ``q_proj`` beside the
    compressed K/V projections) are left alone."""
    for key in ("layers", "moe_layers"):
        d = host.get(key)
        if not (isinstance(d, dict) and {"q_proj", "k_proj", "v_proj"}
                <= set(d)):
            continue
        d["qkv_proj"] = np.concatenate(
            [np.asarray(d.pop("q_proj")), np.asarray(d.pop("k_proj")),
             np.asarray(d.pop("v_proj"))], axis=-1)
        if "q_bias" in d:
            d["qkv_bias"] = np.concatenate(
                [np.asarray(d.pop("q_bias")), np.asarray(d.pop("k_bias")),
                 np.asarray(d.pop("v_bias"))], axis=-1)
    return host


# ---------------------------------------------------------------------------
# Layer stack
# ---------------------------------------------------------------------------

def attn_inputs(spec: DecoderSpec, position_ids: torch.Tensor,
                inv_freq=None) -> Dict[str, Any]:
    """RoPE cos/sin for the step; each phase adds its mask
    (:func:`_add_masks`) or kernel inputs. With ``local_rope`` the local
    layers' ``cos_l`` / ``sin_l`` too (model_base.py:727-750);
    ``inv_freq`` is then the (global, local) pair of
    :func:`rope_inv_freq`. With ``attn_temp`` the NoPE layers' query
    scale ``temp`` (:func:`attn_temp_scale`)."""
    if spec.local_rope is None:
        cos, sin = rope_cos_sin(position_ids, spec.rope, inv_freq)
        ai = {"cos": cos, "sin": sin}
    else:
        inv_g, inv_l = inv_freq if inv_freq is not None else (None, None)
        cos, sin = rope_cos_sin(position_ids, spec.rope, inv_g)
        cos_l, sin_l = rope_cos_sin(position_ids, spec.local_rope, inv_l)
        ai = {"cos": cos, "sin": sin, "cos_l": cos_l, "sin_l": sin_l}
    if spec.attn_temp is not None:
        ai["temp"] = attn_temp_scale(spec.attn_temp, position_ids)
    return ai


def attn_temp_scale(attn_temp: Tuple[float, float],
                    position_ids: torch.Tensor) -> torch.Tensor:
    """Llama4's attention temperature (model_base.py:1046-1056): fp32
    log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1, (B, T, 1, 1),
    computed from the positions on their device, so a replayed decode
    graph takes each replay's positions."""
    floor_scale, a_scale = attn_temp
    pos = position_ids.float()
    return (torch.log1p(torch.floor((pos + 1.0) / floor_scale)) * a_scale
            + 1.0)[:, :, None, None]


def qk_l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama4's weightless q/k norm (model_base.py:1034-1045): despite
    its name an RMS norm with no weight, x * rsqrt(mean(x^2) + eps) in
    fp32, then the cast."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
            ).to(x.dtype)


def _add_masks(spec: DecoderSpec, ai, make_mask) -> None:
    """``ai["mask"] = make_mask(window, chunk)`` at the uniform window and
    chunk; with a ``layer_pattern`` the global mask ``make_mask(0, 0)`` and
    the local ``ai["mask_l"] = make_mask(sliding_window, attn_chunk)``
    (model_base.py:720-750). Each layer picks its own
    (:func:`_layer_mask`)."""
    if spec.layer_pattern is None:
        ai["mask"] = make_mask(spec.sliding_window, spec.attn_chunk)
    else:
        ai["mask"] = make_mask(0, 0)
        ai["mask_l"] = make_mask(spec.sliding_window, spec.attn_chunk)


def _layer_mask(ai, is_local: bool):
    return ai["mask_l"] if is_local else ai["mask"]


def _sink(spec: DecoderSpec, layer_w):
    return layer_w["sink"] if spec.attn_sink else None


def _qk_head_norm(spec: DecoderSpec, q, k, layer_w):
    """The per-head q/k norm (model_base.py:1014-1033): RMSNorm with
    ``norm_offset``, or with ``qk_norm_type`` "layernorm" a LayerNorm with
    the ``q_norm_b`` / ``k_norm_b`` biases (Persimmon)."""
    if spec.qk_norm_type == "layernorm":
        return (layer_norm(q, layer_w["q_norm"], layer_w["q_norm_b"],
                           spec.rms_eps),
                layer_norm(k, layer_w["k_norm"], layer_w["k_norm_b"],
                           spec.rms_eps))
    off = spec.norm_offset
    return (rms_norm(q, layer_w["q_norm"], spec.rms_eps, off),
            rms_norm(k, layer_w["k_norm"], spec.rms_eps, off))


def _qkv(spec: DecoderSpec, h, layer_w, ai, is_local: bool = False):
    """Fused projection, the rows' adapter deltas (``ai["adapter_ids"]``),
    the q/k/v clamp, q/k norms (the per-head one before RoPE, or after it
    with ``qk_norm_after_rope``), head split and RoPE,
    then Llama4's q/k norm and temperature: q (B,T,Hq,D), k/v (B,T,Hkv,D)
    (v a view into the projection output unless clamped). A local layer
    rotates with ``ai["cos_l"]`` when the step carries it, a NoPE global
    layer and a ``no_rope`` model not at all (Python branches: a captured
    graph holds each layer's own)."""
    b, t, _ = h.shape
    g = spec.gqa
    off = spec.norm_offset
    qkv = qlinear(h, layer_w["qkv_proj"])
    if spec.qkv_bias:
        qkv = qkv + layer_w["qkv_bias"]
    q, k, v = torch.split(qkv, [spec.q_size, spec.kv_size, spec.kv_size],
                          dim=-1)
    # the adapters' deltas land on the split projections, before every
    # norm, clamp and rotation (model_base.py:989-997)
    aids = ai.get("adapter_ids")
    q = apply_lora(spec.lora, layer_w, "q_proj", h, q, aids)
    k = apply_lora(spec.lora, layer_w, "k_proj", h, k, aids)
    v = apply_lora(spec.lora, layer_w, "v_proj", h, v, aids)
    if spec.qk_norm_full:
        # RMSNorm over the whole projection, before the head split
        # (model_base.py:998-1001)
        q = _full_width_norm(spec, q, layer_w["q_norm"])
        k = _full_width_norm(spec, k, layer_w["k_norm"])
    if spec.qkv_clip is not None:
        # DBRX's clip_qkv (model_base.py:1002-1005)
        c = spec.qkv_clip
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    q = q.reshape(b, t, g.num_q_heads, spec.head_dim)
    k = k.reshape(b, t, g.num_kv_heads, spec.head_dim)
    if spec.qk_norm and not spec.qk_norm_after_rope:
        q, k = _qk_head_norm(spec, q, k, layer_w)
    # with a layer pattern Llama4's knobs split the layers: the local ones
    # rotate and take the q/k norm, the global ones are NoPE and take the
    # temperature; a uniform stack takes both knobs on every layer
    rotated = spec.layer_pattern is None or is_local
    if not spec.no_rope and (rotated or not spec.nope_global):
        cos, sin = ((ai["cos_l"], ai["sin_l"]) if is_local and "cos_l" in ai
                    else (ai["cos"], ai["sin"]))
        q = apply_rope(q, cos, sin, spec.rope_interleaved)
        k = apply_rope(k, cos, sin, spec.rope_interleaved)
    if spec.qk_norm and spec.qk_norm_after_rope:
        q, k = _qk_head_norm(spec, q, k, layer_w)
    if spec.qk_l2_norm and rotated:
        q, k = qk_l2_norm(q, spec.rms_eps), qk_l2_norm(k, spec.rms_eps)
    if spec.attn_temp is not None and (spec.layer_pattern is None
                                       or not is_local):
        q = (q.float() * ai["temp"]).to(q.dtype)
    return q, k, v.reshape(b, t, g.num_kv_heads, spec.head_dim)


def _full_width_norm(spec: DecoderSpec, x, w):
    """OLMo-2's RMSNorm over a whole q or k projection. Over a mesh a rank
    holds its heads' slice of it: the sum of squares is summed over the
    group and divided by the full width."""
    if spec.mesh is None:
        return rms_norm(x, w, spec.rms_eps, spec.norm_offset)
    xf = x.float()
    ss = collectives.all_reduce((xf * xf).sum(dim=-1, keepdim=True),
                                spec.mesh)
    xf = xf * torch.reciprocal(torch.sqrt(ss / (x.shape[-1] * spec.mesh.mp)
                                          + spec.rms_eps))
    return (xf * (w.float() + spec.norm_offset)).to(x.dtype)


def _row_out(spec: DecoderSpec, x, w, phase: str):
    """An o_proj or down_proj product (model_base.py:869-885). Over a mesh
    ``x`` and ``w`` are the rank's slice of the contraction and the
    product is summed over the group: by the quantized ring in the decode
    and paged phases under ``collective_dtype``, else (prefill, or no
    wire dtype) by the plain all-reduce; a low-rank leaf sums its rank-r
    intermediate."""
    if spec.mesh is None:
        return qlinear(x, w)
    wire = (spec.collective_dtype if phase in ("decode", "paged")
            else None)
    return row_parallel_output(x, w, spec.mesh, collective_dtype=wire,
                               collective_block=spec.collective_block)


def _mla_qkv(spec: DecoderSpec, h, layer_w, ai):
    """Multi-head latent attention projections (model_base.py:686-717): q
    through the optional q-LoRA, K/V from the compressed latent through
    ``kv_b_proj``, and one rope head per token rotated once and broadcast
    over the heads. q/k (B,T,Hq,qk_head_dim), v (B,T,Hq,v_head_dim)."""
    m = spec.mla
    nh = spec.gqa.num_q_heads
    b, t, _ = h.shape
    if m.q_lora_rank:
        qa = rms_norm(qlinear(h, layer_w["q_a_proj"]), layer_w["q_a_norm"],
                      spec.rms_eps)
        q = qlinear(qa, layer_w["q_b_proj"])
    else:
        q = qlinear(h, layer_w["q_proj"])
    q = q.reshape(b, t, nh, m.qk_head_dim)
    q_nope, q_rot = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                dim=-1)
    ckv = qlinear(h, layer_w["kv_a_proj"])                  # (B,T,r+rope)
    k_pass, k_rot = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_head_dim],
                                dim=-1)
    kv_heads = qlinear(rms_norm(k_pass, layer_w["kv_a_norm"], spec.rms_eps),
                       layer_w["kv_b_proj"]).reshape(
                           b, t, nh, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv_heads, [m.qk_nope_head_dim, m.v_head_dim],
                            dim=-1)
    q_rot = apply_rope(q_rot, ai["cos"], ai["sin"], spec.rope_interleaved)
    k_rot = apply_rope(k_rot[:, :, None, :], ai["cos"], ai["sin"],
                       spec.rope_interleaved)               # (B,T,1,rope)
    q = torch.cat([q_nope, q_rot], dim=-1)
    k = torch.cat([k_nope, k_rot.expand(b, t, nh, m.qk_rope_head_dim)],
                  dim=-1)
    return q, k, v


def _alibi_for(slopes, n_kv: int, device):
    """The gather paths' ALiBi input (model_base.py:980-985): the layer's
    slopes and the key positions of a contiguous or gathered view, whose
    slot i holds position i; None without ALiBi."""
    if slopes is None:
        return None
    return slopes, torch.arange(n_kv, device=device)[None, :]


# ---------------------------------------------------------------------------
# The dp and cp axes (model_base.py:700-708, :814-861, :1006-1013)
# ---------------------------------------------------------------------------

def _cp_on(spec: DecoderSpec) -> bool:
    """True over a mesh whose cp axis has more than one rank."""
    return spec.mesh is not None and spec.mesh.cp > 1


def cp_bounds(spec: DecoderSpec, t: int) -> Tuple[int, int, List[int]]:
    """(lo, hi, sizes): this cp rank's sequence chunk [lo, hi) of ``t``
    and every rank's chunk size (rank i takes [i·t // cp, (i+1)·t // cp):
    a ``t`` that cp does not divide gives chunks one apart, as GSPMD pads
    an uneven cut)."""
    cp, c = spec.mesh.cp, spec.mesh.cp_rank
    edges = [i * t // cp for i in range(cp + 1)]
    return edges[c], edges[c + 1], [edges[i + 1] - edges[i]
                                     for i in range(cp)]


def gather_seq(spec: DecoderSpec, x: torch.Tensor, t: int) -> torch.Tensor:
    """Every cp rank's sequence chunk of ``x`` (B, chunk, ...) -> the
    whole sequence (B, t, ...), in cp order (one all-gather over the cp
    group; uneven chunks travel padded to the largest)."""
    _, _, sizes = cp_bounds(spec, t)
    top = max(sizes)
    if x.shape[1] < top:
        x = torch.cat([x, x.new_zeros((x.shape[0], top - x.shape[1],
                                       *x.shape[2:]))], dim=1)
    every = collectives.gather_dim(x, spec.mesh, "cp", 1)
    if all(n == top for n in sizes):
        return every
    return torch.cat([every[:, i * top:i * top + n]
                      for i, n in enumerate(sizes)], dim=1)


def _fd_on(spec: DecoderSpec) -> bool:
    """Flash decoding over a cp axis of more than one rank: the
    contiguous cache holds this rank's share of every row's slots."""
    return spec.flash_decoding and _cp_on(spec)


def _fd_local(spec: DecoderSpec, positions: torch.Tensor,
              slots: int) -> torch.Tensor:
    """Positions -> this cp rank's slots under flash decoding: a position
    in [cp_rank·slots, (cp_rank + 1)·slots) lands at its offset, every
    other at ``slots`` (dropped by the cache writes)."""
    local = positions.long() - spec.mesh.cp_rank * slots
    return torch.where((local >= 0) & (local < slots), local,
                       torch.full_like(local, slots))


def _fd_merge(spec: DecoderSpec, o, m, l_sum, sink, dtype):
    """The flash-decoding merge over the cp ranks by log-sum-exp: the
    global max M, each shard's output and sum rescaled by exp(m - M) and
    summed over cp, the sink (once, not once a shard) added to the
    denominator (model_base.py:1157-1272 under ``k_pspec``'s cp cut)."""
    mesh = spec.mesh
    big = collectives.all_reduce(m.clone(), mesh, "cp", op="max")
    if sink is not None:
        big = torch.maximum(big, sink.float())
    w = torch.exp(m - big)
    both = collectives.all_reduce(
        torch.cat([o * w[..., None], (l_sum * w)[..., None]], dim=-1),
        mesh, "cp")
    den = both[..., -1]
    if sink is not None:
        den = den + torch.exp(sink.float() - big)
    return (both[..., :-1] / den[..., None]).to(dtype)


def dp_rows(spec: DecoderSpec, b: int) -> Optional[slice]:
    """This dp replica's rows of a paged step of ``b`` rows, as the
    reference's mesh wrappers cut them (``b % dp == 0``, decode_attention
    :296-298): [dp_rank·b/dp, (dp_rank+1)·b/dp). None = the whole batch
    on every replica (no dp axis, or a batch dp does not divide)."""
    m = spec.mesh
    if m is None or m.dp == 1 or b % m.dp:
        return None
    n = b // m.dp
    return slice(m.dp_rank * n, (m.dp_rank + 1) * n)


def rows_of(x, rows, b: int):
    """A per-row input's ``rows`` (a slice or an index array) of a tensor
    or numpy array with ``b`` leading rows; None and shared inputs pass
    through."""
    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == b:
        return x[rows if isinstance(rows, slice)
                 else torch.as_tensor(rows, device=x.device)]
    if isinstance(x, np.ndarray) and x.ndim and x.shape[0] == b:
        return x[rows]
    return x


def _gather_rows(spec: DecoderSpec, out: Dict[str, Any]) -> Dict[str, Any]:
    """A step's outputs over the dp replicas' rows, concatenated in
    replica order (one all-gather over dp each)."""
    return {k: collectives.gather_dim(v, spec.mesh, "dp", 0)
            for k, v in out.items()}


def _paged_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai, sink,
                is_local: bool, slopes=None):
    """Paged branch (model_base.py:1058-1103): write at ``slot_mapping``,
    then the paged kernel (the layer's window as a Python int, the
    soft-cap, the sink) or the block-table gather + ``mha`` (with the
    ALiBi ``slopes`` over the gathered positions, :1100-1103)."""
    kc, vc = cache["k"], cache["v"]
    kw, vw, slots = k, v, ai["slot_mapping"]
    if ai.get("dp_slots") is not None:
        # the pages are the same on every dp replica (the block cache has
        # no dp axis, block_kv_cache.py:64-65) and the host's allocator
        # and prefix cache are global: every replica writes every row's
        # K/V, gathered over dp
        kw = collectives.gather_dim(k, spec.mesh, "dp", 0)
        vw = collectives.gather_dim(v, spec.mesh, "dp", 0)
        slots = ai["dp_slots"]
    bkv.write_slots_at_layer(kc, kv.quantize_kv(kw, kc.dtype, spec.kv_scale),
                             li, slots)
    bkv.write_slots_at_layer(vc, kv.quantize_kv(vw, vc.dtype, spec.kv_scale),
                             li, slots)
    if ai["use_kernel"]:
        # the step's own token was just written, but the kernel masks
        # kpos < lens strictly and folds the token in from new_k/new_v
        return decode_attention.paged_decode_attention(
            q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
            v[:, 0].contiguous(), li, ai["lens"], ai["block_table"],
            scale=spec.scale, window=spec.window(is_local),
            soft_cap=spec.attn_soft_cap, sink=sink,
            kv_scale=spec.kv_scale)[:, None]
    bt = ai["block_table"]
    k_all = kv.dequantize_kv(bkv.gather_block_kv(bkv.read_layer(kc, li), bt),
                             q.dtype, spec.kv_scale)
    v_all = kv.dequantize_kv(bkv.gather_block_kv(bkv.read_layer(vc, li), bt),
                             q.dtype, spec.kv_scale)
    return attn_ops.mha(q, k_all, v_all, _layer_mask(ai, is_local),
                        spec.scale, logits_soft_cap=spec.attn_soft_cap,
                        sink=sink,
                        alibi=_alibi_for(slopes, k_all.shape[1], q.device))


def _prefill_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai, sink,
                  is_local: bool, slopes=None):
    """Contiguous prefill branch (model_base.py:1104-1156): attend within
    the window (flash kernel or masked ``mha``, whose ALiBi keys sit at
    the window's own positions, :1126-1131), then write the window
    into the cache rows ``seq_ids``. On the rolling cache only each row's
    last ``w`` positions land, at ``pos % w``; padded positions past the
    row's length are dropped (:1132-1146)."""
    if ai["flash"]:
        out = flash_attention.flash_attention(q, k, v, scale=spec.scale,
                                              window=spec.sliding_window,
                                              soft_cap=spec.attn_soft_cap)
    else:
        out = attn_ops.mha(q, k, v, _layer_mask(ai, is_local), spec.scale,
                           logits_soft_cap=spec.attn_soft_cap, sink=sink,
                           alibi=(None if slopes is None
                                  else (slopes, ai["positions"])))
    if spec.rolling_window:
        w = cache["k"].shape[4]
        pos = ai["positions"].long()
        lens = ai["prefill_lens"].long()[:, None]
        keep = (pos >= lens - w) & (pos < lens)
        eff = torch.where(keep, torch.remainder(pos, w),
                          torch.full_like(pos, w + 1))
    if _fd_on(spec):
        # flash decoding: this cp rank's slots hold positions
        # [cp_rank·S_c, (cp_rank + 1)·S_c) of every row
        sc = cache["v"].shape[3]
        lo = spec.mesh.cp_rank * sc
        k, v = k[:, lo:lo + sc], v[:, lo:lo + sc]
    for name, x, kt in (("k", k, True), ("v", v, False)):
        c = cache[name]
        x = kv.quantize_kv(x, c.dtype, spec.kv_scale)
        if spec.rolling_window:
            kv.write_tokens_at_layer(c, x, li, ai["seq_ids"], eff,
                                     k_transposed=kt)
        else:
            kv.write_prefill_at_layer(c, x, li, ai["seq_ids"],
                                      identity_seq_ids=ai["identity"],
                                      k_transposed=kt)
    return out


def _decode_attn(spec: DecoderSpec, q, k, v, cache, li: int, ai, sink,
                 is_local: bool, slopes=None):
    """Contiguous decode branch (model_base.py:1157-1272). Returns the
    attention output and, under the chunked side buffer, the step's
    (k, v) for the end-of-step side write. On the rolling cache and a
    local layer of the mixed cache (whose ``cache`` is the local stack)
    the writes go to ``pos % w`` and the gather path reads every slot (the
    decode kernel addresses slot = position); a global layer of the mixed
    cache is a layer of the global stack ``li``."""
    mixed_local = spec.mixed_kv and is_local
    kc, vc = cache["k"], cache["v"]
    side = ai.get("side")
    if side is None:
        roll_w = kc.shape[4] if (spec.rolling_window or mixed_local) else 0
        pos = ai.get("fd_positions", ai["positions"])
        kv.write_tokens_at_layer(kc, kv.quantize_kv(k, kc.dtype,
                                                    spec.kv_scale),
                                 li, ai["seq_ids"], pos,
                                 window=roll_w, k_transposed=True)
        kv.write_tokens_at_layer(vc, kv.quantize_kv(v, vc.dtype,
                                                    spec.kv_scale),
                                 li, ai["seq_ids"], pos,
                                 window=roll_w)
    if ai["use_kernel"] and not mixed_local:
        # the cache row just written is masked out (kpos < pos); the
        # active token is folded in from registers
        out = decode_attention.decode_attention_stacked(
            q[:, 0].contiguous(), kc, vc, k[:, 0].contiguous(),
            v[:, 0].contiguous(), li, ai["lens"], scale=spec.scale,
            window=spec.window(is_local), soft_cap=spec.attn_soft_cap,
            sink=sink, kv_scale=spec.kv_scale)[:, None]
        return out, None
    view = None if mixed_local else ai.get("kv_view")
    k_layer = kv.read_layer_hl(kc, li)                 # (B, H, D, S)
    v_layer = kv.read_layer_hl(vc, li)                 # (B, H, S, D)
    if view is not None and view < vc.shape[3]:
        k_layer = k_layer[..., :view]
        v_layer = v_layer[:, :, :view]
    if not (ai["identity"] and q.shape[0] == kc.shape[1]):
        k_layer = kv.gather_cache_rows(k_layer, ai["seq_ids"])
        v_layer = kv.gather_cache_rows(v_layer, ai["seq_ids"])
    k_all = kv.dequantize_kv(k_layer, q.dtype, spec.kv_scale)
    v_all = kv.dequantize_kv(v_layer, q.dtype, spec.kv_scale)
    if side is not None:
        out = attn_ops.mha_decode_merged(
            q, k_all, v_all, ai["mask"], side[0][li], side[1][li],
            ai["mask_side"], k.to(q.dtype), v.to(q.dtype), spec.scale,
            logits_soft_cap=spec.attn_soft_cap, sink=sink)
        return out, (k, v)
    if "fd_positions" in ai:
        # flash decoding: this shard's partial softmax, merged over cp
        n = v_all.shape[2]
        al = (None if slopes is None else
              (slopes, torch.arange(ai["fd_offset"], ai["fd_offset"] + n,
                                    device=q.device)[None, :]))
        o, m, l_sum = attn_ops.mha_hl_partial(
            q, k_all, v_all, _layer_mask(ai, is_local), spec.scale,
            logits_soft_cap=spec.attn_soft_cap, alibi=al)
        return _fd_merge(spec, o, m, l_sum, sink, q.dtype), None
    return attn_ops.mha_hl(q, k_all, v_all, _layer_mask(ai, is_local),
                           spec.scale, logits_soft_cap=spec.attn_soft_cap,
                           sink=sink,
                           alibi=_alibi_for(slopes, v_all.shape[2],
                                            q.device)), None


def _mlp_block(spec: DecoderSpec, x, layer_w, phase: str, kind: str,
               adapter_ids=None):
    """The MLP half of a layer (model_base.py:889-940): the MoE block in a
    layer of the ``"moe"`` stack, else the dense GLU act(x @ gate) *
    (x @ up) @ down, or with ``mlp_glu`` False the plain act(x @ fc1) @ fc2
    (fc1 / fc2 in the gate / down slots), with ``ACT_FNS[spec.act]`` (xIELU
    from the layer's learned ``xielu`` row) and, under ``mlp_bias``, each
    projection's bias. Each product goes through ``qlinear`` (plain,
    quantized or low-rank weights) plus, with ``adapter_ids``, its rows'
    adapter deltas (:915-938; an MoE layer takes none). ``kind`` is the
    layer's (:func:`layer_plan`), a Python value, so a captured graph
    holds each layer's own branch."""
    if kind == "moe":
        if spec.mesh is None:
            return moe_mod.moe_block(spec.moe, x, layer_w, phase=phase)
        # the rank's partial sum (its experts, its shared-expert slice),
        # reduced once over the group: a plain fp all-reduce, never the
        # quantized ring (model_base.py:869-885 sends only o_proj and the
        # dense down_proj through it)
        return collectives.all_reduce(moe_mod.moe_block(
            spec.moe, x, layer_w, phase=phase, mesh=spec.mesh), spec.mesh)
    lo = spec.lora
    act = ACT_FNS[spec.act]
    if spec.act == "xielu":
        act = functools.partial(act, params=layer_w["xielu"])
    gate = apply_lora(lo, layer_w, "gate_proj", x,
                      qlinear(x, layer_w["gate_proj"]), adapter_ids)
    if spec.mlp_bias:
        gate = gate + layer_w["gate_bias"]
    if spec.mlp_glu:
        up = apply_lora(lo, layer_w, "up_proj", x,
                        qlinear(x, layer_w["up_proj"]), adapter_ids)
        if spec.mlp_bias:
            up = up + layer_w["up_bias"]
        inter = act(gate) * up
    else:
        inter = act(gate)
    y = apply_lora(lo, layer_w, "down_proj", inter,
                   _row_out(spec, inter, layer_w["down_proj"], phase),
                   adapter_ids)
    if spec.mlp_bias:
        y = y + layer_w["down_bias"]
    return y


def _norm(spec: DecoderSpec, x, w, b=None):
    """A block or final norm (model_base.py:678-683): RMSNorm with
    ``norm_offset``, or with ``norm_type`` "layernorm" a LayerNorm, with
    the bias ``b`` (Phi-3.5-MoE) or without (DBRX)."""
    if spec.norm_type == "layernorm":
        return layer_norm(x, w, b, spec.rms_eps)
    return rms_norm(x, w, spec.rms_eps, spec.norm_offset)


def _layer_body(spec: DecoderSpec, hidden, layer_w, cache, li: int, ai,
                phase: str, kind: str, layer: Optional[int] = None):
    """One transformer layer (model_base.py:798-862); returns (hidden,
    pending side write or None). Pre-norm, or with ``norm_position``
    "post" no pre-norm; the sandwich norms on the attention and MLP
    outputs; each block output scaled by ``residual_multiplier`` before
    its residual add; every block norm through :func:`_norm`, the pre-norms
    with their biases under ``norm_bias`` (:799, :826). Layer
    ``layer`` (default ``li``) takes its own window, mask and rotation
    (local or global, model_base.py:1327) and its sink; ``li`` addresses
    its rows in ``cache`` (on the mixed cache, its index within its own
    stack). ``kind`` ("dense" / "moe") picks its MLP; MLA or the fused
    q/k/v picks its projections (model_base.py:987-988). With
    ``ai["adapter_ids"]`` every targeted projection adds its rows' adapter
    deltas (q/k/v in :func:`_qkv`, o_proj before ``o_bias``, the MLP's in
    :func:`_mlp_block`; MLA projections take none).

    A parallel ``block_style`` adds both blocks to the block input in one
    residual, the MLP fed from the attention's norm ("parallel_shared") or
    from its own ``post_norm`` over the block input ("parallel_dual");
    ``norm_position`` "post_residual" (GPT-1) normalises after each
    residual add, ``input_norm`` after the attention's and ``post_norm``
    after the MLP's (:820-849).

    Under CP prefill (``ai["cp_seq"]`` = this cp rank's query chunk
    [lo, hi) of t) the rank attends its chunk's queries against the whole
    K/V and the output is gathered over cp on the sequence; under SP
    ``hidden`` is the chunk itself (norms, residuals and the MLP run on
    it; its K/V are gathered over cp before attention)."""
    pre = spec.norm_position == "pre"
    is_local = spec.is_local(li if layer is None else layer)
    h = (_norm(spec, hidden, layer_w["input_norm"],
               layer_w.get("input_norm_b") if spec.norm_bias else None)
         if pre else hidden)
    attn_in = h
    if spec.mla is not None:
        q, k, v = _mla_qkv(spec, h, layer_w, ai)
    else:
        q, k, v = _qkv(spec, h, layer_w, ai, is_local)
    pending = None
    cp_seq = ai.get("cp_seq") if phase == "prefill" else None
    if cp_seq is not None:
        # CP prefill: this rank's query chunk against the whole K/V; under
        # SP the chunk's K/V are gathered over cp (model_base.py:1006-1013)
        lo, hi, t_all = cp_seq
        if spec.seq_parallel:
            k, v = gather_seq(spec, k, t_all), gather_seq(spec, v, t_all)
        else:
            q = q[:, lo:hi]
    args = (spec, q, k, v, cache, li, ai, _sink(spec, layer_w), is_local,
            layer_w["alibi_slopes"] if spec.alibi else None)
    if phase == "decode":
        attn, pending = _decode_attn(*args)
    elif phase == "prefill":
        attn = _prefill_attn(*args)
    else:
        attn = _paged_attn(*args)
    if cp_seq is not None and not spec.seq_parallel:
        attn = gather_seq(spec, attn, cp_seq[2])
    b, t = h.shape[:2]
    attn = attn.reshape(b, t, -1)
    aids = ai.get("adapter_ids")
    o = apply_lora(spec.lora, layer_w, "o_proj", attn,
                   _row_out(spec, attn, layer_w["o_proj"], phase), aids)
    if spec.o_bias:
        o = o + layer_w["o_bias"]
    if spec.sandwich_norm:
        o = _norm(spec, o, layer_w["post_attn_norm"])
    if spec.block_style != "sequential":
        mlp_in = (attn_in if spec.block_style == "parallel_shared"
                  else _norm(spec, hidden, layer_w["post_norm"],
                             layer_w.get("post_norm_b") if spec.norm_bias
                             else None))
        m = _mlp_block(spec, mlp_in, layer_w, phase, kind, aids)
        return hidden + _residual_scaled(spec, o + m), pending
    if spec.norm_position == "post_residual":
        hidden = _norm(spec, hidden + o, layer_w["input_norm"],
                       layer_w.get("input_norm_b") if spec.norm_bias
                       else None)
        m = _mlp_block(spec, hidden, layer_w, phase, kind, aids)
        return _norm(spec, hidden + m, layer_w["post_norm"],
                     layer_w.get("post_norm_b") if spec.norm_bias
                     else None), pending
    hidden = hidden + _residual_scaled(spec, o)
    h = (_norm(spec, hidden, layer_w["post_norm"],
               layer_w.get("post_norm_b") if spec.norm_bias else None)
         if pre else hidden)
    m = _mlp_block(spec, h, layer_w, phase, kind, aids)
    if spec.sandwich_norm:
        m = _norm(spec, m, layer_w["post_ff_norm"])
    return hidden + _residual_scaled(spec, m), pending


def _residual_scaled(spec: DecoderSpec, x):
    """A block output times ``residual_multiplier`` (no product at 1.0,
    where it is exact)."""
    m = spec.residual_multiplier
    return x if m == 1.0 else m * x


def layer_plan(spec: DecoderSpec) -> List[Tuple[str, int, int, str]]:
    """(tree key, absolute layer, index in its stack, MLP kind) for every
    layer in order: one ``"layers"`` stack; a mixed stack's
    ``first_dense`` dense layers then its ``"moe_layers"``
    (model_base.py:1347-1366); or an interleaved ``moe_pattern``
    (:1368-1400), dense layers from ``"layers"`` and MoE layers from
    ``"moe_layers"``, each stack's layers in order of appearance (an
    all-MoE pattern has no ``"layers"``)."""
    L = spec.num_layers
    if spec.moe is None:
        is_moe = [False] * L
    elif spec.moe_pattern is not None:
        is_moe = list(spec.moe_pattern)
    else:
        is_moe = [i >= spec.first_dense for i in range(L)]
    split = spec.moe is not None and (spec.moe_pattern is not None
                                      or spec.first_dense > 0)
    plan, used = [], {}
    for i, m in enumerate(is_moe):
        key = "moe_layers" if split and m else "layers"
        plan.append((key, i, used.get(key, 0), "moe" if m else "dense"))
        used[key] = used.get(key, 0) + 1
    return plan


def _layer_slice(w, j: int):
    """Layer ``j`` of a stacked leaf; a quantized or low-rank leaf-group
    slices each of its tensors."""
    if isinstance(w, dict):
        return {k: _layer_slice(v, j) for k, v in w.items()}
    return w[j]


def iter_layers(spec: DecoderSpec, params):
    """(absolute layer index, its weights as views into its stack, MLP
    kind) for every layer in order."""
    for key, i, j, kind in layer_plan(spec):
        yield i, _layer_slice(params[key], j), kind


def run_layers(spec: DecoderSpec, params, cache, hidden, ai, phase: str):
    """The layer loop (the counterpart scans stacked weights with
    ``lax.scan``; here each layer's weights are views into the stacks, and
    the cache's layer index is the absolute layer).
    Under the chunked side buffer (``ai["side"]``), every layer's step
    K/V land in the side buffers at ``ai["chunk_idx"]`` once the whole
    step has read them (model_base.py:1459-1472)."""
    pend = []
    for i, layer_w, kind in iter_layers(spec, params):
        hidden, pending = _layer_body(spec, hidden, layer_w, cache, i, ai,
                                      phase, kind)
        pend.append(pending)
    side = ai.get("side")
    if side is not None:
        idx = ai["chunk_idx"]
        sk, sv = side
        sk[..., idx] = torch.stack([p[0][:, 0] for p in pend]).to(sk.dtype)
        sv[:, :, :, idx] = torch.stack([p[1][:, 0] for p in pend]).to(
            sv.dtype)
    return hidden


def run_layers_mixed_decode(spec: DecoderSpec, params, cache, hidden, ai):
    """The decode layer loop over the mixed cache (model_base.py:1577):
    local layers read and write the rolling ``{"k_l", "v_l"}`` stacks
    with ``mask_l``, global layers the full ``{"k", "v"}`` stacks with
    ``kv_view`` (and the decode kernel where admitted), each at its index
    within its own stack. Non-identity ``seq_ids`` (continuous batching)
    gather the reads and scatter the writes on both kinds."""
    lmap = kv.mixed_layer_map(spec.layer_pattern)
    local = {"k": cache["k_l"], "v": cache["v_l"]}
    for i, layer_w, kind in iter_layers(spec, params):
        hidden, _ = _layer_body(spec, hidden, layer_w,
                                local if spec.is_local(i) else cache,
                                lmap[i], ai, "decode", kind, layer=i)
    return hidden


def fold_mixed_prefill(spec: DecoderSpec, scratch, cache, seq_lens,
                       seq_ids=None) -> None:
    """The mixed-cache prefill epilogue (model_base.py:1611), in place:
    the global layers' scratch rows land in the full stacks at slots
    [0, sb), the local layers' rows are folded into the rolling stacks.
    ``seq_ids`` (b,): the continuous-batching target rows; None = rows
    [0, b)."""
    pat = spec.layer_pattern
    dev = scratch["k"].device
    gi = torch.tensor([i for i, x in enumerate(pat) if not x], device=dev)
    li = torch.tensor([i for i, x in enumerate(pat) if x], device=dev)
    w = cache["k_l"].shape[4]
    kl = kv.fold_rolling_prefill(scratch["k"][li], seq_lens, w,
                                 k_transposed=True)
    vl = kv.fold_rolling_prefill(scratch["v"][li], seq_lens, w)
    b, sb = scratch["k"].shape[1], scratch["k"].shape[4]
    rows = slice(0, b) if seq_ids is None else seq_ids.long()
    cache["k"][:, rows, :, :, :sb] = scratch["k"][gi].to(cache["k"].dtype)
    cache["v"][:, rows, :, :sb] = scratch["v"][gi].to(cache["v"].dtype)
    cache["k_l"][:, rows] = kl.to(cache["k_l"].dtype)
    cache["v_l"][:, rows] = vl.to(cache["v_l"].dtype)


def _embed(spec: DecoderSpec, params, input_ids, position_ids=None):
    """The token embeddings (model_base.py:1656-1668), times
    ``embed_scale`` in fp32 and cast back, then BLOOM's ``embed_norm``
    LayerNorm, then with ``learned_pos`` the position table's rows at
    ``position_ids`` clamped to [0, learned_pos - 1]. A learned-position
    spec without ``position_ids`` raises, where the reference adds no row
    (the position-less calls in its speculation). Over a mesh with
    ``vocab_parallel`` each rank looks up the ids in its rows (zero
    elsewhere) and the rows are summed over the group, before the scale,
    the norm and the positions."""
    if spec.mesh is not None and spec.vocab_parallel:
        table = params["embed"]
        rows = table.shape[0]
        local = input_ids.long() - spec.mesh.rank * rows
        hit = (local >= 0) & (local < rows)
        h = table[local.clamp(0, rows - 1)].masked_fill(~hit[..., None], 0)
        h = collectives.all_reduce(h, spec.mesh)
    else:
        h = params["embed"][input_ids.long()]
    if spec.embed_scale is not None:
        h = (h.float() * spec.embed_scale).to(h.dtype)
    if spec.embed_norm:
        h = layer_norm(h, params["embed_norm"], params["embed_norm_b"],
                       spec.rms_eps)
    if spec.learned_pos:
        if position_ids is None:
            raise ValueError("a learned position table needs position_ids")
        h = h + params["pos_embed"][
            position_ids.long().clamp(0, spec.learned_pos - 1)]
    return h


def _lm_head(spec: DecoderSpec, params, hidden):
    """fp32 logits (model_base.py:1671-1684): the final norm
    (:func:`_norm`, with ``final_norm_b`` where the tree has it; none with
    ``skip_final_norm``), the product, the ``lm_head_b`` bias in fp32,
    ``logits_divide``, the ``logits_soft_cap``, then the padded vocabulary
    masked. Over a mesh the product is the rank's vocabulary columns,
    gathered over the group (in the model dtype) before the rest."""
    h = (hidden if spec.skip_final_norm else
         _norm(spec, hidden, params["final_norm"],
               params.get("final_norm_b")))
    w = (params["embed"].t() if spec.tie_word_embeddings
         else params["lm_head"])
    y = h @ w
    if spec.mesh is not None and (spec.vocab_parallel
                                  or not spec.tie_word_embeddings):
        y = collectives.all_gather(y, spec.mesh)
    logits = y.float()
    if spec.lm_head_bias and "lm_head_b" in params:
        logits = logits + params["lm_head_b"].float()
    if spec.logits_divide:
        logits = logits / spec.logits_divide
    if spec.logits_soft_cap:
        cap = spec.logits_soft_cap
        logits = cap * torch.tanh(logits / cap)
    return sampling_ops.mask_padded_logits(
        logits, spec.padded_vocab - spec.vocab_size)


def _cache_ok(spec: DecoderSpec, cache_dtype: torch.dtype) -> bool:
    return (cache_dtype == spec.dtype
            or decode_attention.quantized_cache_ok(cache_dtype))


# ---------------------------------------------------------------------------
# Contiguous steps
# ---------------------------------------------------------------------------

def use_flash_prefill(spec: DecoderSpec, bucket: int) -> bool:
    """The prefill branch's kernel gate (model_base.py:1110-1118): no
    layer pattern, no sink (the kernel takes one static window and no
    sink), no ALiBi (the kernel has no position bias), no MLA (its K and V
    differ in width) and no chunked attention (the kernel masks by window,
    not by chunk), and neither CP prefill nor SP (:1115-1116); the
    contiguous prefill always feeds arange positions."""
    return (spec.flash_prefill and spec.layer_pattern is None
            and not spec.attn_sink and not spec.alibi and spec.mla is None
            and not spec.cp_prefill and not spec.seq_parallel
            and flash_attention.supports(bucket, spec.head_dim,
                                         has_sink=False,
                                         chunk=spec.attn_chunk))


def use_contiguous_decode_kernel(spec: DecoderSpec, phase_t: int,
                                 batch: int, cache,
                                 identity_seq_ids: bool,
                                 side: bool = False) -> bool:
    """The decode branch's kernel admission, model_base.py:1175-1197: no
    side buffer, no ALiBi, not disabled, supported geometry, not the
    rolling cache,
    static batch over the whole cache, a cache dtype the kernel streams,
    no flash decoding (:1186).
    On the mixed cache it admits the global stack's layers (``cache["k"]``);
    the rolling local layers keep the gather path.

    By default (``decode_kernel`` None) the port takes the kernel wherever
    it is admitted, full attention included: a deliberate difference from
    the reference, whose auto rule (:1187-1197) keeps plain full attention
    on the XLA path from a TPU measurement. On the H100 the Mistral-7B
    geometry's decode step (32/8 heads, D 128, batch 4, window = seq_len,
    so full attention) took 10.95 ms with the kernel and 11.74 ms on the
    gather + ``mha_hl`` path, both replaying CUDA graphs (PERF.md)."""
    return (not side and not spec.alibi and spec.decode_kernel is not False
            and decode_attention.supports(spec, phase_t)
            and not spec.rolling_window and not spec.flash_decoding
            and identity_seq_ids and batch == cache["k"].shape[1]
            and _cache_ok(spec, cache["k"].dtype))


def _sample_out(spec: DecoderSpec, tpu_cfg: TpuConfig, params, hidden,
                last_h, sampling_params, generator, coupled=None):
    """The step's outputs: the sampled token of ``last_h`` (B, 1, H) and,
    with ``output_logits``, the logits of every column of ``hidden``.
    ``coupled`` = (row seeds, sampled positions) switches to the
    positionally coupled draw."""
    out = {}
    if tpu_cfg.output_logits:
        out["logits"] = _lm_head(spec, params, hidden)[..., :spec.vocab_size]
    logits = _lm_head(spec, params, last_h)[:, 0, :]
    if coupled is not None:
        out["tokens"] = sampling_ops.coupled_sample(
            logits, tpu_cfg.on_device_sampling_config, sampling_params,
            *coupled)
    else:
        out["tokens"] = sampling_ops.sample(
            logits, tpu_cfg.on_device_sampling_config, sampling_params,
            generator)
    return out


def context_encoding_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                          cache, input_ids, position_ids, seq_ids, seq_lens,
                          sampling_params=None, generator=None,
                          inv_freq: Optional[torch.Tensor] = None,
                          adapter_ids: Optional[torch.Tensor] = None):
    """Prefill (model_base.py:1686). input_ids/position_ids (B, S_bucket)
    right-padded with arange positions; seq_ids (B,) cache rows; seq_lens
    (B,) true lengths. Writes the cache in place; returns {"tokens": (B,),
    "last_hidden": (B, H)} (the last real position's hidden state, which
    feeds the Medusa heads and the EAGLE draft, :1770-1776), plus
    {"logits": (B, S_bucket, vocab)} when ``output_logits`` and
    {"hidden_states": (B, S_bucket, H)} when ``output_full_hidden``
    (:1780-1781). ``adapter_ids`` (B,): each row's LoRA slot (None: no
    adapter delta at all, the graph of a LoRA-free build).

    On the mixed cache every layer prefills into a full-length scratch
    (identity rows), which :func:`fold_mixed_prefill` then folds into the
    two stacks at the real rows (:1747-1769)."""
    b, s = input_ids.shape
    sp = spec.seq_parallel and _cp_on(spec)
    if _cp_on(spec):
        # CP prefill / SP: this cp rank's chunk [lo, hi) of the queries
        # (model_base.py:1009-1011, :1730-1733)
        lo, hi, _ = cp_bounds(spec, s)
        q_pos = position_ids[:, lo:hi]
        ai = attn_inputs(spec, q_pos if sp else position_ids, inv_freq)
        ai["flash"] = False
        ai["cp_seq"] = (lo, hi, s)
        _add_masks(spec, ai, lambda w, c: attn_ops.causal_mask(
            q_pos, position_ids, w, c))
    else:
        ai = attn_inputs(spec, position_ids, inv_freq)
        ai["flash"] = use_flash_prefill(spec, s)
    if not ai["flash"] and "mask" not in ai:
        # padded positions attend causally to themselves: harmless, their
        # outputs are discarded
        _add_masks(spec, ai, lambda w, c: attn_ops.prefill_causal_mask(
            position_ids, w, c))
    ai.update(seq_ids=seq_ids, positions=position_ids, prefill_lens=seq_lens,
              identity=not tpu_cfg.is_continuous_batching,
              adapter_ids=adapter_ids)
    persistent = cache
    if spec.mixed_kv:
        g = spec.gqa
        kdt = cache["k"].dtype
        cache = {"k": torch.zeros((spec.num_layers, b, g.num_kv_heads,
                                   spec.head_dim, s), dtype=kdt,
                                  device=input_ids.device),
                 "v": torch.zeros((spec.num_layers, b, g.num_kv_heads, s,
                                   spec.v_head_dim), dtype=kdt,
                                  device=input_ids.device)}
        ai["identity"] = True
    if sp:
        # SP: the residual stream is this rank's sequence chunk from the
        # embedding to the last block, then gathered for the lm head
        hidden = gather_seq(spec, run_layers(
            spec, params, cache, _embed(spec, params, input_ids[:, lo:hi],
                                        q_pos), ai, "prefill"), s)
    else:
        hidden = run_layers(spec, params, cache,
                            _embed(spec, params, input_ids, position_ids),
                            ai, "prefill")
    if spec.mixed_kv:
        fold_mixed_prefill(spec, cache, persistent, seq_lens,
                           seq_ids if tpu_cfg.is_continuous_batching
                           else None)
        del cache           # the scratch goes before the lm_head's logits
    idx = (seq_lens.long() - 1).clamp(min=0)[:, None, None].expand(
        -1, 1, hidden.shape[-1])
    last_h = torch.gather(hidden, 1, idx)
    out = _sample_out(spec, tpu_cfg, params, hidden, last_h,
                      sampling_params, generator)
    out["last_hidden"] = last_h[:, 0, :]
    if tpu_cfg.output_full_hidden:
        out["hidden_states"] = hidden
    return out


def _decode_inputs(spec: DecoderSpec, tpu_cfg: TpuConfig, cache,
                   position_ids, seq_ids, kv_view, inv_freq, side=None,
                   adapter_ids=None, identity: Optional[bool] = None):
    """Inputs of a decode step: RoPE, rows, the kernel decision and its
    lengths, the masks. The rolling cache's mask maps slots back to the
    positions they hold; the mixed cache adds the local stack's rolling
    ``mask_l`` (model_base.py:1806-1830). Every mask is built on the
    device from ``position_ids``. ``identity``: the caller's host-side
    word that ``seq_ids`` are the identity over the whole cache (default:
    a static batch is, continuous batching is not)."""
    if identity is None:
        identity = not tpu_cfg.is_continuous_batching
    ai = attn_inputs(spec, position_ids, inv_freq)
    fd = _fd_on(spec)
    if fd:
        # flash decoding reads every slot of this rank's shard
        kv_view = None
    ai.update(seq_ids=seq_ids, positions=position_ids, identity=identity,
              kv_view=kv_view, side=side, adapter_ids=adapter_ids)
    ai["use_kernel"] = use_contiguous_decode_kernel(
        spec, position_ids.shape[1], position_ids.shape[0], cache, identity,
        side is not None)
    cache_len = kv_view or kv.cache_len_of(cache)
    if fd:
        off = spec.mesh.cp_rank * cache_len
        ai["fd_offset"] = off
        ai["fd_positions"] = _fd_local(spec, position_ids, cache_len)
        _add_masks(spec, ai, lambda w, c: attn_ops.decode_mask(
            position_ids, cache_len, w, c, offset=off))
    elif ai["use_kernel"]:
        ai["lens"] = position_ids[:, 0].to(torch.int32).contiguous()
    elif spec.rolling_window:
        ai["mask"] = attn_ops.rolling_decode_mask(position_ids, cache_len)
    elif spec.mixed_kv:
        ai["mask"] = attn_ops.decode_mask(position_ids, cache_len, 0)
    else:
        _add_masks(spec, ai, lambda w, c: attn_ops.decode_mask(
            position_ids, cache_len, w, c))
    if spec.mixed_kv:
        ai["mask_l"] = attn_ops.rolling_decode_mask(position_ids,
                                                    cache["k_l"].shape[4])
    return ai


def token_generation_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                          cache, input_ids, position_ids, seq_ids,
                          sampling_params=None, generator=None,
                          kv_view: Optional[int] = None,
                          inv_freq: Optional[torch.Tensor] = None,
                          adapter_ids: Optional[torch.Tensor] = None,
                          identity: Optional[bool] = None):
    """Decode (model_base.py:1789). input_ids/position_ids (B, T); seq_ids
    (B,) cache rows; adapter_ids (B,) the rows' LoRA slots or None. ``kv_view``: the gather path reads only cache slots
    [0, kv_view) (of the global stack on the mixed cache); writes address
    the whole cache. ``identity``: see :func:`_decode_inputs`. Writes the
    cache in place; returns {"tokens": (B,)} plus {"logits": (B, T,
    vocab)}."""
    ai = _decode_inputs(spec, tpu_cfg, cache, position_ids, seq_ids,
                        kv_view, inv_freq, adapter_ids=adapter_ids,
                        identity=identity)
    hidden = _embed(spec, params, input_ids, position_ids)
    if spec.mixed_kv:
        hidden = run_layers_mixed_decode(spec, params, cache, hidden, ai)
    else:
        hidden = run_layers(spec, params, cache, hidden, ai, "decode")
    return _sample_out(spec, tpu_cfg, params, hidden, hidden[:, -1:],
                       sampling_params, generator)


def token_generation_multi(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                           cache, input_ids, position_ids, seq_ids,
                           inv_freq: Optional[torch.Tensor] = None,
                           adapter_ids: Optional[torch.Tensor] = None):
    """A T-token decode step that returns the logits of every position
    (model_base.py:1846-1874): the step of windowed context encoding and
    the target verify of fused speculation (``models/speculation.py``).
    input_ids / position_ids (B, T); positions at or past the cache write
    nothing. The step's K/V are written first, then every query attends
    the cache through the position mask (the gather path: T > 1 takes no
    kernel; at T = 1 the decode kernel's gate decides, as for
    :func:`token_generation_step`). Returns {"logits_all": (B, T,
    vocab), "hidden": (B, T, H)} (the hidden states before the final
    norm, which Medusa and EAGLE read)."""
    if spec.mixed_kv:
        raise NotImplementedError(
            "multi-token decode over the mixed per-layer cache is not "
            "supported; disable speculation or set mixed_kv=False")
    ai = _decode_inputs(spec, tpu_cfg, cache, position_ids, seq_ids, None,
                        inv_freq, adapter_ids=adapter_ids)
    hidden = run_layers(spec, params, cache,
                        _embed(spec, params, input_ids, position_ids), ai,
                        "decode")
    return {"logits_all": _lm_head(spec, params, hidden)[
        ..., :spec.vocab_size], "hidden": hidden}


def decode_loop(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                first_tokens, position_ids, seq_ids, sampling_params=None,
                generator=None, num_steps: int = 1,
                kv_view: Optional[int] = None,
                inv_freq: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None):
    """``num_steps`` decode steps with the tokens kept on the device
    (model_base.py:1939). first_tokens/position_ids (B,); adapter_ids (B,)
    the rows' LoRA slots or None. Returns
    {"tokens": (B, num_steps)}.

    Full-attention models without sinks, chunks or ALiBi (the merged
    core takes no position bias) under a static batch over the whole
    cache take the chunked side-buffer branch
    (:1964-2038): the big cache is only read during the chunk; each
    step's K/V go to small side buffers, committed with ``commit_chunk``
    once at the end. Everything else steps through
    :func:`token_generation_step`."""
    b = first_tokens.shape[0]
    no_logits = dataclasses.replace(tpu_cfg, output_logits=False)
    chunkable = (num_steps > 1 and not tpu_cfg.is_continuous_batching
                 and b == cache["k"].shape[1]
                 and not spec.rolling_window
                 and not spec.flash_decoding
                 and spec.decode_kernel is not True
                 and not spec.alibi
                 and not (spec.attn_sink or spec.sliding_window > 0
                          or spec.layer_pattern is not None
                          or spec.attn_chunk > 0))
    tok, pos = first_tokens, position_ids.long()
    toks = []
    if not chunkable:
        for _ in range(num_steps):
            tok = token_generation_step(
                spec, no_logits, params, cache, tok[:, None], pos[:, None],
                seq_ids, sampling_params, generator, kv_view,
                inv_freq, adapter_ids)["tokens"]
            toks.append(tok)
            pos = pos + 1
        return {"tokens": torch.stack(toks, dim=1)}

    c = num_steps
    g = spec.gqa
    dev = first_tokens.device
    sk = torch.zeros((spec.num_layers, b, g.num_kv_heads, spec.head_dim, c),
                     dtype=spec.dtype, device=dev)
    sv = torch.zeros((spec.num_layers, b, g.num_kv_heads, c,
                      spec.v_head_dim), dtype=spec.dtype, device=dev)
    start = pos
    cache_len = kv_view or kv.cache_len_of(cache)
    slots = torch.arange(cache_len, device=dev)[None, None, :]
    side_pos = start[:, None] + torch.arange(c, device=dev)[None, :]
    cols = torch.arange(c, device=dev)[None, None, :]
    for idx in range(c):
        pos2 = pos[:, None]
        ai = _decode_inputs(spec, tpu_cfg, cache, pos2, seq_ids, kv_view,
                            inv_freq, side=(sk, sv), adapter_ids=adapter_ids)
        ai["mask"] = ai["mask"] & (slots < start[:, None, None])
        # the active token (side slot idx) is folded in from registers;
        # its side write lands at the end of the step
        ai["mask_side"] = (attn_ops.causal_mask(pos2, side_pos,
                                                spec.sliding_window,
                                                spec.attn_chunk)
                           & (cols != idx))
        ai["chunk_idx"] = idx
        hidden = run_layers(spec, params, cache,
                            _embed(spec, params, tok[:, None], pos2), ai,
                            "decode")
        tok = _sample_out(spec, no_logits, params, hidden, hidden,
                          sampling_params, generator)["tokens"]
        toks.append(tok)
        pos = pos + 1
    kv.commit_chunk(cache["k"], kv.quantize_kv(sk, cache["k"].dtype,
                                               spec.kv_scale),
                    seq_ids, start, k_transposed=True)
    kv.commit_chunk(cache["v"], kv.quantize_kv(sv, cache["v"].dtype,
                                               spec.kv_scale),
                    seq_ids, start)
    return {"tokens": torch.stack(toks, dim=1)}


# ---------------------------------------------------------------------------
# Paged steps
# ---------------------------------------------------------------------------

def use_decode_kernel(spec: DecoderSpec, phase_t: int,
                      cache_dtype: torch.dtype) -> bool:
    """The paged branch's kernel admission (model_base.py:1071-1077): a
    single token, no ALiBi, not disabled, a supported geometry and a cache
    dtype the kernel streams."""
    return (phase_t == 1 and not spec.alibi
            and spec.decode_kernel is not False
            and decode_attention.supports(spec, 1)
            and _cache_ok(spec, cache_dtype))


def _paged_hidden(spec: DecoderSpec, params, cache, input_ids, position_ids,
                  slot_mapping, block_table, inv_freq, adapter_ids=None,
                  dp_slots=None):
    """The layer stack over the paged cache: the step's K/V land at
    ``slot_mapping``; a T = 1 step runs the paged kernel, a wider one the
    block-table gather + ``mha`` (model_base.py:1071-1077); with
    ``adapter_ids`` each row adds its LoRA slot's deltas. ``dp_slots``:
    this dp replica's rows are a part of the step, whose every row's K/V
    land at these slots on every replica."""
    t = input_ids.shape[1]
    ai = attn_inputs(spec, position_ids, inv_freq)
    ai["adapter_ids"] = adapter_ids
    ai["dp_slots"] = dp_slots
    ai["use_kernel"] = use_decode_kernel(spec, t, cache["k"].dtype)
    ai["slot_mapping"] = slot_mapping
    ai["block_table"] = block_table
    if ai["use_kernel"]:
        ai["lens"] = position_ids[:, 0].to(torch.int32).contiguous()
        ai["block_table"] = block_table.to(torch.int32).contiguous()
    else:
        kv_len = block_table.shape[1] * cache["k"].shape[2]
        _add_masks(spec, ai, lambda w, c: attn_ops.decode_mask(
            position_ids, kv_len, w, c))
    return run_layers(spec, params, cache,
                      _embed(spec, params, input_ids, position_ids), ai,
                      "paged")


def _gather_cols(hidden, cols):
    """hidden (B, T, H), cols (B,) -> (B, 1, H) at each row's column."""
    idx = cols.long()[:, None, None].expand(-1, 1, hidden.shape[-1])
    return torch.gather(hidden, 1, idx)


def _coupled_mode(tpu_cfg: TpuConfig, row_seeds) -> bool:
    """True when the positionally coupled stream is active
    (model_base.py:1873): the config opts in (``do_sample`` +
    ``stream_seed``) AND the caller threaded per-row seeds."""
    sc = tpu_cfg.on_device_sampling_config
    return (row_seeds is not None and sc is not None and sc.do_sample
            and sc.stream_seed is not None)


def paged_forward_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                       input_ids, position_ids, slot_mapping, block_table,
                       last_idx, sampling_params=None, generator=None,
                       inv_freq: Optional[torch.Tensor] = None,
                       row_seeds=None, adapter_ids=None, dp_slots=None):
    """One paged step: paged prefill, prefix-cached or chunked prefill
    (T = window at arbitrary positions) and paged decode (T = 1).

    input_ids, position_ids, slot_mapping (B, T) (negative slot = no
    write); block_table (B, max_blocks); last_idx (B,) index into T of the
    token whose logits are sampled — all tensors on the cache's device.
    row_seeds (B,) per-request seeds: with a ``stream_seed`` config the
    token is the coupled draw keyed by the ABSOLUTE position of the
    sampled token. adapter_ids (B,): the rows' LoRA slots (model_base.py:
    1905-1909), None for a LoRA-free step. Writes the cache in place;
    returns {"tokens": (B,) int32} plus {"logits": (B, T, vocab)} when
    ``tpu_cfg.output_logits``.

    Over a mesh with dp > 1 and a batch dp divides, each replica runs
    its rows (:func:`dp_rows`) and samples them (``sample_dp``), every
    replica writes every row's K/V, and the outputs are gathered over
    dp; any other batch runs whole on every replica."""
    b = input_ids.shape[0]
    rows = None if dp_slots is not None else dp_rows(spec, b)
    if rows is not None:
        sub = [rows_of(x, rows, b) for x in (
            input_ids, position_ids, slot_mapping, block_table, last_idx,
            sampling_params)]
        return _gather_rows(spec, paged_forward_step(
            spec, tpu_cfg, params, cache, *sub, generator,
            inv_freq, rows_of(row_seeds, rows, b),
            rows_of(adapter_ids, rows, b), dp_slots=slot_mapping))
    hidden = _paged_hidden(spec, params, cache, input_ids, position_ids,
                           slot_mapping, block_table, inv_freq, adapter_ids,
                           dp_slots)
    coupled = None
    if _coupled_mode(tpu_cfg, row_seeds):
        pos_last = torch.gather(position_ids, 1,
                                last_idx.long()[:, None])[:, 0]
        coupled = (row_seeds, pos_last)
    return _sample_out(spec, tpu_cfg, params, hidden,
                       _gather_cols(hidden, last_idx), sampling_params,
                       generator, coupled)


EMIT_NONE, EMIT_LAST, EMIT_VERIFY = 0, 1, 2


def _verify_target(spec: DecoderSpec, tpu_cfg: TpuConfig, params, hidden,
                   position_ids, sampling_params, row_seeds):
    """The target's choice at every column of a verify window: the
    coupled draw under a seeded sampled config, else the argmax — the
    same choice the eager paged step makes at each position."""
    logits = _lm_head(spec, params, hidden)
    if _coupled_mode(tpu_cfg, row_seeds):
        return sampling_ops.coupled_sample(
            logits, tpu_cfg.on_device_sampling_config, sampling_params,
            row_seeds, position_ids)
    return sampling_ops.greedy_sample(logits)


def _accepted(input_ids, target, widths):
    """Exact-match acceptance (model_base.py:2199-2208): draft j (column
    j + 1) is accepted while it equals the target at column j; columns
    past a row's width are forced mismatches. Returns n_acc (B,)."""
    b, w = input_ids.shape
    if w == 1:
        return torch.zeros((b,), dtype=torch.long, device=input_ids.device)
    col = torch.arange(1, w, device=input_ids.device)[None, :]
    mismatch = ((input_ids[:, 1:] != target[:, :-1])
                | (col >= widths[:, None])).to(torch.int32)
    return (torch.cumsum(mismatch, dim=1) == 0).sum(dim=1)


def paged_spec_verify(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                      input_ids, position_ids, slot_mapping, block_table,
                      widths, sampling_params=None, row_seeds=None,
                      inv_freq: Optional[torch.Tensor] = None,
                      want_hidden: bool = False, adapter_ids=None,
                      dp_slots=None):
    """The speculative verify step (model_base.py:2141-2220): every
    candidate of a (B, W) window in one paged forward, then exact-match
    acceptance. input_ids (B, W): column 0 each row's last accepted token,
    columns 1.. its drafts (a device tensor: drafts never visit the host);
    position_ids, slot_mapping (B, W), columns at or past a row's width at
    slot -1; widths (B,) in [1, W]. One bonus token is always emitted, so
    the emitted tokens are the target's own choices at consecutive
    positions, whatever was drafted. Writes the cache in place; returns
    {"tokens": (B, W) int32 (0 past ``num_emitted``), "num_emitted":
    (B,) int32}, plus {"hidden": (B, W, H)} with ``want_hidden`` (the
    verified features the Medusa and EAGLE proposers read, :2217).
    ``adapter_ids`` (B,): the rows' LoRA slots or None. Rows over dp as
    :func:`paged_forward_step` takes them."""
    b = input_ids.shape[0]
    rows = None if dp_slots is not None else dp_rows(spec, b)
    if rows is not None:
        sub = [rows_of(x, rows, b) for x in (
            input_ids, position_ids, slot_mapping, block_table, widths,
            sampling_params, row_seeds)]
        return _gather_rows(spec, paged_spec_verify(
            spec, tpu_cfg, params, cache, *sub, inv_freq=inv_freq,
            want_hidden=want_hidden,
            adapter_ids=rows_of(adapter_ids, rows, b),
            dp_slots=slot_mapping))
    hidden = _paged_hidden(spec, params, cache, input_ids, position_ids,
                           slot_mapping, block_table, inv_freq, adapter_ids,
                           dp_slots)
    target = _verify_target(spec, tpu_cfg, params, hidden, position_ids,
                            sampling_params, row_seeds)
    n_acc = _accepted(input_ids, target, widths)
    col = torch.arange(input_ids.shape[1], device=hidden.device)[None, :]
    tokens = torch.where(col <= n_acc[:, None], target,
                         torch.zeros_like(target))
    out = {"tokens": tokens, "num_emitted": (n_acc + 1).to(torch.int32)}
    if want_hidden:
        out["hidden"] = hidden
    return out


def paged_ragged_step(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                      input_ids, position_ids, slot_mapping, block_table,
                      widths, emit_modes, sampling_params=None,
                      generator=None, inv_freq: Optional[torch.Tensor] = None,
                      verify: bool = False, row_seeds=None,
                      want_hidden: bool = False, adapter_ids=None,
                      dp_slots=None):
    """The ragged unified step (model_base.py:2222-2328): one paged
    forward whose rows mix decode steps (width 1), prefill chunks (width
    n at the row's own offset) and verify windows (width k+1).

    input_ids, position_ids, slot_mapping (B, W) (columns at or past a
    row's width carry slot -1: no write; their positions still feed RoPE
    and the mask, as in the reference); block_table (B, max_blocks);
    widths, emit_modes (B,) — all tensors on the cache's device. Per row,
    ``emit_modes`` selects what is emitted:

      * 0 — nothing (an intermediate prefill chunk, a frozen row);
      * 1 — the sample at column ``widths - 1``, through the sampling
        call :func:`paged_forward_step` makes;
      * 2 — exact-match acceptance over the window (as
        :func:`paged_spec_verify`): ``n_acc + 1`` tokens (the accepted
        drafts and the bonus) are emitted.

    row_seeds (B,) switches both the emit-1 sample and the verify target
    to the coupled draw under a ``stream_seed`` config. ``verify`` must
    be True when any row has mode 2: the caller decides it on the host
    from its numpy ``emit_modes``. Only then are the logits of every
    column computed (at W = 512 and a 128K vocabulary they are ~1 GB of
    fp32 that the other modes do not need), and the emit-1 rows take
    their sample from the same target. Writes the cache in place; returns
    {"tokens": (B, W) int32 (0 past ``num_emitted``), "num_emitted":
    (B,) int32}, plus {"hidden": (B, W, H)} with ``want_hidden``
    (:2326-2327). ``adapter_ids`` (B,): each row gathers its own LoRA
    slot's factors (:2261-2265); None keeps the step LoRA-free. Rows over
    dp as :func:`paged_forward_step` takes them (a mixed step of prefill
    chunks and decode rows takes the same rule)."""
    b, w = input_ids.shape
    rows = None if dp_slots is not None else dp_rows(spec, b)
    if rows is not None:
        sub = [rows_of(x, rows, b) for x in (
            input_ids, position_ids, slot_mapping, block_table, widths,
            emit_modes, sampling_params)]
        return _gather_rows(spec, paged_ragged_step(
            spec, tpu_cfg, params, cache, *sub, generator=generator,
            inv_freq=inv_freq, verify=verify,
            row_seeds=rows_of(row_seeds, rows, b), want_hidden=want_hidden,
            adapter_ids=rows_of(adapter_ids, rows, b),
            dp_slots=slot_mapping))
    hidden = _paged_hidden(spec, params, cache, input_ids, position_ids,
                           slot_mapping, block_table, inv_freq, adapter_ids,
                           dp_slots)
    emit = emit_modes.to(torch.int32)
    last = (widths.long() - 1).clamp(min=0)
    coupled = _coupled_mode(tpu_cfg, row_seeds)
    sc = tpu_cfg.on_device_sampling_config
    if not (verify and coupled):
        logits = _lm_head(spec, params, _gather_cols(hidden, last))[:, 0, :]
        sampled = (sampling_ops.coupled_sample(
            logits, sc, sampling_params, row_seeds,
            torch.gather(position_ids, 1, last[:, None])[:, 0])
            if coupled else sampling_ops.sample(logits, sc, sampling_params,
                                                generator))
    if verify:
        target = _verify_target(spec, tpu_cfg, params, hidden, position_ids,
                                sampling_params, row_seeds)
        if coupled:
            sampled = torch.gather(target, 1, last[:, None])[:, 0]
    zero = torch.zeros((), dtype=torch.int32, device=hidden.device)
    col = torch.arange(w, device=hidden.device)[None, :]
    tokens = torch.where((col == 0) & (emit == EMIT_LAST)[:, None],
                         sampled[:, None], zero)
    n_emit = (emit == EMIT_LAST).to(torch.int32)
    if verify:
        n_acc = _accepted(input_ids, target, widths)
        rows = (emit == EMIT_VERIFY)
        tokens = torch.where(rows[:, None],
                             torch.where(col <= n_acc[:, None], target, zero),
                             tokens)
        n_emit = torch.where(rows, (n_acc + 1).to(torch.int32), n_emit)
    out = {"tokens": tokens, "num_emitted": n_emit}
    if want_hidden:
        out["hidden"] = hidden
    return out


def _slot_of(block_table, rows, pos, bs):
    return block_table.long()[rows, pos // bs] * bs + pos % bs


def paged_decode_loop(spec: DecoderSpec, tpu_cfg: TpuConfig, params, cache,
                      first_tokens, position_ids, block_table,
                      sampling_params=None, generator=None,
                      num_steps: int = 1,
                      inv_freq: Optional[torch.Tensor] = None,
                      row_seeds=None, adapter_ids=None):
    """``num_steps`` paged decode steps with no host round trip between
    them: each step's slot comes from the (pre-extended) block table on the
    device, and each sampled token feeds the next step on the device. The
    host must pre-allocate blocks covering [p, p + num_steps).

    first_tokens (B,); position_ids (B,); block_table (B, max_blocks).
    Returns {"tokens": (B, num_steps) int32}."""
    bs = cache["k"].shape[2]
    b = first_tokens.shape[0]
    rows = torch.arange(b, device=first_tokens.device)
    # the loop returns tokens only (the counterpart's replace_output_logits)
    no_logits = dataclasses.replace(tpu_cfg, output_logits=False)
    last = torch.zeros((b,), dtype=torch.int32, device=first_tokens.device)
    tok, pos = first_tokens, position_ids.long()
    toks = []
    for _ in range(num_steps):
        slot = _slot_of(block_table, rows, pos, bs)
        out = paged_forward_step(
            spec, no_logits, params, cache, tok[:, None], pos[:, None],
            slot[:, None], block_table, last, sampling_params, generator,
            inv_freq, row_seeds, adapter_ids)
        tok = out["tokens"]
        toks.append(tok)
        pos = pos + 1
    return {"tokens": torch.stack(toks, dim=1)}


def paged_spec_draft_loop(spec: DecoderSpec, tpu_cfg: TpuConfig, params,
                          cache, first_tokens, position_ids, block_table,
                          widths, sampling_params=None, generator=None,
                          num_steps: int = 1,
                          inv_freq: Optional[torch.Tensor] = None,
                          row_seeds=None, adapter_ids=None):
    """The masked greedy-k self-draft loop (model_base.py:2091-2139):
    :func:`paged_decode_loop`, except that row i stops drafting once it
    has ``widths[i] - 1`` drafts. A frozen row's step writes nothing (slot
    -1) and keeps its token and position, so a short row never writes past
    its grown block table. The draft's KV lands at [p, p + width - 2]; the
    verify rewrites those slots. A Python loop of T = 1 steps stands in
    for the reference's ``lax.scan``; each step runs the paged decode
    kernel.

    first_tokens, position_ids, widths (B,); block_table (B, max_blocks).
    Returns {"tokens": (B, num_steps) int32} (a frozen row repeats its
    last draft)."""
    bs = cache["k"].shape[2]
    b = first_tokens.shape[0]
    dev = first_tokens.device
    rows = torch.arange(b, device=dev)
    no_logits = dataclasses.replace(tpu_cfg, output_logits=False)
    last = torch.zeros((b,), dtype=torch.int32, device=dev)
    drafts = widths.long() - 1
    tok, pos = first_tokens, position_ids.long()
    toks = []
    for j in range(num_steps):
        valid = drafts > j
        safe = torch.where(valid, pos, torch.zeros_like(pos))
        slot = torch.where(valid, _slot_of(block_table, rows, safe, bs),
                           torch.full_like(pos, -1))
        out = paged_forward_step(
            spec, no_logits, params, cache, tok[:, None], pos[:, None],
            slot[:, None], block_table, last, sampling_params, generator,
            inv_freq, row_seeds, adapter_ids)
        tok = torch.where(valid, out["tokens"], tok)
        pos = torch.where(valid, pos + 1, pos)
        toks.append(tok)
    return {"tokens": torch.stack(toks, dim=1)}


# ---------------------------------------------------------------------------
# Spec resolution from InferenceConfig
# ---------------------------------------------------------------------------

A13D = "ROADMAP A13d"


def _unported_knobs(tcfg: TpuConfig, act: str):
    checks = [
        (tcfg.tensor_capture_config is not None
         or tcfg.tensor_replacement_config is not None,
         "tensor capture/replacement"),
        (act not in ACT_FNS, f"hidden_act {act!r}"),
    ]
    return [name for bad, name in checks if bad] + _moe_degree_refusals(
        tcfg)


MOE_DEGREES = ("moe_tp_degree", "moe_ep_degree", "moe_cte_tp_degree",
               "moe_cte_ep_degree", "moe_tkg_tp_degree", "moe_tkg_ep_degree")


def _moe_degree_refusals(tcfg: TpuConfig) -> List[str]:
    """``moe_tp_degree`` / ``moe_ep_degree`` (the reference's
    ``MoETpuConfig``) name the mesh's own tp and ep extents (the
    counterpart reads neither: its mesh fixes them; the tp axis is
    ``tp_degree / (cp·dp·ep)``); a value the mesh does not have is
    refused."""
    mc = tcfg.moe_config
    if mc is None:
        return []
    ep = max(int(tcfg.ep_degree), 1)
    shrink = (ep * max(int(tcfg.cp_degree), 1)
              * max(int(tcfg.attention_dp_degree), 1))
    have = {"moe_tp_degree": max(int(tcfg.tp_degree), 1) // shrink,
            "moe_ep_degree": ep}
    return [f"MoE {knob}={getattr(mc, knob)} on a mesh of {knob[4:6]} "
            f"{want}" for knob, want in have.items()
            if getattr(mc, knob, None) not in (None, want)]


def _moe_layout_refusals(tcfg: TpuConfig) -> List[str]:
    """The expert-layout knobs the reference reads once the model has an
    MoE block (model_base.py:2455-2470), refused in its own words: every
    CTE / TKG degree but ``moe_tkg_ep_degree=1`` (the hybrid decode
    layout, ``tkg_experts_local``)."""
    mc = tcfg.moe_config
    if mc is None:
        return []
    bad = [f"MoE {knob}={getattr(mc, knob)}: the mesh fixes the CTE expert "
           "layout and the TKG tp extent; only moe_tkg_ep_degree=1 "
           "(all-experts-local decode) reshards per phase"
           for knob in MOE_DEGREES[2:5] if getattr(mc, knob, None) is not None]
    tkg_ep = getattr(mc, "moe_tkg_ep_degree", None)
    if tkg_ep not in (None, 1):
        bad.append(f"MoE moe_tkg_ep_degree={tkg_ep}: hybrid MoE sharding "
                   "supports moe_tkg_ep_degree=1 (all-experts-local decode) "
                   "only")
    return bad


def _hybrid_moe(tcfg: TpuConfig, moe, quantized: bool):
    """``moe`` with ``tkg_experts_local`` under ``moe_tkg_ep_degree=1``.
    Quantized expert leaves keep the stored layout through decode: the
    reference's warning, and ``nxdi_moe_tkg_local_quant_degraded_total``
    counted when telemetry is on (model_base.py:2471-2487)."""
    mc = tcfg.moe_config
    if moe is None or mc is None or getattr(mc, "moe_tkg_ep_degree",
                                            None) != 1:
        return moe
    if quantized:
        logger.warning(
            "moe_tkg_ep_degree=1 (tkg_experts_local) has no effect on "
            "quantized MoE expert weights: decode keeps the prefill expert "
            "sharding (quantized leaves are not re-laid out). Drop the knob "
            "or the quantization.")
        from ..telemetry import get_registry
        reg = get_registry()
        if reg.enabled:
            from ..telemetry.metrics import moe_tkg_degraded_counter
            moe_tkg_degraded_counter(reg).inc()
    return dataclasses.replace(moe, tkg_experts_local=True)


def _tp_refusals(tcfg: TpuConfig, knobs) -> List[str]:
    """What the port does not serve over a mesh of more than one rank
    yet (each waits for ROADMAP A13d): multi-LoRA, speculation (fused,
    served or Medusa)."""
    return [f"{what} at tp > 1 ({A13D})" for bad, what in (
        (tcfg.lora_config is not None, "multi-LoRA"),
        (_has_speculation(tcfg) or knobs.get("medusa_heads", 0) > 0,
         "speculation")) if bad]


def _has_speculation(tcfg: TpuConfig) -> bool:
    sc = tcfg.speculation_config
    return bool(sc and (sc.speculation_length or sc.medusa_speculation_length))


def cache_layout(tcfg: TpuConfig, sliding_window: int, layer_pattern=None,
                 attn_chunk: int = 0) -> Tuple[bool, bool]:
    """(rolling_window, mixed_kv): the contiguous cache's layout as the
    reference decides it (model_base.py:2513-2552).

    The rolling cache needs a uniform sliding-window model, no paged
    layout, no flash decoding and no speculation; ``rolling_kv_cache``
    None takes it wherever it is allowed and ``seq_len`` exceeds the
    window, True asks for it (a blocker raises, a window that covers
    ``seq_len`` never rolls), False keeps full rows. The mixed cache is
    taken for a layer pattern above its window on the contiguous layout,
    without windowed context encoding, flash decoding, speculation or
    tensor capture."""
    spec_on = _has_speculation(tcfg)
    uniform = layer_pattern is None and attn_chunk == 0
    blockers = [why for bad, why in (
        (not (sliding_window > 0 and uniform),
         "needs a uniform sliding_window model"),
        (tcfg.is_block_kv_layout, "incompatible with the paged KV layout"),
        (tcfg.flash_decoding_enabled, "incompatible with flash decoding"),
        (spec_on, "incompatible with speculation")) if bad]
    worth_it = tcfg.seq_len > sliding_window
    roll = tcfg.rolling_kv_cache
    if roll is None:
        roll = not blockers and worth_it
    elif roll and blockers:
        raise ConfigurationError("rolling_kv_cache: " + "; ".join(blockers))
    elif roll and not worth_it:
        roll = False
    mixed = (layer_pattern is not None and sliding_window > 0
             and attn_chunk == 0 and tcfg.seq_len > sliding_window
             and not tcfg.windowed_context_encoding
             and not tcfg.is_block_kv_layout
             and not tcfg.flash_decoding_enabled and not spec_on
             and not (tcfg.tensor_capture_config
                      or tcfg.tensor_replacement_config))
    return bool(roll), bool(mixed)


# the DecoderSpec knobs that spec_from_config takes as keyword overrides,
# as the counterpart's ``**overrides`` (model_base.py:2346): the dense
# families', Llama4's, DBRX's, Phi-3.5-MoE's, the Medusa heads' and the
# contrib dense families'; ``tie_word_embeddings``
# overrides the config's (HF omits a default True from config.json)
KNOBS = ("act", "norm_offset", "sandwich_norm", "norm_position",
         "qk_norm_full", "residual_multiplier", "logits_divide",
         "logits_soft_cap", "attn_soft_cap", "embed_scale", "local_rope",
         "tie_word_embeddings", "nope_global", "qk_l2_norm", "attn_temp",
         "norm_type", "qkv_clip", "norm_bias", "lm_head_bias",
         "medusa_heads", "mlp_glu", "mlp_bias", "no_rope", "learned_pos",
         "embed_norm", "skip_final_norm", "alibi", "block_style",
         "qk_norm_after_rope", "qk_norm_type")
NORM_TYPES = ("rms", "layernorm")
NORM_POSITIONS = ("pre", "post", "post_residual")
BLOCK_STYLES = ("sequential", "parallel_shared", "parallel_dual")


def spec_from_config(config: InferenceConfig,
                     tp_degree: Optional[int] = None,
                     sliding_window: int = 0,
                     layer_pattern=None, attn_chunk: int = 0,
                     moe: Optional[moe_mod.MoESpec] = None,
                     qk_norm: bool = False,
                     intermediate_size: Optional[int] = None,
                     first_dense: int = 0, moe_pattern=None,
                     attn_sink: bool = False, qkv_bias: bool = False,
                     o_bias: bool = False, mla: Optional[MLASpec] = None,
                     head_dim: Optional[int] = None,
                     attn_scale: Optional[float] = None,
                     rope_interleaved: bool = False,
                     rotary_dim: Optional[int] = None,
                     num_layers: Optional[int] = None,
                     hidden_size: Optional[int] = None,
                     num_q_heads: Optional[int] = None,
                     num_kv_heads: Optional[int] = None,
                     rms_eps: Optional[float] = None,
                     **knobs) -> DecoderSpec:
    """DecoderSpec from the HF-style attributes of an InferenceConfig
    (families pass ``sliding_window`` / ``layer_pattern`` /
    ``attn_chunk`` / ``moe`` / ``qk_norm`` / ``intermediate_size`` /
    ``first_dense`` / ``moe_pattern`` / ``attn_sink`` / ``qkv_bias`` /
    ``o_bias`` / ``mla`` / ``head_dim`` / ``attn_scale`` /
    ``rope_interleaved`` / ``rotary_dim`` and the :data:`KNOBS` as the
    counterpart's overrides; ``act`` defaults to the config's
    ``hidden_act``, ``rotary_dim`` (partial rotary, GLM-4-MoE) to the
    config's, as the counterpart pops it at :2366-2367). Families whose HF
    configs name the geometry otherwise (GPT-2's ``n_embd`` / ``n_head``,
    BLOOM's ``n_layer``, MPT's ``d_model``) pass ``num_layers`` /
    ``hidden_size`` / ``num_q_heads`` / ``num_kv_heads`` / ``rms_eps``,
    which win over the config's (:2352-2365). The
    legacy rope scaling name ``"su"`` is longrope, whose
    ``original_max_position_embeddings`` may sit at the config's top
    level. The cache layout (rolling, mixed or full rows) is
    :func:`cache_layout`'s: a chunked model never takes the rolling or
    mixed cache. Raises :class:`ConfigurationError` for what the port
    does not run yet (MLA over the rolling or mixed cache, which no
    DeepSeek config takes; an activation outside :data:`ACT_FNS`;
    ``norm_position`` outside :data:`NORM_POSITIONS`; ``norm_type`` or
    ``qk_norm_type`` outside :data:`NORM_TYPES`; ``block_style`` outside
    :data:`BLOCK_STYLES`), and (a ``ValueError``, as the reference raises)
    for ``rolling_kv_cache=True`` on a config that cannot roll and for a
    ``seq_len`` past a ``learned_pos`` table (:2562-2567: decoding past it
    would reuse its last row)."""
    unknown = sorted(set(knobs) - set(KNOBS))
    if unknown:
        raise TypeError(f"spec_from_config: unknown overrides {unknown}")
    tcfg = config.tpu_config
    tp = tp_degree if tp_degree is not None else tcfg.tp_degree
    if layer_pattern is not None:
        layer_pattern = tuple(bool(x) for x in layer_pattern)
    rolling, mixed = cache_layout(tcfg, int(sliding_window), layer_pattern,
                                  attn_chunk)
    knobs.setdefault("act", getattr(config, "hidden_act", "silu"))
    knobs.setdefault("tie_word_embeddings",
                     bool(getattr(config, "tie_word_embeddings", False)))
    bad = _unported_knobs(tcfg, knobs["act"])
    if knobs.get("norm_position", "pre") not in NORM_POSITIONS:
        bad.append(f"norm_position {knobs['norm_position']!r}")
    for knob in ("norm_type", "qk_norm_type"):
        if knobs.get(knob, "rms") not in NORM_TYPES:
            bad.append(f"{knob} {knobs[knob]!r}")
    if knobs.get("block_style", "sequential") not in BLOCK_STYLES:
        bad.append(f"block_style {knobs['block_style']!r}")
    if max(tp, int(tcfg.tp_degree)) > 1:
        bad += _tp_refusals(tcfg, knobs)
    cc = tcfg.collective_config
    wire = cc.dtype if cc is not None else None
    if wire is not None:
        collectives.require_supported_dtype(wire)
    if moe is not None:
        bad += [b for b in _moe_layout_refusals(tcfg) if b not in bad]
    if mla is not None and (rolling or mixed):
        bad.append("multi-head latent attention over the rolling or mixed "
                   "per-layer cache")
    if bad:
        raise ConfigurationError(
            "the PyTorch port does not run these yet: " + ", ".join(bad))
    quant = quant_mod.quant_spec_from_config(tcfg)
    moe = _hybrid_moe(tcfg, moe, quant is not None)
    if knobs.get("learned_pos") and tcfg.seq_len > knobs["learned_pos"]:
        raise ValueError(
            f"seq_len {tcfg.seq_len} exceeds the learned position table "
            f"({knobs['learned_pos']} positions)")
    n_q = num_q_heads or config.num_attention_heads
    n_kv = (num_kv_heads or getattr(config, "num_key_value_heads", None)
            or n_q)
    hidden = hidden_size or config.hidden_size
    head_dim = (head_dim or getattr(config, "head_dim", None)
                or hidden // n_q)
    rope_scaling = getattr(config, "rope_scaling", None) or {}
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rope_type == "su":          # the legacy Phi-3 name of longrope
        rope_type = "longrope"
    if rope_type == "default":
        rope_type = None
    if rope_type not in SUPPORTED_SCALING:
        raise ConfigurationError(
            f"rope scaling {rope_type!r} is not ported yet "
            f"(supported: {SUPPORTED_SCALING})")
    attention_factor = rope_scaling.get("attention_factor")
    rope = RopeConfig(
        head_dim=head_dim,
        rope_theta=float(getattr(config, "rope_theta", 10000.0)),
        rotary_dim=(rotary_dim if rotary_dim is not None
                    else getattr(config, "rotary_dim", None)),
        scaling_type=rope_type,
        scaling_factor=float(rope_scaling.get("factor", 1.0)),
        low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
        high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
        original_max_position=int(
            rope_scaling.get("original_max_position_embeddings")
            or getattr(config, "original_max_position_embeddings", None)
            or getattr(config, "max_position_embeddings", 8192)),
        beta_fast=float(rope_scaling.get("beta_fast") or 32.0),
        beta_slow=float(rope_scaling.get("beta_slow") or 1.0),
        mscale=float(rope_scaling.get("mscale") or 0.0),
        mscale_all_dim=float(rope_scaling.get("mscale_all_dim") or 0.0),
        attention_factor=(float(attention_factor)
                          if attention_factor is not None else None),
        truncate=bool(rope_scaling.get("truncate", True)),
        short_factor=(tuple(float(x) for x in rope_scaling["short_factor"])
                      if "short_factor" in rope_scaling else None),
        long_factor=(tuple(float(x) for x in rope_scaling["long_factor"])
                     if "long_factor" in rope_scaling else None),
        max_position=int(getattr(config, "max_position_embeddings", 0)
                         or 0),
    )
    vocab = config.vocab_size
    return DecoderSpec(
        num_layers=num_layers or config.num_hidden_layers,
        hidden_size=hidden,
        num_q_heads=n_q,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate_size=(intermediate_size if intermediate_size is not None
                           else config.intermediate_size),
        vocab_size=vocab,
        padded_vocab=pad_vocab(vocab, tp),
        rms_eps=float(rms_eps if rms_eps is not None
                      else getattr(config, "rms_norm_eps", 1e-6)),
        rope=rope,
        gqa=resolve_gqa_sharding(n_q, n_kv, tp),
        sliding_window=int(sliding_window),
        attn_scale=attn_scale,
        flash_prefill=bool(tcfg.attn_kernel_enabled),
        decode_kernel=tcfg.attn_block_tkg_kernel_enabled,
        dtype=tcfg.torch_dtype,
        kv_dtype=tcfg.torch_kv_dtype,
        kv_scale=(tcfg.kv_cache_scale if tcfg.kv_cache_quant else None),
        quant=quant,
        low_rank=low_rank_mod.low_rank_spec_from_config(tcfg),
        qk_norm=bool(qk_norm),
        moe=moe,
        first_dense=int(first_dense),
        moe_pattern=(tuple(bool(x) for x in moe_pattern)
                     if moe_pattern is not None else None),
        attn_chunk=int(attn_chunk or 0),
        mla=mla,
        rope_interleaved=bool(rope_interleaved),
        layer_pattern=layer_pattern,
        attn_sink=bool(attn_sink),
        qkv_bias=bool(qkv_bias),
        o_bias=bool(o_bias),
        rolling_window=rolling,
        mixed_kv=mixed,
        lora=lora_spec_from_config(tcfg),
        vocab_parallel=bool(tcfg.vocab_parallel),
        collective_dtype=wire,
        collective_block=int(cc.block) if cc is not None else 32,
        seq_parallel=bool(tcfg.sequence_parallel_enabled),
        cp_prefill=tcfg.cp_degree > 1,
        flash_decoding=bool(tcfg.flash_decoding_enabled),
        **knobs,
    )


def rope_inv_freq(spec: DecoderSpec, device: torch.device):
    """The step-invariant inverse-frequency table, moved to ``device`` once
    by the application (before any graph capture reads it); with
    ``local_rope`` the (global, local) pair of tables."""
    inv = compute_inv_freq(spec.rope).to(device)
    if spec.local_rope is None:
        return inv
    return inv, compute_inv_freq(spec.local_rope).to(device)
