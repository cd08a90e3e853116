"""The contrib hub's second wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib2.py`` —
``GPTJFamily`` :28-101, ``GPTNeoFamily`` :108-185, ``GPTBigCodeFamily``
:192-267, ``_FairseqStyleFamily`` :275-328 with ``OPTFamily`` :331-370,
``BioGptFamily`` :373-407, ``_sinusoidal_table`` :410 and ``XGLMFamily``
:426-470, ``HeliumFamily`` :477, ``Ernie45Family`` :483, ``SeedOssFamily``
:497, ``ArceeFamily`` :519, ``NemotronFamily`` :543-609,
``SmolLM3Family`` :612, ``Cohere2Family`` :634, ``Exaone4Family``
:665-708, ``HunYuanDenseFamily`` :711-742, ``GraniteMoeFamily`` :745-798,
``OlmoeFamily`` :801-847, ``Glm4MoeFamily`` :850-962, ``BloomFamily``
:966-1036, ``MptFamily`` :1039-1116, ``PersimmonFamily`` :1122-1203,
``Dots1Family`` :1210-1250).

  * HunYuan-Dense: Llama with the per-head q/k RMSNorm applied after RoPE
    (``query_layernorm`` / ``key_layernorm``, ``qk_norm_after_rope``).
  * BLOOM: ALiBi (the ``"bloom"`` slopes, no rotation), the
    per-head-interleaved fused QKV, the embeddings' LayerNorm
    (``embed_norm``), a plain tanh-gelu MLP with biases, LayerNorms with
    biases, tied embeddings.
  * MPT: ALiBi (the ``"mpt"`` slopes), the thirds-split ``Wqkv``, no
    biases anywhere, a plain gelu MLP; learned positions, another
    ``alibi_bias_max``, biases and the ``qk_ln`` / ``clip_qkv`` variants
    are refused, as in the reference.
  * Persimmon: the per-head-interleaved fused QKV with biases, the
    per-head q/k LayerNorm with biases (``qk_norm_type="layernorm"``),
    partial rotary, a squared-ReLU plain MLP, LayerNorms with biases.

  * GraniteMoE: Granite's multipliers (``attention_multiplier`` as the
    softmax scale, the embedding, residual and logits multipliers) over an
    MoE whose router takes the top-k of the raw logits and a softmax over
    those k (``pre_softmax_topk``); each expert's fused ``input_linear``
    is split into gate (rows [0, I)) and up (rows [I, 2I)).
  * OLMoE: full-width q/k RMSNorm (OLMo-2's ``qk_norm_full``) and a
    softmax-then-top-k MoE without renormalisation.
  * GLM-4-MoE: partial rotary (``rotary_dim = head_dim x
    partial_rotary_factor``), the q/k/v bias, the optional per-head q/k
    norm, and DeepSeek-V3's MoE: a sigmoid router with
    ``e_score_correction_bias`` (selection only), ``n_group`` /
    ``topk_group``, ``routed_scaling_factor``, shared experts and
    ``first_k_dense_replace`` leading dense layers (``params["layers"]``,
    the MoE layers in ``params["moe_layers"]``).
  * dots.llm1: GLM-4-MoE's shape with full rotary and the per-head q/k
    norm always on.

  * GPT-J: the parallel-shared block (one ``ln_1``), interleaved partial
    rotary (``rotate_every_two``), a plain gelu MLP, an untied head with a
    bias; CodeGen: GPT-J with the ``mp_num=4`` fused ``qkv_proj`` in
    blocks of [q | v | k].
  * GPT-Neo: learned positions, no rotation, no 1/sqrt(D) scaling
    (``attn_scale=1.0``), a window of ``window_size`` on the ``"local"``
    layers (a mixed cache on the contiguous app).
  * GPT-BigCode (StarCoder v1): multi-query attention through the fused
    ``c_attn`` (q, then one KV head's k and v), q/k/v and o biases,
    learned positions.
  * OPT, BioGPT, XGLM (fairseq-style): biased projections, ``fc1`` /
    ``fc2``, the learned table offset by 2 (XGLM's sinusoidal table
    synthesized when the checkpoint lacks it), BioGPT and XGLM scaling the
    embeddings by sqrt(H).
  * Helium, ERNIE 4.5, Seed-OSS, Arcee: Llama's shape with, in turn,
    nothing, a null ``tie_word_embeddings`` read as tied, q/k/v biases (a
    zero ``o_proj`` bias filled in), a plain ReLU² up / down MLP.
  * Nemotron: LayerNorm1P (the weight folded to w + 1), partial rotary, a
    plain ReLU² MLP, optional biases.
  * SmolLM3: NoPE on the layers ``no_rope_layers`` marks 0 (a layer
    pattern whose global layers take no rotation, window 0).
  * Cohere2 (Command-R7B): Cohere's block with a window on the sliding
    layers and NoPE on the global ones.
  * EXAONE 4.0: post-norm plus sandwich norms, per-head q/k RMSNorm, the
    hybrid sliding / NoPE-global pattern."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from ..modules.moe import MoESpec
from ..ops.attention import alibi_slopes
from ..parallel.layers import place_q_weight, replicate_kv_weight
from .contrib import (_SimpleConfig, _ident, _split_interleaved_qkv,
                      _stacker, _t, _up_down, _vpad, _vpad1)
from .family import DecoderFamily, register_family
from .model_base import DecoderSpec, spec_from_config


@register_family("granitemoe")
class GraniteMoeFamily(DecoderFamily):
    """IBM Granite MoE: Granite's multipliers and an MoE MLP with the fused
    ``input_linear`` (gate | up stacked per expert)."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        return spec_from_config(
            config, tp_degree,
            attn_scale=float(getattr(config, "attention_multiplier", 1.0)),
            embed_scale=float(getattr(config, "embedding_multiplier", 1.0)),
            residual_multiplier=float(getattr(config, "residual_multiplier",
                                              1.0)),
            logits_divide=float(getattr(config, "logits_scaling", 1.0)),
            moe=MoESpec(
                num_experts=int(config.num_local_experts),
                top_k=int(config.num_experts_per_tok),
                intermediate_size=int(config.intermediate_size),
                # top-k on the raw logits, then the softmax over the k
                pre_softmax_topk=True,
            ),
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             True)),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        L, E = spec.num_layers, spec.moe.num_experts
        I = spec.moe.intermediate_size
        p = cls.hf_prefix
        gates, ups, downs, routers = [], [], [], []
        for i in range(L):
            moe = f"{p}.layers.{i}.block_sparse_moe"
            w_in = np.asarray(get(moe + ".input_linear.weight"))
            w_out = np.asarray(get(moe + ".output_linear.weight"))
            # input_linear (E, 2I, H): rows [0, I) gate, [I, 2I) up
            gates.append(np.stack([_t(w_in[e, :I]) for e in range(E)]))
            ups.append(np.stack([_t(w_in[e, I:]) for e in range(E)]))
            downs.append(np.stack([_t(w_out[e]) for e in range(E)]))
            routers.append(_t(np.asarray(get(
                moe + ".router.layer.weight")).astype(np.float32)))
        return {
            "router": np.stack(routers),
            "expert_gate": np.stack(gates),
            "expert_up": np.stack(ups),
            "expert_down": np.stack(downs),
        }


@register_family("olmoe")
class OlmoeFamily(DecoderFamily):
    """AllenAI OLMoE: Llama attention with full-width q/k RMSNorm and an
    MoE that takes the top-k of the softmax over all experts without
    renormalising them."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        return spec_from_config(
            config, tp_degree,
            qk_norm_full=True,
            moe=MoESpec(
                num_experts=int(config.num_experts),
                top_k=int(config.num_experts_per_tok),
                intermediate_size=int(config.intermediate_size),
                normalize_topk=bool(getattr(config, "norm_topk_prob",
                                            False)),
            ),
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        p = cls.hf_prefix
        return cls.convert_moe_weights(
            get, spec,
            router_name=p + ".layers.{i}.mlp.gate.weight",
            expert_fmt=p + ".layers.{i}.mlp.experts.{e}.{name}.weight",
            gate="gate_proj", up="up_proj", down="down_proj")

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        return {
            "q_norm": layer_stack(
                p + ".layers.{i}.self_attn.q_norm.weight",
                lambda w: place_q_weight(np.asarray(w), g, D)),
            "k_norm": layer_stack(
                p + ".layers.{i}.self_attn.k_norm.weight",
                lambda w: replicate_kv_weight(np.asarray(w), g, D)),
        }


def _deepseek_style_moe(config) -> MoESpec:
    """DeepSeek-V3's MoE as GLM-4-MoE and dots.llm1 configure it: the
    sigmoid router with ``e_score_correction_bias`` for selection only,
    group-limited top-k, the routed scaling and the shared experts."""
    return MoESpec(
        num_experts=int(config.n_routed_experts),
        top_k=int(config.num_experts_per_tok),
        intermediate_size=int(config.moe_intermediate_size),
        normalize_topk=bool(getattr(config, "norm_topk_prob", True)),
        routed_scaling=float(getattr(config, "routed_scaling_factor", 1.0)),
        router_act="sigmoid",
        has_router_bias=True,
        router_bias_mode="select",
        shared_intermediate=(int(config.moe_intermediate_size)
                             * int(getattr(config, "n_shared_experts", 0)
                                   or 0)),
        n_group=int(getattr(config, "n_group", 1) or 1),
        topk_group=int(getattr(config, "topk_group", 1) or 1),
    )


@register_family("glm4_moe")
class Glm4MoeFamily(DecoderFamily):
    """Zhipu GLM-4-MoE: GQA attention (partial rotary, optional per-head
    q/k norm, q/k/v bias) and DeepSeek-V3's MoE (sigmoid router with
    ``e_score_correction_bias`` for selection, shared experts, leading
    dense layers)."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = getattr(config, "head_dim", None) or H // nh
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            moe=_deepseek_style_moe(config),
            first_dense=int(getattr(config, "first_k_dense_replace", 0)),
            qkv_bias=bool(getattr(config, "attention_bias", False)),
            qk_norm=bool(getattr(config, "use_qk_norm", False)),
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.5)),
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """Each layer's attention, then a dense MLP (the first
        ``first_dense`` layers, into ``"layers"``) or DeepSeek-V3's MoE
        weights (``deepseek_style_moe_weights``, into ``"moe_layers"``;
        into ``"layers"`` when no layer is dense)."""
        from .deepseek.modeling_deepseek import deepseek_style_moe_weights
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        L = spec.num_layers
        nd = spec.first_dense

        def get(n):
            return np.asarray(sd[n])

        def attn_layer(i):
            base = f"{p}.layers.{i}.self_attn"
            out = {
                "input_norm": _ident(get(
                    f"{p}.layers.{i}.input_layernorm.weight")),
                "post_norm": _ident(get(
                    f"{p}.layers.{i}.post_attention_layernorm.weight")),
                "q_proj": place_q_weight(_t(get(f"{base}.q_proj.weight")),
                                         g, D, axis=-1),
                "k_proj": replicate_kv_weight(
                    _t(get(f"{base}.k_proj.weight")), g, D, axis=-1),
                "v_proj": replicate_kv_weight(
                    _t(get(f"{base}.v_proj.weight")), g, D, axis=-1),
                "o_proj": place_q_weight(_t(get(f"{base}.o_proj.weight")),
                                         g, D, axis=0),
            }
            if spec.qkv_bias:
                out["q_bias"] = place_q_weight(get(f"{base}.q_proj.bias"),
                                               g, D)
                out["k_bias"] = replicate_kv_weight(
                    get(f"{base}.k_proj.bias"), g, D)
                out["v_bias"] = replicate_kv_weight(
                    get(f"{base}.v_proj.bias"), g, D)
            if spec.qk_norm:
                out["q_norm"] = _ident(get(f"{base}.q_norm.weight"))
                out["k_norm"] = _ident(get(f"{base}.k_norm.weight"))
            return out

        def dense_layer(i):
            out = attn_layer(i)
            for k in ("gate_proj", "up_proj", "down_proj"):
                out[k] = _t(get(f"{p}.layers.{i}.mlp.{k}.weight"))
            return out

        def moe_layer(i):
            out = attn_layer(i)
            out.update(deepseek_style_moe_weights(get, p, i, spec, _t))
            return out

        def stack_dicts(dicts):
            return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

        out = {
            "embed": _vpad(get(p + ".embed_tokens.weight"),
                           spec.padded_vocab),
            "final_norm": _ident(get(p + ".norm.weight")),
        }
        if nd > 0:
            out["layers"] = stack_dicts([dense_layer(i) for i in range(nd)])
            out["moe_layers"] = stack_dicts([moe_layer(i)
                                             for i in range(nd, L)])
        else:
            out["layers"] = stack_dicts([moe_layer(i) for i in range(L)])
        if not spec.tie_word_embeddings:
            out["lm_head"] = _t(_vpad(get("lm_head.weight"),
                                      spec.padded_vocab))
        return out


@register_family("dots1")
class Dots1Family(Glm4MoeFamily):
    """rednote dots.llm1: GLM-4-MoE's shape (DeepSeek-V3's MoE, leading
    dense layers) with standard GQA attention, FULL rotary and the per-head
    q/k RMSNorm."""

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = getattr(config, "head_dim", None) or H // nh
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            moe=_deepseek_style_moe(config),
            first_dense=int(getattr(config, "first_k_dense_replace", 0)),
            qkv_bias=bool(getattr(config, "attention_bias", False)),
            qk_norm=True,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )


@register_family("hunyuan_v1_dense")
class HunYuanDenseFamily(DecoderFamily):
    """Tencent HunYuan (dense): Llama with the per-head q/k RMSNorm applied
    after RoPE."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        bias = bool(getattr(config, "attention_bias", False))
        return spec_from_config(
            config, tp_degree,
            qk_norm=True, qk_norm_after_rope=True,
            qkv_bias=bias, o_bias=bias,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """``query_layernorm`` / ``key_layernorm`` read under the
        ``q_norm`` / ``k_norm`` names the base converter takes."""
        sd = dict(sd)
        for i in range(spec.num_layers):
            a = f"model.layers.{i}.self_attn."
            sd[a + "q_norm.weight"] = np.asarray(
                sd[a + "query_layernorm.weight"])
            sd[a + "k_norm.weight"] = np.asarray(
                sd[a + "key_layernorm.weight"])
        return super().convert_hf_state_dict(sd, spec)


def _alibi_stack(spec: DecoderSpec, variant: str) -> np.ndarray:
    """The (L, Hq) slopes leaf: every layer's row the placed slopes of the
    variant (identical rows keep the layer stack uniform)."""
    slopes = place_q_weight(alibi_slopes(spec.num_q_heads, variant),
                            spec.gqa, 1)
    return np.broadcast_to(slopes, (spec.num_layers,) + slopes.shape).copy()


@register_family("bloom")
class BloomFamily(DecoderFamily):
    """BigScience BLOOM: ALiBi, the per-head-interleaved fused QKV, the
    embeddings' LayerNorm, a plain tanh-gelu MLP with biases, LayerNorms
    with biases, tied embeddings."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.n_head
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layer,
            hidden_size=H, num_q_heads=nh, num_kv_heads=nh,
            head_dim=H // nh,
            intermediate_size=4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            # bloom_gelu_forward is the tanh form
            act="gelu_pytorch_tanh",
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            no_rope=True, alibi=True, embed_norm=True,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        lp = p + ".h.{i}."
        layers = {
            "input_norm": stack(lp + "input_layernorm.weight", _ident),
            "input_norm_b": stack(lp + "input_layernorm.bias", _ident),
            "post_norm": stack(lp + "post_attention_layernorm.weight",
                               _ident),
            "post_norm_b": stack(lp + "post_attention_layernorm.bias",
                                 _ident),
            **_split_interleaved_qkv(get, lp + "self_attention.query_key_value",
                                     spec.num_layers, spec.num_q_heads, g,
                                     D),
            "o_proj": stack(lp + "self_attention.dense.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(lp + "self_attention.dense.bias", _ident),
            "gate_proj": stack(lp + "mlp.dense_h_to_4h.weight", _t),
            "gate_bias": stack(lp + "mlp.dense_h_to_4h.bias", _ident),
            "down_proj": stack(lp + "mlp.dense_4h_to_h.weight", _t),
            "down_bias": stack(lp + "mlp.dense_4h_to_h.bias", _ident),
            "alibi_slopes": _alibi_stack(spec, "bloom"),
        }
        return {
            "embed": _vpad(get(p + ".word_embeddings.weight"),
                           spec.padded_vocab),
            "embed_norm": get(p + ".word_embeddings_layernorm.weight"),
            "embed_norm_b": get(p + ".word_embeddings_layernorm.bias"),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
        }


@register_family("mpt")
class MptFamily(DecoderFamily):
    """MosaicML MPT: ALiBi, the thirds-split fused ``Wqkv``, no biases, a
    plain gelu MLP, bias-free LayerNorms, tied embeddings."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.d_model
        nh = config.n_heads
        ac = getattr(config, "attn_config", None) or {}
        if not isinstance(ac, dict):      # an MptConfig object, not JSON
            ac = {k: getattr(ac, k) for k in
                  ("alibi", "alibi_bias_max", "qk_ln", "clip_qkv")
                  if hasattr(ac, k)}
        if not ac.get("alibi", True):
            raise NotImplementedError("MPT without ALiBi (learned "
                                      "positions) is not supported")
        if ac.get("alibi_bias_max", 8) != 8:
            raise NotImplementedError("MPT alibi_bias_max != 8")
        if not getattr(config, "no_bias", True):
            raise NotImplementedError("MPT with biases is not supported")
        if ac.get("qk_ln", False) or ac.get("clip_qkv", None):
            raise NotImplementedError("MPT qk_ln / clip_qkv variants")
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layers,
            hidden_size=H, num_q_heads=nh, num_kv_heads=nh,
            head_dim=H // nh,
            intermediate_size=int(H * getattr(config, "expansion_ratio", 4)),
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act="gelu",
            norm_type="layernorm", norm_bias=False,
            mlp_glu=False, mlp_bias=False,
            no_rope=True, alibi=True,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """``Wqkv`` (3H, H): q, k and v in thirds."""
        g, D = spec.gqa, spec.head_dim
        H = spec.hidden_size
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        qs, ks, vs = [], [], []
        for i in range(spec.num_layers):
            w = get(f"{p}.blocks.{i}.attn.Wqkv.weight")
            qs.append(place_q_weight(_t(w[:H]), g, D, axis=-1))
            ks.append(replicate_kv_weight(_t(w[H:2 * H]), g, D, axis=-1))
            vs.append(replicate_kv_weight(_t(w[2 * H:]), g, D, axis=-1))
        lp = p + ".blocks.{i}."
        layers = {
            "input_norm": stack(lp + "norm_1.weight", _ident),
            "post_norm": stack(lp + "norm_2.weight", _ident),
            "qkv_proj": np.concatenate(
                [np.stack(qs), np.stack(ks), np.stack(vs)], axis=-1),
            "o_proj": stack(lp + "attn.out_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "gate_proj": stack(lp + "ffn.up_proj.weight", _t),
            "down_proj": stack(lp + "ffn.down_proj.weight", _t),
            "alibi_slopes": _alibi_stack(spec, "mpt"),
        }
        return {
            "embed": _vpad(get(p + ".wte.weight"), spec.padded_vocab),
            "layers": layers,
            "final_norm": get(p + ".norm_f.weight"),
        }


@register_family("persimmon")
class PersimmonFamily(DecoderFamily):
    """Adept Persimmon: the per-head-interleaved fused QKV with biases, the
    per-head q/k LayerNorm with biases, partial rotary, a squared-ReLU
    plain MLP with biases, LayerNorms with biases, an untied head."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = H // nh
        return spec_from_config(
            config, tp_degree,
            num_kv_heads=nh,
            head_dim=hd,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            act=getattr(config, "hidden_act", "relu2"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            qk_norm=bool(getattr(config, "qk_layernorm", True)),
            qk_norm_type="layernorm",
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.5)),
            tie_word_embeddings=False,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        lp = p + ".layers.{i}."
        layers = {
            "input_norm": stack(lp + "input_layernorm.weight", _ident),
            "input_norm_b": stack(lp + "input_layernorm.bias", _ident),
            "post_norm": stack(lp + "post_attention_layernorm.weight",
                               _ident),
            "post_norm_b": stack(lp + "post_attention_layernorm.bias",
                                 _ident),
            **_split_interleaved_qkv(get, lp + "self_attn.query_key_value",
                                     spec.num_layers, spec.num_q_heads, g,
                                     D),
            "o_proj": stack(lp + "self_attn.dense.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(lp + "self_attn.dense.bias", _ident),
            "gate_proj": stack(lp + "mlp.dense_h_to_4h.weight", _t),
            "gate_bias": stack(lp + "mlp.dense_h_to_4h.bias", _ident),
            "down_proj": stack(lp + "mlp.dense_4h_to_h.weight", _t),
            "down_bias": stack(lp + "mlp.dense_4h_to_h.bias", _ident),
        }
        if spec.qk_norm:
            for n in ("q", "k"):
                layers[n + "_norm"] = stack(
                    lp + f"self_attn.{n}_layernorm.weight", _ident)
                layers[n + "_norm_b"] = stack(
                    lp + f"self_attn.{n}_layernorm.bias", _ident)
        return {
            "embed": _vpad(get(p + ".embed_tokens.weight"),
                           spec.padded_vocab),
            "layers": layers,
            "final_norm": get(p + ".final_layernorm.weight"),
            "final_norm_b": get(p + ".final_layernorm.bias"),
            "lm_head": _t(_vpad(get("lm_head.weight"), spec.padded_vocab)),
        }


def _fused(layers: Dict[str, np.ndarray], kind: str) -> None:
    """The separate q / k / v leaves of ``kind`` ("proj" or "bias") of a
    converted stack, concatenated into the fused ``qkv_<kind>`` leaf."""
    layers["qkv_" + kind] = np.concatenate(
        [layers.pop(f"{n}_{kind}") for n in ("q", "k", "v")], axis=-1)


@register_family("gptj")
class GPTJFamily(DecoderFamily):
    """EleutherAI GPT-J: the parallel-shared block (one ``ln_1``), partial
    interleaved rotary, a plain gelu MLP with biases, an untied head with a
    bias."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.n_embd
        nh = config.n_head
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layer,
            hidden_size=H, num_q_heads=nh, num_kv_heads=nh,
            head_dim=H // nh,
            intermediate_size=getattr(config, "n_inner", None) or 4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act=getattr(config, "activation_function", "gelu_new"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            rotary_dim=int(getattr(config, "rotary_dim", None)
                           or (H // nh)),
            rope_interleaved=True,
            block_style="parallel_shared",
            lm_head_bias=True,
            tie_word_embeddings=False,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """``q_proj`` / ``k_proj`` / ``v_proj`` into the fused ``qkv_proj``;
        the parallel-shared block reads no ``post_norm`` (ones, zeros)."""
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        L, H = spec.num_layers, spec.hidden_size
        lp = p + ".h.{i}."
        layers = {
            "input_norm": stack(lp + "ln_1.weight", _ident),
            "input_norm_b": stack(lp + "ln_1.bias", _ident),
            "post_norm": np.ones((L, H), np.float32),
            "post_norm_b": np.zeros((L, H), np.float32),
            "q_proj": stack(lp + "attn.q_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=-1)),
            "k_proj": stack(lp + "attn.k_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "v_proj": stack(lp + "attn.v_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "o_proj": stack(lp + "attn.out_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "gate_proj": stack(lp + "mlp.fc_in.weight", _t),
            "gate_bias": stack(lp + "mlp.fc_in.bias", _ident),
            "down_proj": stack(lp + "mlp.fc_out.weight", _t),
            "down_bias": stack(lp + "mlp.fc_out.bias", _ident),
        }
        _fused(layers, "proj")
        return {
            "embed": _vpad(get(p + ".wte.weight"), spec.padded_vocab),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
            "lm_head": _t(_vpad(get("lm_head.weight"), spec.padded_vocab)),
            "lm_head_b": _vpad1(get("lm_head.bias"), spec.padded_vocab),
        }


@register_family("codegen")
class CodeGenFamily(GPTJFamily):
    """Salesforce CodeGen: GPT-J with the fused ``qkv_proj`` laid out as
    ``mp_num=4`` blocks, each [q | v | k] of its quarter of the heads."""

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """The blocks taken apart under GPT-J's per-projection names."""
        D, nh = spec.head_dim, spec.num_q_heads
        p = cls.hf_prefix
        mp_num = 4
        local = nh * D // mp_num
        sd = dict(sd)
        for i in range(spec.num_layers):
            w = np.asarray(sd[f"{p}.h.{i}.attn.qkv_proj.weight"])
            w = w.reshape(mp_num, 3 * local, -1)
            for j, n in enumerate(("q", "v", "k")):
                sd[f"{p}.h.{i}.attn.{n}_proj.weight"] = \
                    w[:, j * local:(j + 1) * local].reshape(nh * D, -1)
        return super().convert_hf_state_dict(sd, spec)


@register_family("gpt_neo")
class GPTNeoFamily(DecoderFamily):
    """EleutherAI GPT-Neo: global and local (windowed) layers, learned
    positions, no rotation and no 1/sqrt(D) scaling, a plain gelu MLP,
    LayerNorms with biases; bias-free q/k/v, a biased output projection."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.num_heads
        pattern = tuple(t == "local" for t in config.attention_layers)
        return spec_from_config(
            config, tp_degree,
            num_layers=config.num_layers,
            hidden_size=H, num_q_heads=nh, num_kv_heads=nh,
            head_dim=H // nh,
            intermediate_size=getattr(config, "intermediate_size", None)
            or 4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act=getattr(config, "activation_function", "gelu_new"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            o_bias=True,
            no_rope=True,
            learned_pos=int(getattr(config, "max_position_embeddings", 2048)),
            layer_pattern=pattern if any(pattern) else None,
            sliding_window=int(getattr(config, "window_size", 256)),
            attn_scale=1.0,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        lp = p + ".h.{i}."
        a = lp + "attn.attention."
        layers = {
            "input_norm": stack(lp + "ln_1.weight", _ident),
            "input_norm_b": stack(lp + "ln_1.bias", _ident),
            "post_norm": stack(lp + "ln_2.weight", _ident),
            "post_norm_b": stack(lp + "ln_2.bias", _ident),
            "q_proj": stack(a + "q_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=-1)),
            "k_proj": stack(a + "k_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "v_proj": stack(a + "v_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "o_proj": stack(a + "out_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(a + "out_proj.bias", _ident),
            "gate_proj": stack(lp + "mlp.c_fc.weight", _t),
            "gate_bias": stack(lp + "mlp.c_fc.bias", _ident),
            "down_proj": stack(lp + "mlp.c_proj.weight", _t),
            "down_bias": stack(lp + "mlp.c_proj.bias", _ident),
        }
        _fused(layers, "proj")
        return {
            "embed": _vpad(get(p + ".wte.weight"), spec.padded_vocab),
            "pos_embed": get(p + ".wpe.weight"),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
        }


@register_family("gpt_bigcode")
class GPTBigCodeFamily(DecoderFamily):
    """BigCode GPT-BigCode (StarCoder v1, SantaCoder): multi-query
    attention through the fused ``c_attn`` (q, then one KV head's k and v)
    with biases, learned positions, a plain gelu MLP, LayerNorms with
    biases, tied embeddings."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.n_embd
        nh = config.n_head
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layer,
            hidden_size=H, num_q_heads=nh,
            num_kv_heads=1 if getattr(config, "multi_query", True) else nh,
            head_dim=H // nh,
            intermediate_size=getattr(config, "n_inner", None) or 4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act=getattr(config, "activation_function", "gelu_pytorch_tanh"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            no_rope=True,
            learned_pos=int(getattr(config, "n_positions", 2048)),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """``c_attn`` (H + 2 kvd, H) split at H and H + kvd (kvd = Hkv x
        D), its bias likewise."""
        g, D = spec.gqa, spec.head_dim
        H = spec.hidden_size
        kvd = spec.num_kv_heads * D
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        qs, ks, vs, qb, kb, vb = [], [], [], [], [], []
        for i in range(spec.num_layers):
            w = get(f"{p}.h.{i}.attn.c_attn.weight")
            b = get(f"{p}.h.{i}.attn.c_attn.bias")
            qs.append(place_q_weight(_t(w[:H]), g, D, axis=-1))
            ks.append(replicate_kv_weight(_t(w[H:H + kvd]), g, D, axis=-1))
            vs.append(replicate_kv_weight(_t(w[H + kvd:]), g, D, axis=-1))
            qb.append(place_q_weight(b[:H], g, D))
            kb.append(replicate_kv_weight(b[H:H + kvd], g, D))
            vb.append(replicate_kv_weight(b[H + kvd:], g, D))
        lp = p + ".h.{i}."
        layers = {
            "input_norm": stack(lp + "ln_1.weight", _ident),
            "input_norm_b": stack(lp + "ln_1.bias", _ident),
            "post_norm": stack(lp + "ln_2.weight", _ident),
            "post_norm_b": stack(lp + "ln_2.bias", _ident),
            "qkv_proj": np.concatenate(
                [np.stack(qs), np.stack(ks), np.stack(vs)], axis=-1),
            "qkv_bias": np.concatenate(
                [np.stack(qb), np.stack(kb), np.stack(vb)], axis=-1),
            "o_proj": stack(lp + "attn.c_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(lp + "attn.c_proj.bias", _ident),
            "gate_proj": stack(lp + "mlp.c_fc.weight", _t),
            "gate_bias": stack(lp + "mlp.c_fc.bias", _ident),
            "down_proj": stack(lp + "mlp.c_proj.weight", _t),
            "down_bias": stack(lp + "mlp.c_proj.bias", _ident),
        }
        return {
            "embed": _vpad(get(p + ".wte.weight"), spec.padded_vocab),
            "pos_embed": get(p + ".wpe.weight"),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
        }


class _FairseqStyleFamily(DecoderFamily):
    """The OPT-shaped decoders' layers: ``self_attn.{q,k,v,out}_proj`` with
    biases, ``fc1`` / ``fc2``, ``self_attn_layer_norm`` /
    ``final_layer_norm``; each family reads its own position table."""
    config_cls = _SimpleConfig
    layers_fmt = "model.decoder.layers.{i}"

    @classmethod
    def _convert_layers(cls, sd: Dict[str, np.ndarray],
                        spec: DecoderSpec) -> Dict[str, np.ndarray]:
        g, D = spec.gqa, spec.head_dim
        _, stack = _stacker(sd, spec.num_layers)
        f = cls.layers_fmt + "."
        a = f + "self_attn."
        layers = {
            "input_norm": stack(f + "self_attn_layer_norm.weight", _ident),
            "input_norm_b": stack(f + "self_attn_layer_norm.bias", _ident),
            "post_norm": stack(f + "final_layer_norm.weight", _ident),
            "post_norm_b": stack(f + "final_layer_norm.bias", _ident),
            "q_proj": stack(a + "q_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=-1)),
            "k_proj": stack(a + "k_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "v_proj": stack(a + "v_proj.weight",
                            lambda w: replicate_kv_weight(_t(w), g, D,
                                                          axis=-1)),
            "o_proj": stack(a + "out_proj.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(a + "out_proj.bias", _ident),
            "gate_proj": stack(f + "fc1.weight", _t),
            "gate_bias": stack(f + "fc1.bias", _ident),
            "down_proj": stack(f + "fc2.weight", _t),
            "down_bias": stack(f + "fc2.bias", _ident),
            "q_bias": stack(a + "q_proj.bias",
                            lambda b: place_q_weight(b, g, D)),
            "k_bias": stack(a + "k_proj.bias",
                            lambda b: replicate_kv_weight(b, g, D)),
            "v_bias": stack(a + "v_proj.bias",
                            lambda b: replicate_kv_weight(b, g, D)),
        }
        _fused(layers, "proj")
        _fused(layers, "bias")
        return layers

    @classmethod
    def _tree(cls, sd: Dict[str, np.ndarray], spec: DecoderSpec,
              prefix: str, pos_table: np.ndarray) -> Dict[str, Any]:
        """The tree from the layers, ``<prefix>.embed_tokens``, the
        position table and ``<prefix>.<final norm>``."""
        norm = prefix + (".final_layer_norm" if prefix == "model.decoder"
                         else ".layer_norm")
        return {
            "embed": _vpad(np.asarray(sd[prefix + ".embed_tokens.weight"]),
                           spec.padded_vocab),
            "pos_embed": pos_table,
            "layers": cls._convert_layers(sd, spec),
            "final_norm": np.asarray(sd[norm + ".weight"]),
            "final_norm_b": np.asarray(sd[norm + ".bias"]),
        }


@register_family("opt")
class OPTFamily(_FairseqStyleFamily):
    """Meta OPT: the fairseq-style layers, a relu MLP, the learned table
    indexed at position + 2; the 350m-style embedding projections and the
    post-norm variant are refused, as in the reference."""

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        if getattr(config, "word_embed_proj_dim",
                   config.hidden_size) != config.hidden_size:
            raise NotImplementedError(
                "OPT word_embed_proj_dim != hidden_size (350m-style "
                "embedding projections) is not supported")
        if not getattr(config, "do_layer_norm_before", True):
            raise NotImplementedError("OPT post-norm variant not supported")
        return spec_from_config(
            config, tp_degree,
            num_kv_heads=config.num_attention_heads,
            rms_eps=1e-5,
            act=getattr(config, "activation_function", "relu"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            intermediate_size=config.ffn_dim,
            no_rope=True,
            learned_pos=int(config.max_position_embeddings),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        return cls._tree(sd, spec, "model.decoder", np.asarray(
            sd["model.decoder.embed_positions.weight"])[2:])


@register_family("biogpt")
class BioGptFamily(_FairseqStyleFamily):
    """Microsoft BioGPT: OPT's layers under ``biogpt.layers``, a gelu MLP,
    the embeddings scaled by sqrt(H), the learned table offset by 2."""
    layers_fmt = "biogpt.layers.{i}"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        return spec_from_config(
            config, tp_degree,
            num_kv_heads=config.num_attention_heads,
            rms_eps=1e-5,
            act=getattr(config, "hidden_act", "gelu"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            intermediate_size=config.intermediate_size,
            no_rope=True,
            embed_scale=(math.sqrt(H)
                         if getattr(config, "scale_embedding", True)
                         else None),
            learned_pos=int(config.max_position_embeddings),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        return cls._tree(sd, spec, "biogpt", np.asarray(
            sd["biogpt.embed_positions.weight"])[2:])


def _sinusoidal_table(n_pos: int, dim: int, padding_idx: int = 1
                      ) -> np.ndarray:
    """The fairseq / XGLM sinusoidal position table ([sin | cos], the
    padding row zeroed): XGLM keeps it as a non-persistent buffer, so a
    checkpoint may lack it."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -emb)
    args = np.arange(n_pos, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.pad(table, [(0, 0), (0, 1)])
    table[padding_idx] = 0.0
    return table.astype(np.float32)


@register_family("xglm")
class XGLMFamily(_FairseqStyleFamily):
    """Meta XGLM: OPT's layers under ``model.layers``, a gelu MLP, the
    embeddings scaled by sqrt(H), the sinusoidal table offset by 2
    (synthesized when the checkpoint lacks it)."""
    layers_fmt = "model.layers.{i}"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.d_model
        return spec_from_config(
            config, tp_degree,
            hidden_size=H,
            num_q_heads=config.attention_heads,
            num_kv_heads=config.attention_heads,
            head_dim=H // config.attention_heads,
            num_layers=config.num_layers,
            intermediate_size=config.ffn_dim,
            rms_eps=1e-5,
            act=getattr(config, "activation_function", "gelu"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            no_rope=True,
            embed_scale=(math.sqrt(H)
                         if getattr(config, "scale_embedding", True)
                         else None),
            learned_pos=int(config.max_position_embeddings),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        key = "model.embed_positions.weights"
        table = (np.asarray(sd[key]) if key in sd else _sinusoidal_table(
            spec.learned_pos + 2, spec.hidden_size))[2:]
        return cls._tree(sd, spec, "model", table)


@register_family("helium")
class HeliumFamily(DecoderFamily):
    """kyutai Helium: Llama's shape."""
    config_cls = _SimpleConfig


def _tied_unless_false(config) -> bool:
    """``tie_word_embeddings`` of a config class that writes its default
    True as null: None means tied."""
    return getattr(config, "tie_word_embeddings", None) is not False


@register_family("ernie4_5")
class Ernie45Family(DecoderFamily):
    """Baidu ERNIE 4.5 (dense): Llama's shape; a null
    ``tie_word_embeddings`` means tied."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        return spec_from_config(config, tp_degree,
                                tie_word_embeddings=_tied_unless_false(
                                    config))


@register_family("seed_oss")
class SeedOssFamily(DecoderFamily):
    """ByteDance Seed-OSS: Llama with attention biases and an explicit
    head_dim."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        bias = bool(getattr(config, "attention_bias", True))
        return spec_from_config(config, tp_degree, qkv_bias=bias,
                                o_bias=bias)

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """Seed-OSS ships q/k/v biases and a bias-free ``o_proj``: its
        bias is filled with zeros."""
        if spec.o_bias and "model.layers.0.self_attn.o_proj.bias" not in sd:
            sd = dict(sd)
            for i in range(spec.num_layers):
                sd[f"model.layers.{i}.self_attn.o_proj.bias"] = np.zeros(
                    (spec.hidden_size,), np.float32)
        return super().convert_hf_state_dict(sd, spec)


@register_family("arcee")
class ArceeFamily(DecoderFamily):
    """Arcee AFM: Llama attention and a plain ReLU² up / down MLP."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        return spec_from_config(config, tp_degree, mlp_glu=False,
                                act=getattr(config, "hidden_act", "relu2"))

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        return _up_down(cls, layer_stack)


@register_family("nemotron")
class NemotronFamily(DecoderFamily):
    """NVIDIA Nemotron: LayerNorm1P (a zero-centred weight, folded to w + 1
    here), partial rotary, a plain ReLU² MLP, optional biases."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = getattr(config, "head_dim", None) or H // nh
        bias = bool(getattr(config, "attention_bias", False))
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            rms_eps=float(getattr(config, "norm_eps", 1e-5)),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False,
            mlp_bias=bool(getattr(config, "mlp_bias", False)),
            qkv_bias=bias, o_bias=bias,
            act=getattr(config, "hidden_act", "relu2"),
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.5)),
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        return _up_down(cls, layer_stack, bias=spec.mlp_bias)

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """The block norms as LayerNorm1P computes them: weight + 1."""
        lp = cls.hf_prefix + ".layers.{i}."

        def plus1(w):
            return np.asarray(w) + 1.0
        return {
            "input_norm": layer_stack(lp + "input_layernorm.weight", plus1),
            "input_norm_b": layer_stack(lp + "input_layernorm.bias", _ident),
            "post_norm": layer_stack(lp + "post_attention_layernorm.weight",
                                     plus1),
            "post_norm_b": layer_stack(lp + "post_attention_layernorm.bias",
                                       _ident),
        }

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        out = super().convert_hf_state_dict(sd, spec)
        out["final_norm"] = np.asarray(sd["model.norm.weight"]) + 1.0
        out["final_norm_b"] = np.asarray(sd["model.norm.bias"])
        return out


@register_family("smollm3")
class SmolLM3Family(DecoderFamily):
    """HuggingFace SmolLM3: Llama with NoPE on every layer that
    ``no_rope_layers`` marks 0 (the pattern's "local" layers keep RoPE, its
    global layers take none, both at window 0); a null
    ``tie_word_embeddings`` means tied."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        rope_on = [bool(x) for x in getattr(config, "no_rope_layers", [])]
        pattern = tuple(rope_on) if rope_on and not all(rope_on) else None
        return spec_from_config(
            config, tp_degree,
            qkv_bias=bool(getattr(config, "attention_bias", False)),
            layer_pattern=pattern,
            nope_global=pattern is not None,
            tie_word_embeddings=_tied_unless_false(config),
        )


def _sliding_pattern(config):
    """(pattern, any sliding layer) from ``layer_types``: True on each
    ``"sliding_attention"`` layer."""
    types = list(getattr(config, "layer_types", []) or [])
    pattern = tuple(t == "sliding_attention" for t in types)
    return pattern, any(pattern)


@register_family("cohere2")
class Cohere2Family(DecoderFamily):
    """Cohere Command-R7B: Cohere's block (parallel-shared, a bias-free
    LayerNorm, the logit scale, tied embeddings) with a window on the
    sliding layers and NoPE on the global ones."""
    config_cls = _SimpleConfig
    post_norm_src = "input_layernorm"   # the parallel-shared block reads none

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        scale = float(getattr(config, "logit_scale", 1.0))
        pattern, hybrid = _sliding_pattern(config)
        return spec_from_config(
            config, tp_degree,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            norm_type="layernorm",
            block_style="parallel_shared",
            logits_divide=1.0 / scale if scale else None,
            layer_pattern=pattern if hybrid else None,
            sliding_window=int(getattr(config, "sliding_window", 0) or 0),
            nope_global=hybrid,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        L, H = spec.num_layers, spec.hidden_size
        return {"post_norm": np.ones((L, H), np.float32)}


@register_family("exaone4")
class Exaone4Family(DecoderFamily):
    """LG EXAONE 4.0: post-norm blocks with the sandwich norms on the
    outputs (OLMo-2's shape), per-head q/k RMSNorm, the optional hybrid
    pattern of sliding layers and NoPE global ones."""
    config_cls = _SimpleConfig
    post_norm_src = "post_attention_layernorm"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        pattern, hybrid = _sliding_pattern(config)
        return spec_from_config(
            config, tp_degree,
            norm_position="post",
            sandwich_norm=True,
            qk_norm=True,
            layer_pattern=pattern if hybrid else None,
            sliding_window=int(getattr(config, "sliding_window", 0) or 0)
            if hybrid else 0,
            nope_global=hybrid,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """EXAONE 4.0 has no pre-norms: their unused slots load ones."""
        aug = dict(sd)
        for i in range(spec.num_layers):
            aug[f"model.layers.{i}.input_layernorm.weight"] = np.ones(
                (spec.hidden_size,), np.float32)
        return super().convert_hf_state_dict(aug, spec)

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "post_attn_norm": layer_stack(
                lp + "post_attention_layernorm.weight", _ident),
            "post_ff_norm": layer_stack(
                lp + "post_feedforward_layernorm.weight", _ident),
        }
