"""The contrib hub's second wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib2.py`` —
``HunYuanDenseFamily`` :711-742, ``GraniteMoeFamily`` :745-798,
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

The wave's other dense families (GPT-J, GPT-Neo, GPT-BigCode, OPT, ...)
wait for the next slice of ROADMAP A14f."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..modules.moe import MoESpec
from ..ops.attention import alibi_slopes
from ..parallel.layers import place_q_weight, replicate_kv_weight
from .contrib import (_SimpleConfig, _ident, _split_interleaved_qkv,
                      _stacker, _t, _vpad)
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
