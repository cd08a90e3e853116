"""The contrib hub's MoE families of its second wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib2.py`` —
``GraniteMoeFamily`` :745-798, ``OlmoeFamily`` :801-847,
``Glm4MoeFamily`` :850-962, ``Dots1Family`` :1210-1250).

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

The wave's dense families wait for ROADMAP A14e (``contrib``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..modules.moe import MoESpec
from ..parallel.layers import place_q_weight, replicate_kv_weight
from .contrib import _SimpleConfig, _ident, _t, _vpad
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
