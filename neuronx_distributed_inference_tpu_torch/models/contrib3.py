"""The contrib hub's third wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib3.py`` —
``OpenAIGPTFamily`` :24-67, ``ApertusInferenceConfig`` :237,
``ApertusFamily`` :246-292, ``PhimoeFamily`` :295-360).

openai-gpt (GPT-1) is GPT-2's shape (the fused Conv1D attention, learned
positions, a plain biased MLP) with post-LN blocks, x = ln(x + sub(x))
(``norm_position="post_residual"``), and no final norm
(``skip_final_norm``). Apertus is Llama attention with the per-head q/k
RMSNorm before RoPE and a plain up / down MLP with the learned-alpha xIELU
(``act="xielu"``: a (L, 4) fp32 leaf from each layer's ``act_fn``).

Phi-3.5-MoE is Mixtral's shape (16 experts, top 2) with the sparsemixer inference routing
(``modules/moe.py``), LayerNorm with a learned bias in every block norm and
the final norm (``norm_bias``), q/k/v and o biases, an optional lm-head
bias (``lm_head_bias``, padded to the padded vocabulary) and a sliding
window on every layer. The wave's other families (VaultGemma, MiniCPM,
Orion, InternLM3, OLMo-3) wait for the next slice of ROADMAP A14f, LFM2 for
A14e."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..config import InferenceConfig
from ..modules.moe import MoESpec
from .contrib import GPT2Family, _SimpleConfig, _ident, _t, _vpad1
from .family import DecoderFamily, register_family
from .model_base import DecoderSpec, spec_from_config


@register_family("openai-gpt")
class OpenAIGPTFamily(GPT2Family):
    """GPT-1: GPT-2's fused Conv1D attention and learned positions with
    post-LN blocks (x = ln(x + sublayer(x))) and no final norm."""

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        H = config.n_embd
        nh = config.n_head
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layer,
            hidden_size=H,
            num_q_heads=nh, num_kv_heads=nh, head_dim=H // nh,
            intermediate_size=getattr(config, "n_inner", None) or 4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act={"gelu": "gelu_new", "gelu_new": "gelu_new",
                 "relu": "relu", "silu": "silu"}.get(
                getattr(config, "afn", "gelu"), "gelu_new"),
            norm_type="layernorm", norm_bias=True,
            norm_position="post_residual", skip_final_norm=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            no_rope=True,
            learned_pos=int(getattr(config, "n_positions", 512)),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """``tokens_embed`` / ``positions_embed`` under GPT-2's ``wte`` /
        ``wpe`` names; GPT-1 has no ``ln_f``, so the tree has no final
        norm."""
        sd = dict(sd)
        p = cls.hf_prefix
        sd[p + ".wte.weight"] = sd.pop(p + ".tokens_embed.weight")
        sd[p + ".wpe.weight"] = sd.pop(p + ".positions_embed.weight")
        H = spec.hidden_size
        sd[p + ".ln_f.weight"] = np.ones((H,), np.float32)
        sd[p + ".ln_f.bias"] = np.zeros((H,), np.float32)
        out = super().convert_hf_state_dict(sd, spec)
        out.pop("final_norm", None)
        out.pop("final_norm_b", None)
        return out


class ApertusInferenceConfig(InferenceConfig):
    """Apertus's config: the geometry it reads without defaults."""

    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]

    def get_text_config(self):
        return self


@register_family("apertus")
class ApertusFamily(DecoderFamily):
    """Swiss AI Apertus: Llama attention, the per-head q/k RMSNorm before
    RoPE, a plain up / down MLP with the learned-alpha xIELU."""

    config_cls = ApertusInferenceConfig
    input_norm_src = "attention_layernorm"
    post_norm_src = "feedforward_layernorm"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        bias = bool(getattr(config, "attention_bias", False))
        return spec_from_config(
            config, tp_degree,
            qk_norm=True,
            mlp_glu=False,
            act="xielu",
            qkv_bias=bias, o_bias=bias,
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        """The plain MLP's fc1 / fc2 (``up_proj`` / ``down_proj``) in the
        gate / down slots."""
        lp = cls.hf_prefix + ".layers.{i}.mlp."
        return {"gate_proj": layer_stack(lp + "up_proj.weight", _t),
                "down_proj": layer_stack(lp + "down_proj.weight", _t)}

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """Each layer's ``act_fn`` scalars as the fp32 row [alpha_p,
        alpha_n, beta, eps]."""
        a = "model.layers.{i}.mlp.act_fn."

        def row(i):
            return np.array([np.asarray(get(a.format(i=i) + n)).reshape(-1)[0]
                             for n in ("alpha_p", "alpha_n", "beta", "eps")],
                            np.float32)
        return {"xielu": np.stack([row(i) for i in range(spec.num_layers)])}


@register_family("phimoe")
class PhimoeFamily(DecoderFamily):
    """Phi-3.5-MoE: mixtral-shaped top-2 MoE with sparsemixer routing,
    biased LayerNorms and an optional lm-head bias."""

    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        moe = MoESpec(
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            intermediate_size=config.intermediate_size,
            normalize_topk=False,
            router_act="sparsemixer",
            sparsemixer_eps=float(getattr(config, "router_jitter_noise",
                                          0.01)),
            act=getattr(config, "hidden_act", "silu"),
        )
        bias = bool(getattr(config, "attention_bias", False))
        window = getattr(config, "sliding_window", None) or 0
        return spec_from_config(
            config, tp_degree, moe=moe,
            norm_type="layernorm", norm_bias=True,
            qkv_bias=bias, o_bias=bias,
            lm_head_bias=bool(getattr(config, "lm_head_bias", False)),
            sliding_window=int(window),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        p = cls.hf_prefix
        return cls.convert_moe_weights(
            get, spec,
            router_name=p + ".layers.{i}.block_sparse_moe.gate.weight",
            expert_fmt=(p + ".layers.{i}.block_sparse_moe.experts.{e}."
                        "{name}.weight"),
            gate="w1", up="w3", down="w2")

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        p = cls.hf_prefix
        return {
            "input_norm_b": layer_stack(
                p + ".layers.{i}.input_layernorm.bias", _ident),
            "post_norm_b": layer_stack(
                p + ".layers.{i}.post_attention_layernorm.bias", _ident),
        }

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """The standard conversion plus the final norm's bias and the
        lm-head bias padded to ``padded_vocab``."""
        out = super().convert_hf_state_dict(sd, spec)
        out["final_norm_b"] = np.asarray(sd["model.norm.bias"])
        if spec.lm_head_bias and "lm_head.bias" in sd:
            out["lm_head_b"] = _vpad1(np.asarray(sd["lm_head.bias"]),
                                      spec.padded_vocab)
        return out
