"""The contrib hub's third wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib3.py`` —
``OpenAIGPTFamily`` :24-67, ``VaultGemmaFamily`` :203-234,
``ApertusInferenceConfig`` :237, ``ApertusFamily`` :246-292,
``PhimoeFamily`` :295-360, ``MiniCPMFamily`` :362-384, ``OrionFamily``
:387-400, ``InternLM3Family`` :403-418, ``Olmo3Family`` :421-453).

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
window on every layer.

VaultGemma is Gemma-2's soft caps and (1 + w) norms over alternating
sliding / full layers with two pre-norms a layer (no sandwich norms).
MiniCPM / MiniCPM4 are Llama with MuP's scalings on existing knobs (the
embeddings times ``scale_emb``, every residual branch times
``scale_depth`` / sqrt(L), the head's input over hidden /
``dim_model_base``). Orion is StableLM's biased LayerNorms at full rotary
without q/k/v biases; InternLM3 is Llama with separate q/k/v and o + MLP
bias switches; OLMo-3 is OLMo-2 with an alternating sliding / full pattern
whose sliding layers rotate with plain RoPE whatever the config's
scaling. LFM2 waits for ROADMAP A14e."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import InferenceConfig
from ..modules.moe import MoESpec
from ..ops.rope import RopeConfig
from .contrib import (GPT2Family, StableLmFamily, _SimpleConfig, _ident,
                      _up_down, _vpad1)
from .family import DecoderFamily, register_family
from .model_base import DecoderSpec, spec_from_config
from .olmo2.modeling_olmo2 import Olmo2Family


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
        return _up_down(cls, layer_stack)

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


def _alternating(config):
    """(pattern, every layer sliding) from ``layer_types``: the pattern
    (True on each ``"sliding_attention"`` layer) only when the types
    differ."""
    lt = list(getattr(config, "layer_types", []) or [])
    pattern = (tuple(t == "sliding_attention" for t in lt)
               if lt and not all(t == lt[0] for t in lt) else None)
    return pattern, bool(lt) and all(t == "sliding_attention" for t in lt)


@register_family("vaultgemma")
class VaultGemmaFamily(DecoderFamily):
    """Google VaultGemma: Gemma-2's soft caps, (1 + w) norms and embedding
    scale over alternating sliding / full layers, with only the two
    pre-norms a layer."""
    config_cls = _SimpleConfig
    post_norm_src = "pre_feedforward_layernorm"

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        pattern, _ = _alternating(config)
        qpre = getattr(config, "query_pre_attn_scalar", None)
        bias = bool(getattr(config, "attention_bias", False))
        return spec_from_config(
            config, tp_degree,
            act=getattr(config, "hidden_activation", "gelu_pytorch_tanh"),
            embed_scale=math.sqrt(config.hidden_size),
            norm_offset=1.0,
            attn_scale=(float(qpre) ** -0.5 if qpre else None),
            attn_soft_cap=getattr(config, "attn_logit_softcapping", None),
            logits_soft_cap=getattr(config, "final_logit_softcapping", None),
            sliding_window=int(getattr(config, "sliding_window", 0) or 0),
            layer_pattern=pattern,
            qkv_bias=bias, o_bias=bias,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             True)),
        )


@register_family("minicpm", "minicpm4")
class MiniCPMFamily(DecoderFamily):
    """OpenBMB MiniCPM / MiniCPM4: Llama with MuP's scalings: the
    embeddings times ``scale_emb``, each residual branch times
    ``scale_depth`` / sqrt(L), the head's input over hidden /
    ``dim_model_base``."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        L = config.num_hidden_layers
        H = config.hidden_size
        dmb = float(getattr(config, "dim_model_base", H) or H)
        return spec_from_config(
            config, tp_degree,
            embed_scale=float(getattr(config, "scale_emb", 1.0)),
            residual_multiplier=float(
                getattr(config, "scale_depth", 1.0)) / math.sqrt(L),
            logits_divide=H / dmb,
        )


@register_family("orion")
class OrionFamily(StableLmFamily):
    """OrionStar Orion: Llama's shape with biased LayerNorms everywhere:
    StableLM at full rotary without q/k/v biases (its LayerNorm-bias
    conversion)."""

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        return spec_from_config(
            config, tp_degree,
            rms_eps=float(getattr(config, "rms_norm_eps", 1e-5)),
            norm_type="layernorm", norm_bias=True,
        )


@register_family("internlm3")
class InternLM3Family(DecoderFamily):
    """Shanghai AI Lab InternLM3: Llama with a q/k/v bias switch
    (``qkv_bias``) and one for the o and MLP biases (``bias``)."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        bias = bool(getattr(config, "bias", False))
        return spec_from_config(
            config, tp_degree,
            qkv_bias=bool(getattr(config, "qkv_bias", False)),
            o_bias=bias, mlp_bias=bias,
        )


@register_family("olmo3")
class Olmo3Family(Olmo2Family):
    """AllenAI OLMo-3: OLMo-2's post-norm blocks and full-width q/k norms
    with an alternating sliding / full pattern; the sliding layers rotate
    with plain RoPE whatever the config's ``rope_scaling``, as HF's two
    rotary embeddings do."""

    @classmethod
    def build_spec(cls, config, tp_degree: Optional[int] = None
                   ) -> DecoderSpec:
        pattern, all_sliding = _alternating(config)
        window = int(getattr(config, "sliding_window", 0) or 0)
        local = None
        if pattern is not None and getattr(config, "rope_scaling", None):
            hd = (getattr(config, "head_dim", None)
                  or config.hidden_size // config.num_attention_heads)
            local = RopeConfig(head_dim=hd, rope_theta=float(
                getattr(config, "rope_theta", 500000.0)))
        return spec_from_config(
            config, tp_degree,
            norm_position="post",
            sandwich_norm=True,
            qk_norm_full=True,
            sliding_window=window if (pattern is not None
                                      or all_sliding) else 0,
            layer_pattern=pattern,
            local_rope=local,
        )
