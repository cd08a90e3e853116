"""Phi-3.5-MoE, of the contrib hub's third wave (counterpart:
``neuronx_distributed_inference_tpu/models/contrib3.py:295-360``,
``PhimoeFamily``).

Mixtral's shape (16 experts, top 2) with the sparsemixer inference routing
(``modules/moe.py``), LayerNorm with a learned bias in every block norm and
the final norm (``norm_bias``), q/k/v and o biases, an optional lm-head
bias (``lm_head_bias``, padded to the padded vocabulary) and a sliding
window on every layer. The wave's other families (openai-gpt, LFM2,
VaultGemma, Apertus, MiniCPM, ...) wait for ROADMAP A14e."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..modules.moe import MoESpec
from .contrib import _SimpleConfig, _ident, _vpad1
from .family import DecoderFamily, register_family
from .model_base import DecoderSpec, spec_from_config


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
