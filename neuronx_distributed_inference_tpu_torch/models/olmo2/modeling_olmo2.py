"""OLMo-2 family (counterpart:
``neuronx_distributed_inference_tpu/models/olmo2/modeling_olmo2.py:18-93``).
A post-norm decoder: no pre-norms (``norm_position="post"``); an RMSNorm
on the attention output and one on the MLP output, each before its
residual add (the sandwich slots ``post_attn_norm`` / ``post_ff_norm``);
and a full-width q / k RMSNorm over the whole projection before the head
split (``qk_norm_full``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...parallel.layers import place_q_weight, replicate_kv_weight
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class Olmo2InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size"]


@register_family("olmo2")
class Olmo2Family(DecoderFamily):
    config_cls = Olmo2InferenceConfig
    # the pre-MLP "post_norm" slot is unused in post-norm mode; it holds
    # the post-attention weights so the base converter finds a tensor
    post_norm_src = "post_attention_layernorm"

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        return spec_from_config(config, tp_degree, norm_position="post",
                                sandwich_norm=True, qk_norm_full=True)

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, np.ndarray]:
        """OLMo-2 has no input_layernorm: the unused pre-norm slots load
        ones."""
        aug = dict(sd)
        for i in range(spec.num_layers):
            aug[f"{cls.hf_prefix}.layers.{i}.input_layernorm.weight"] = \
                np.ones((spec.hidden_size,), np.float32)
        return super().convert_hf_state_dict(aug, spec)

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """The output norms and the full-width q / k norms (placed like
        the q and the kv projections' outputs)."""
        g, D = spec.gqa, spec.head_dim
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "post_attn_norm": layer_stack(
                lp + "post_attention_layernorm.weight", np.asarray),
            "post_ff_norm": layer_stack(
                lp + "post_feedforward_layernorm.weight", np.asarray),
            "q_norm": layer_stack(
                lp + "self_attn.q_norm.weight",
                lambda w: place_q_weight(np.asarray(w), g, D)),
            "k_norm": layer_stack(
                lp + "self_attn.k_norm.weight",
                lambda w: replicate_kv_weight(np.asarray(w), g, D)),
        }


def TpuOlmo2ForCausalLM(model_path: str, config: InferenceConfig,
                        device: DeviceLike = None):
    """The contiguous-cache application over the OLMo-2 family, as the JAX
    entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Olmo2Family,
                               device=device)
