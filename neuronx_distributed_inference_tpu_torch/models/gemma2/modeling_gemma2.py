"""Gemma-2 family (counterpart:
``neuronx_distributed_inference_tpu/models/gemma2/modeling_gemma2.py:22-61``).
Gemma-3's sibling: the same sandwich norms, (1 + w) RMSNorm, sqrt(hidden)
embedding scale and alternating sliding / full layers (sliding first), but
one rotation, no q/k norms, and tanh soft-caps on the attention scores
(``attn_logit_softcapping``, 50) and on the final logits
(``final_logit_softcapping``, 30)."""

from __future__ import annotations

from typing import List, Optional

from ...config import InferenceConfig
from ...device import DeviceLike
from ..family import DecoderFamily, register_family
from ..gemma3.modeling_gemma3 import (Gemma3Family, gemma_knobs,
                                      gemma_layer_pattern)
from ..model_base import DecoderSpec, spec_from_config


class Gemma2InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "head_dim", "sliding_window"]


@register_family("gemma2")
class Gemma2Family(DecoderFamily):
    config_cls = Gemma2InferenceConfig
    post_norm_src = "pre_feedforward_layernorm"
    # the sandwich norms load as Gemma-3's
    convert_extra_layer_weights = Gemma3Family.convert_extra_layer_weights

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        return spec_from_config(
            config, tp_degree, layer_pattern=gemma_layer_pattern(config, 2),
            logits_soft_cap=getattr(config, "final_logit_softcapping", 30.0),
            attn_soft_cap=getattr(config, "attn_logit_softcapping", 50.0),
            **gemma_knobs(config))


def TpuGemma2ForCausalLM(model_path: str, config: InferenceConfig,
                         device: DeviceLike = None):
    """The contiguous-cache application over the Gemma-2 family, as the
    JAX entry of this name builds it; above ``seq_len = sliding_window``
    it keeps the mixed per-layer cache."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Gemma2Family,
                               device=device)
