"""Gemma-3 family, text (counterpart:
``neuronx_distributed_inference_tpu/models/gemma3/modeling_gemma3.py:30-99``).

The base decoder with these spec knobs:
  * alternating local / global attention from ``layer_types``
    (``layer_pattern``; 5 sliding : 1 full when the config has no list);
  * two rotations: the global layers at ``rope_theta`` (Gemma-3-27B: 1e6,
    linear x8), the local ones at ``rope_local_base_freq`` (1e4) through
    ``local_rope``;
  * sandwich norms (``post_attn_norm`` / ``post_ff_norm``) beside the two
    pre-norms, every norm and the per-head q/k norms in the (1 + w) form
    (``norm_offset=1``);
  * the softmax scale ``query_pre_attn_scalar ** -0.5``, the embeddings
    times sqrt(hidden), gelu-tanh, tied embeddings; the soft-caps when
    the config sets them.

The converter feeds the pre-MLP norm from ``pre_feedforward_layernorm``
and the sandwich norms from ``post_attention_layernorm`` /
``post_feedforward_layernorm``. ``gemma3_text`` is the model_type of a
text-only checkpoint, whose config is flat (``get_text_config`` returns
the config itself, as the base ``InferenceConfig``'s does)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...ops.rope import RopeConfig
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class Gemma3InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "head_dim", "sliding_window"]


def gemma_layer_pattern(config: InferenceConfig, every: int):
    """Local (True) / global per layer from ``layer_types``, else every
    ``sliding_window_pattern``-th layer (default ``every``) global."""
    layer_types = getattr(config, "layer_types", None)
    if layer_types is None:
        n = getattr(config, "sliding_window_pattern", every)
        layer_types = ["sliding_attention" if (i + 1) % n else
                       "full_attention"
                       for i in range(config.num_hidden_layers)]
    return tuple(t == "sliding_attention" for t in layer_types)


def gemma_knobs(config: InferenceConfig) -> dict:
    """The knobs Gemma-2 and Gemma-3 share."""
    scalar = float(getattr(config, "query_pre_attn_scalar",
                           config.head_dim))
    return dict(
        sliding_window=int(config.sliding_window),
        sandwich_norm=True,
        norm_offset=1.0,
        attn_scale=scalar ** -0.5,
        embed_scale=math.sqrt(config.hidden_size),
        act=getattr(config, "hidden_activation", "gelu_pytorch_tanh"),
        # HF omits a default True from config.json
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                         True)))


@register_family("gemma3", "gemma3_text")
class Gemma3Family(DecoderFamily):
    config_cls = Gemma3InferenceConfig
    post_norm_src = "pre_feedforward_layernorm"

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        local_rope = RopeConfig(
            head_dim=config.head_dim,
            rope_theta=float(getattr(config, "rope_local_base_freq",
                                     10000.0)))
        return spec_from_config(
            config, tp_degree, layer_pattern=gemma_layer_pattern(config, 6),
            local_rope=local_rope, qk_norm=True,
            logits_soft_cap=getattr(config, "final_logit_softcapping", None),
            attn_soft_cap=getattr(config, "attn_logit_softcapping", None),
            **gemma_knobs(config))

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """The sandwich norms."""
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "post_attn_norm": layer_stack(
                lp + "post_attention_layernorm.weight", np.asarray),
            "post_ff_norm": layer_stack(
                lp + "post_feedforward_layernorm.weight", np.asarray),
        }


def TpuGemma3ForCausalLM(model_path: str, config: InferenceConfig,
                         device: DeviceLike = None):
    """The contiguous-cache application over the Gemma-3 family, as the
    JAX entry of this name builds it; above ``seq_len = sliding_window``
    it keeps the mixed per-layer cache."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Gemma3Family,
                               device=device)
