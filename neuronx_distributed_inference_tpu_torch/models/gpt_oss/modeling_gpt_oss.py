"""GPT-OSS family (counterpart:
``neuronx_distributed_inference_tpu/models/gpt_oss/modeling_gpt_oss.py``).

The base decoder with these spec knobs:
  * learned per-head attention sinks (``attn_sink``);
  * alternating sliding / full attention from ``layer_types``
    (``layer_pattern``; sliding first when the config has no list);
  * YaRN RoPE (``ops/rope.py``);
  * q/k/v and o projection biases;
  * an MoE in every layer: top-k on the router logits with the router
    bias in them, softmax over the k, clamped-swiglu experts with
    per-expert biases (``glu_style="oss_clamp"``).

The converter reads the HF layout (a fused ``gate_up_proj`` (E, H, 2I),
gate and up interleaved on the last axis) stored in bf16 or as the
checkpoint's native MXFP4 ``*_blocks`` / ``*_scales``
(``modules/quantization.dequant_oai_mxfp4_blocks``). With ``quantized=True,
quantization_dtype="mxfp4"`` the application re-packs the decoded experts
(and ``o_proj``) into in-graph MXFP4 leaf-groups through
``quantization.quantize_params``, as the reference does (its docstring
:12-16); the products dequantize them (``modules/moe.py``).

``TpuGptOssForCausalLM`` builds the contiguous app as the reference's
does; above ``seq_len = sliding_window`` that app keeps the mixed
per-layer cache (the local layers' rows roll at the window,
``modules/kv_cache.init_mixed_cache``). The paged app
(``PagedCausalLMApplication``) serves every ``seq_len`` over the ordinary
block cache, as the reference's does."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ...modules.quantization import dequant_oai_mxfp4_blocks
from ...parallel.layers import place_q_weight
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, spec_from_config


class GptOssInferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "num_local_experts", "num_experts_per_tok", "sliding_window"]


@register_family("gpt_oss")
class GptOssFamily(DecoderFamily):
    config_cls = GptOssInferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        layer_types = getattr(config, "layer_types", None)
        if layer_types is None:
            layer_types = ["sliding_attention" if (i + 1) % 2 else
                           "full_attention"
                           for i in range(config.num_hidden_layers)]
        pattern = tuple(t == "sliding_attention" for t in layer_types)
        moe = MoESpec(
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            intermediate_size=config.intermediate_size,
            normalize_topk=False,
            pre_softmax_topk=True,       # top-k on logits, softmax over k
            has_router_bias=True,
            router_bias_mode="logits",
            expert_bias=True,
            glu_style="oss_clamp",
        )
        bias = bool(getattr(config, "attention_bias", True))
        return spec_from_config(
            config, tp_degree, sliding_window=int(config.sliding_window),
            layer_pattern=pattern, attn_sink=True, qkv_bias=bias,
            o_bias=bias, moe=moe)

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        """Per layer: the fused ``gate_up_proj`` (E, H, 2I) split into
        gate (``::2``) and up (``1::2``), ``down_proj`` (E, I, H), their
        biases, and the router (E, H) transposed to fp32 (H, E) with its
        fp32 bias. Expert tensors come as stored, or decoded from the
        native MXFP4 blocks + scales (value axis last: (E, out, K) ->
        (E, K, out))."""
        p = cls.hf_prefix

        def expert_tensor(i: int, name: str) -> np.ndarray:
            base = f"{p}.layers.{i}.mlp.experts.{name}"
            try:
                return np.asarray(get(base)).astype(np.float32)
            except KeyError:
                deq = dequant_oai_mxfp4_blocks(get(base + "_blocks"),
                                               get(base + "_scales"))
                return np.ascontiguousarray(np.swapaxes(deq, -1, -2))

        out: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("router", "router_bias", "expert_gate",
                            "expert_up", "expert_down", "expert_gate_bias",
                            "expert_up_bias", "expert_down_bias")}
        for i in range(spec.num_layers):
            ex = f"{p}.layers.{i}.mlp.experts."
            gu = expert_tensor(i, "gate_up_proj")               # (E, H, 2I)
            gub = np.asarray(get(ex + "gate_up_proj_bias"))
            out["expert_gate"].append(np.ascontiguousarray(gu[..., 0::2]))
            out["expert_up"].append(np.ascontiguousarray(gu[..., 1::2]))
            out["expert_down"].append(expert_tensor(i, "down_proj"))
            out["expert_gate_bias"].append(
                np.ascontiguousarray(gub[..., 0::2]))
            out["expert_up_bias"].append(np.ascontiguousarray(gub[..., 1::2]))
            out["expert_down_bias"].append(
                np.asarray(get(ex + "down_proj_bias")))
            router = f"{p}.layers.{i}.mlp.router."
            out["router"].append(np.ascontiguousarray(
                np.asarray(get(router + "weight")).T.astype(np.float32)))
            out["router_bias"].append(
                np.asarray(get(router + "bias")).astype(np.float32))
        return {k: np.stack(v) for k, v in out.items()}

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """The per-q-head sinks, fp32, placed like a q bias."""
        def sink_t(s):
            return place_q_weight(np.asarray(s).astype(np.float32), spec.gqa,
                                  1)
        return {"sink": layer_stack(cls.hf_prefix
                                    + ".layers.{i}.self_attn.sinks", sink_t)}


def TpuGptOssForCausalLM(model_path: str, config: InferenceConfig,
                         device: DeviceLike = None):
    """The contiguous-cache application over the GPT-OSS family, as the
    JAX entry of this name builds it."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, GptOssFamily,
                               device=device)
