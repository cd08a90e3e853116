"""Model-family protocol (counterpart:
``neuronx_distributed_inference_tpu/models/family.py:26-206``).

A family is a class with ``config_cls``, ``build_spec(config)`` and
``convert_hf_state_dict(sd, spec)`` (HF numpy state dict -> the stacked
host parameter tree). The port carries the Llama-shaped decoder: the
Llama, Mistral, Qwen3, Qwen2, Granite, Phi-3, OLMo-2, Gemma-2 and Gemma-3
families (dense), the Qwen3-MoE, Mixtral, GPT-OSS and DBRX families (MoE),
DeepSeek (MLA, a mixed dense / MoE stack, its own converter), Llama4
text (chunked attention, NoPE layers, interleaved dense / MoE) and the
contrib hub's families (``contrib``: GPT-2, GPT-NeoX, Falcon, StarCoder2,
Phi, Gemma, OLMo, GLM-4, StableLM, Cohere; ``contrib2``: HunYuan-Dense,
BLOOM, MPT, Persimmon and the MoE ones GraniteMoE, OLMoE, GLM-4-MoE,
dots.llm1; ``contrib3``: openai-gpt, Apertus, Phi-3.5-MoE). Families
override the reference's hooks ``convert_mlp_weights`` (the MoE families,
through ``convert_moe_weights`` or their own layout),
``convert_extra_layer_weights`` (GPT-OSS: sinks; Gemma: the sandwich
norms; OLMo-2: those and its full-width q/k norms) and the HF names that
feed the two block norms, ``input_norm_src`` and ``post_norm_src``
(family.py:53-61; Gemma feeds the pre-MLP norm from
``pre_feedforward_layernorm``) and the attention's output projection,
``attn_o_src`` (Phi's ``self_attn.dense``); the per-head q/k norms and
the q/k/v and o biases (family.py:120-132) convert when the spec has
them."""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np

from ..config import InferenceConfig
from ..parallel.layers import place_q_weight, replicate_kv_weight
from .model_base import DecoderSpec, spec_from_config

_REGISTRY: Dict[str, Type["DecoderFamily"]] = {}


def register_family(*names: str):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        cls.family_names = names
        return cls
    return deco


def get_family(name: str) -> Type["DecoderFamily"]:
    # their imports register them
    from . import (contrib, contrib2, contrib3, dbrx, deepseek,  # noqa: F401
                   gemma2, gemma3, gpt_oss, granite, llama, llama4,
                   mistral, mixtral, olmo2, phi3, qwen2, qwen3, qwen3_moe)
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def family_for_config(config) -> Type["DecoderFamily"]:
    return get_family(getattr(config, "model_type", None))


class DecoderFamily:
    """The standard Llama-shaped decoder."""

    family_names = ()
    config_cls: Type[InferenceConfig] = InferenceConfig
    hf_prefix = "model"
    # the HF norm weight feeding the pre-attention norm ("input_norm")
    input_norm_src = "input_layernorm"
    # the HF norm weight feeding the pre-MLP norm ("post_norm");
    # sandwich-norm families point it at pre_feedforward_layernorm
    post_norm_src = "post_attention_layernorm"
    # the HF module of the attention's output projection
    attn_o_src = "self_attn.o_proj"

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        return spec_from_config(config, tp_degree)

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """HF names/layouts -> stacked host tree. torch Linear stores
        (out, in); the tree stores (in, out) so matmuls read x @ w. q/k/v
        stay separate here (fused by ``model_base.fuse_qkv_host``)."""
        p = cls.hf_prefix
        g = spec.gqa
        D = spec.head_dim

        def get(name):
            if name in sd:
                return np.asarray(sd[name])
            raise KeyError(f"missing checkpoint tensor {name}; have "
                           f"{sorted(sd)[:8]}...")

        def layer_stack(fmt, transform):
            return np.stack([transform(get(fmt.format(i=i)))
                             for i in range(spec.num_layers)])

        def t(w):
            return np.ascontiguousarray(w.T)

        def q_t(w):
            return place_q_weight(t(w), g, D, axis=-1)

        def kv_t(w):
            return replicate_kv_weight(t(w), g, D, axis=-1)

        def o_t(w):
            return place_q_weight(t(w), g, D, axis=0)

        def ident(w):
            return np.asarray(w)

        lp = p + ".layers.{i}."
        layers = {
            "input_norm": layer_stack(lp + cls.input_norm_src + ".weight",
                                      ident),
            "q_proj": layer_stack(lp + "self_attn.q_proj.weight", q_t),
            "k_proj": layer_stack(lp + "self_attn.k_proj.weight", kv_t),
            "v_proj": layer_stack(lp + "self_attn.v_proj.weight", kv_t),
            "o_proj": layer_stack(lp + cls.attn_o_src + ".weight", o_t),
            "post_norm": layer_stack(lp + cls.post_norm_src + ".weight",
                                     ident),
        }
        layers.update(cls.convert_mlp_weights(get, layer_stack, spec))
        layers.update(cls.convert_extra_layer_weights(get, layer_stack,
                                                      spec))
        if spec.qkv_bias:
            # fused into qkv_bias by model_base.fuse_qkv_host
            layers["q_bias"] = layer_stack(
                lp + "self_attn.q_proj.bias",
                lambda b: place_q_weight(np.asarray(b), g, D))
            for name in ("k", "v"):
                layers[name + "_bias"] = layer_stack(
                    lp + f"self_attn.{name}_proj.bias",
                    lambda b: replicate_kv_weight(np.asarray(b), g, D))
        if spec.o_bias:
            layers["o_bias"] = layer_stack(lp + cls.attn_o_src + ".bias",
                                           ident)
        if spec.qk_norm:
            layers["q_norm"] = layer_stack(lp + "self_attn.q_norm.weight",
                                           ident)
            layers["k_norm"] = layer_stack(lp + "self_attn.k_norm.weight",
                                           ident)

        def vpad(w):
            if w.shape[0] < spec.padded_vocab:
                w = np.pad(w, [(0, spec.padded_vocab - w.shape[0])]
                           + [(0, 0)] * (w.ndim - 1))
            return w

        out = {"embed": vpad(get(p + ".embed_tokens.weight")),
               "layers": layers,
               "final_norm": get(p + ".norm.weight")}
        if not spec.tie_word_embeddings:
            out["lm_head"] = np.ascontiguousarray(
                vpad(get("lm_head.weight")).T)
        return out

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec: DecoderSpec
                                    ) -> Dict[str, np.ndarray]:
        """Per-layer weights beyond the standard block (none here)."""
        return {}

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec: DecoderSpec
                            ) -> Dict[str, np.ndarray]:
        """The dense gate / up / down projections; MoE families override
        this with :meth:`convert_moe_weights`."""
        lp = cls.hf_prefix + ".layers.{i}.mlp."

        def t(w):
            return np.ascontiguousarray(w.T)
        return {name: layer_stack(lp + name + ".weight", t)
                for name in ("gate_proj", "up_proj", "down_proj")}

    @classmethod
    def convert_moe_weights(cls, get, spec: DecoderSpec, router_name: str,
                            expert_fmt: str, gate: str, up: str, down: str
                            ) -> Dict[str, np.ndarray]:
        """Per-layer routers, fp32 and transposed to (H, E), and the
        per-layer, per-expert projections stacked to (L, E, in, out). Name
        templates use {i} (layer), {e} (expert) and {name} (projection)."""
        L, E = spec.num_layers, spec.moe.num_experts

        def experts(name):
            return np.stack([
                np.stack([np.ascontiguousarray(np.asarray(get(
                    expert_fmt.format(i=i, e=e, name=name))).T)
                    for e in range(E)]) for i in range(L)])

        return {
            "router": np.stack([np.ascontiguousarray(np.asarray(get(
                router_name.format(i=i))).T.astype(np.float32))
                for i in range(L)]),
            "expert_gate": experts(gate),
            "expert_up": experts(up),
            "expert_down": experts(down),
        }
