"""Llama4 (Scout / Maverick) text family (counterpart:
``neuronx_distributed_inference_tpu/models/llama4/modeling_llama4.py`` —
``Llama4InferenceConfig`` :39, ``Llama4Family`` :51-188).

Every delta from the Llama decoder is a ``DecoderSpec`` knob
(``models/model_base.py``):

  * the layer pattern from ``no_rope_layers`` (else every
    ``no_rope_layer_interval``-th layer): RoPE layers are local and
    attend within their chunk of ``attention_chunk_size`` positions
    (``attn_chunk``), the others are NoPE global layers over the whole
    context (``nope_global``);
  * the weightless q/k norm after RoPE on the RoPE layers
    (``qk_l2_norm``) and the NoPE layers' attention temperature
    (``attn_temp``: ``floor_scale``, ``attn_scale``);
  * RoPE in the interleaved pairing (``rope_interleaved``), with the
    config's scaling (llama3 for Scout);
  * interleaved dense / MoE layers (``moe_pattern`` from ``moe_layers``,
    else every ``interleave_moe_layer_step``-th layer): the sigmoid of the
    top-1 router logit scales the expert's INPUT (``input_scaled``), plus a
    shared expert of the expert width; dense layers are
    ``intermediate_size_mlp`` wide.

The attention-chunk term keeps every layer off the three kernels (the
decode gates and the flash gate refuse ``attn_chunk``), as in the
reference: a Llama4 stack takes the gather path. The vision tower
(``Llama4VLApplication``) is not ported (ROADMAP A14e)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...config import InferenceConfig
from ...device import DeviceLike
from ...modules.moe import MoESpec
from ...parallel.layers import place_q_weight, replicate_kv_weight
from ..family import DecoderFamily, register_family
from ..model_base import DecoderSpec, layer_plan, spec_from_config


class Llama4InferenceConfig(InferenceConfig):
    def get_required_attributes(self) -> List[str]:
        return ["hidden_size", "num_attention_heads", "num_hidden_layers",
                "num_key_value_heads", "vocab_size", "intermediate_size",
                "intermediate_size_mlp", "num_local_experts",
                "num_experts_per_tok"]

    def get_text_config(self):
        return self


@register_family("llama4_text", "llama4")
class Llama4Family(DecoderFamily):
    config_cls = Llama4InferenceConfig

    @classmethod
    def build_spec(cls, config: InferenceConfig,
                   tp_degree: Optional[int] = None) -> DecoderSpec:
        L = config.num_hidden_layers
        # RoPE (local) layers from no_rope_layers, else every
        # no_rope_layer_interval-th layer NoPE; MoE layers from moe_layers,
        # else every interleave_moe_layer_step-th (counterpart :57-70)
        no_rope = getattr(config, "no_rope_layers", None)
        if not no_rope:
            interval = getattr(config, "no_rope_layer_interval", 4)
            no_rope = [int((i + 1) % interval != 0) for i in range(L)]
        moe_layers = getattr(config, "moe_layers", None)
        if moe_layers is None:
            step = getattr(config, "interleave_moe_layer_step", 1)
            moe_layers = range(step - 1, L, step)
        moe_set = {int(i) for i in moe_layers}
        moe = MoESpec(
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            intermediate_size=config.intermediate_size,
            normalize_topk=False,
            router_act="sigmoid",
            input_scaled=True,
            shared_intermediate=config.intermediate_size,
            act=getattr(config, "hidden_act", "silu"),
        ) if moe_set else None
        temp = ((float(getattr(config, "floor_scale", 8192)),
                 float(getattr(config, "attn_scale", 0.1)))
                if getattr(config, "attn_temperature_tuning", True) else None)
        return spec_from_config(
            config, tp_degree,
            intermediate_size=config.intermediate_size_mlp,
            layer_pattern=tuple(bool(r) for r in no_rope),
            attn_chunk=int(getattr(config, "attention_chunk_size", 8192)
                           or 0),
            nope_global=True,
            qk_l2_norm=bool(getattr(config, "use_qk_norm", True)),
            attn_temp=temp,
            rope_interleaved=True,
            moe=moe,
            moe_pattern=(tuple(i in moe_set for i in range(L)) if moe_set
                         else None),
            qkv_bias=bool(getattr(config, "attention_bias", False)),
        )

    @classmethod
    def convert_hf_state_dict(cls, sd: Dict[str, np.ndarray],
                              spec: DecoderSpec) -> Dict[str, Any]:
        """HF names -> the dense stack ``"layers"`` and the MoE stack
        ``"moe_layers"``, each in order of appearance (counterpart
        :100-188). The experts are stored fused and already (in, out):
        ``gate_up_proj`` (E, H, 2I) split at I, ``down_proj`` (E, I, H)
        kept as stored."""
        p = cls.hf_prefix
        g, D = spec.gqa, spec.head_dim

        def get(name):
            if name in sd:
                return np.asarray(sd[name])
            raise KeyError(f"missing checkpoint tensor {name}")

        def t(w):
            return np.ascontiguousarray(np.asarray(w).T)

        def attn_layer(i: int) -> Dict[str, np.ndarray]:
            a = f"{p}.layers.{i}.self_attn."
            return {
                "input_norm": get(f"{p}.layers.{i}.input_layernorm.weight"),
                "q_proj": place_q_weight(t(get(a + "q_proj.weight")), g, D,
                                         axis=-1),
                "k_proj": replicate_kv_weight(t(get(a + "k_proj.weight")),
                                              g, D, axis=-1),
                "v_proj": replicate_kv_weight(t(get(a + "v_proj.weight")),
                                              g, D, axis=-1),
                "o_proj": place_q_weight(t(get(a + "o_proj.weight")), g, D,
                                         axis=0),
                "post_norm": get(
                    f"{p}.layers.{i}.post_attention_layernorm.weight"),
            }

        def dense_layer(i: int) -> Dict[str, np.ndarray]:
            out = attn_layer(i)
            for name in ("gate_proj", "up_proj", "down_proj"):
                out[name] = t(get(f"{p}.layers.{i}.feed_forward.{name}"
                                  ".weight"))
            return out

        def moe_layer(i: int) -> Dict[str, np.ndarray]:
            out = attn_layer(i)
            ff = f"{p}.layers.{i}.feed_forward."
            gate_up = get(ff + "experts.gate_up_proj")          # (E, H, 2I)
            inter = spec.moe.intermediate_size
            out.update({
                "router": t(get(ff + "router.weight")).astype(np.float32),
                "expert_gate": np.ascontiguousarray(gate_up[..., :inter]),
                "expert_up": np.ascontiguousarray(gate_up[..., inter:]),
                "expert_down": get(ff + "experts.down_proj"),   # (E, I, H)
            })
            for key, name in (("shared_gate", "gate_proj"),
                              ("shared_up", "up_proj"),
                              ("shared_down", "down_proj")):
                out[key] = t(get(ff + f"shared_expert.{name}.weight"))
            return out

        def vpad(w):
            if w.shape[0] < spec.padded_vocab:
                w = np.pad(w, [(0, spec.padded_vocab - w.shape[0])]
                           + [(0, 0)] * (w.ndim - 1))
            return w

        out: Dict[str, Any] = {
            "embed": vpad(get(p + ".embed_tokens.weight")),
            "final_norm": get(p + ".norm.weight"),
        }
        convert = {"dense": dense_layer, "moe": moe_layer}
        stacks: Dict[str, list] = {}
        for key, i, _, kind in layer_plan(spec):
            stacks.setdefault(key, []).append(convert[kind](i))
        for key, layers in stacks.items():
            out[key] = {k: np.stack([d[k] for d in layers])
                        for k in layers[0]}
        if not spec.tie_word_embeddings:
            out["lm_head"] = np.ascontiguousarray(
                vpad(get("lm_head.weight")).T)
        return out


def TpuLlama4ForCausalLM(model_path: str, config: InferenceConfig,
                         device: DeviceLike = None):
    """The contiguous-cache application over the Llama4 text family."""
    from ..application import CausalLMApplication
    return CausalLMApplication(model_path, config, Llama4Family,
                               device=device)
