"""The contrib model hub's first wave and its helpers (counterpart:
``neuronx_distributed_inference_tpu/models/contrib.py`` — ``_SimpleConfig``
:23, ``_t`` :31, ``_ident`` :35, ``_split_interleaved_qkv`` :39,
``GPT2Family`` :72, ``GPTNeoXFamily`` :176, ``FalconFamily`` :253,
``Starcoder2Family`` :382, ``PhiFamily`` :435, ``GemmaFamily`` :504,
``OlmoFamily`` :525, ``Glm4Family`` :559, ``StableLmFamily`` :618,
``CohereFamily`` :660, ``_vpad`` :686, ``_vpad1`` :692).

The hub's families are thin ``DecoderSpec`` mappings plus checkpoint
conversion over the shared layer machinery, each with the decoder knobs
it needs:

  * GPT-2: learned positions (``learned_pos``, no rotation), the fused
    Conv1D ``c_attn`` (already (in, out)), a plain biased MLP, LayerNorms
    with biases, tied embeddings;
  * GPT-NeoX (Pythia): the per-head-interleaved fused QKV, partial rotary
    (``rotary_pct`` of the head), the ``parallel_dual`` residual (its MLP
    norm over the block input), a plain biased MLP, an untied head;
  * Falcon: the grouped fused QKV (each KV group's q heads, then its k and
    v), multi-query at 7B; ``parallel_shared`` (one norm for both blocks)
    in the old architecture, ``parallel_dual`` in the new one;
  * StarCoder2, Phi (``parallel_shared``, partial rotary, the lm-head
    bias), Gemma (Gemma-2's (1 + w) norms and embedding scale), OLMo
    (bias-free, weight-free LayerNorms and the q/k/v clamp), GLM-4 (a fused
    ``gate_up_proj``, sandwich norms, interleaved partial rotary), StableLM
    (partial rotary, biased LayerNorms) and Cohere (``parallel_shared``,
    a bias-free LayerNorm, the logit scale).

The later waves live in ``contrib2`` / ``contrib3``."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..config import InferenceConfig
from ..parallel.layers import place_q_weight, replicate_kv_weight
from .family import DecoderFamily, register_family
from .model_base import spec_from_config


class _SimpleConfig(InferenceConfig):
    """A config that only requires ``vocab_size``; the family's
    ``build_spec`` reads what it needs with defaults."""

    def get_required_attributes(self) -> List[str]:
        return ["vocab_size"]

    def get_text_config(self):
        return self


def _t(w):
    """A torch Linear weight (out, in) as the tree's (in, out)."""
    return np.ascontiguousarray(np.asarray(w).T)


def _ident(w):
    return np.asarray(w)


def _vpad(w: np.ndarray, padded: int) -> np.ndarray:
    """Rows (the vocabulary axis) zero-padded up to ``padded``."""
    if w.shape[0] < padded:
        w = np.pad(w, [(0, padded - w.shape[0])] + [(0, 0)] * (w.ndim - 1))
    return w


def _vpad1(b: np.ndarray, padded: int) -> np.ndarray:
    """A vocabulary-long bias zero-padded up to ``padded``."""
    if b.shape[0] < padded:
        b = np.pad(b, (0, padded - b.shape[0]))
    return b


def _split_interleaved_qkv(get, key_fmt, num_layers, nh, g, D,
                           with_bias=True):
    """A per-head-interleaved fused QKV stack, (nh, 3, D, H) per layer (the
    GPT-NeoX / BLOOM / Persimmon layout), as the placed fused ``qkv_proj``
    (and ``qkv_bias``) stacks (counterpart :39-69)."""
    qs, ks, vs, qb, kb, vb = [], [], [], [], [], []
    for i in range(num_layers):
        w = np.asarray(get(key_fmt.format(i=i) + ".weight"))
        w = w.reshape(nh, 3, D, -1)
        qs.append(place_q_weight(_t(w[:, 0].reshape(nh * D, -1)), g, D,
                                 axis=-1))
        ks.append(replicate_kv_weight(_t(w[:, 1].reshape(nh * D, -1)), g, D,
                                      axis=-1))
        vs.append(replicate_kv_weight(_t(w[:, 2].reshape(nh * D, -1)), g, D,
                                      axis=-1))
        if with_bias:
            b = np.asarray(get(key_fmt.format(i=i) + ".bias")).reshape(
                nh, 3, D)
            qb.append(place_q_weight(b[:, 0].reshape(-1), g, D))
            kb.append(replicate_kv_weight(b[:, 1].reshape(-1), g, D))
            vb.append(replicate_kv_weight(b[:, 2].reshape(-1), g, D))
    out = {"qkv_proj": np.concatenate(
        [np.stack(qs), np.stack(ks), np.stack(vs)], axis=-1)}
    if with_bias:
        out["qkv_bias"] = np.concatenate(
            [np.stack(qb), np.stack(kb), np.stack(vb)], axis=-1)
    return out


def _up_down(cls, layer_stack, bias: bool = False):
    """A plain MLP's ``up_proj`` / ``down_proj`` (and their biases) in the
    gate / down slots, through the base converter's ``layer_stack``."""
    lp = cls.hf_prefix + ".layers.{i}.mlp."
    out = {"gate_proj": layer_stack(lp + "up_proj.weight", _t),
           "down_proj": layer_stack(lp + "down_proj.weight", _t)}
    if bias:
        out["gate_bias"] = layer_stack(lp + "up_proj.bias", _ident)
        out["down_bias"] = layer_stack(lp + "down_proj.bias", _ident)
    return out


def _stacker(sd, num_layers):
    """(get, stack): a checkpoint tensor as numpy, and a per-layer name
    template ({i}) stacked through a transform."""
    def get(n):
        return np.asarray(sd[n])

    def stack(fmt, tr):
        return np.stack([tr(get(fmt.format(i=i))) for i in range(num_layers)])
    return get, stack


@register_family("gpt2")
class GPT2Family(DecoderFamily):
    """GPT-2: learned positions, the fused Conv1D ``c_attn``, a plain gelu
    MLP with biases, LayerNorms with biases, tied embeddings."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.n_embd
        nh = config.n_head
        inner = getattr(config, "n_inner", None) or 4 * H
        return spec_from_config(
            config, tp_degree,
            num_layers=config.n_layer,
            hidden_size=H,
            num_q_heads=nh,
            num_kv_heads=nh,
            head_dim=H // nh,
            intermediate_size=inner,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act={"gelu_new": "gelu_new", "gelu": "gelu",
                 "gelu_pytorch_tanh": "gelu_pytorch_tanh"}.get(
                getattr(config, "activation_function", "gelu_new"),
                "gelu_new"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            no_rope=True,
            learned_pos=int(getattr(config, "n_positions", 1024)),
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        """Conv1D weights are already (in, out): ``c_attn`` splits into its
        q / k / v thirds, ``c_proj`` has its input axis placed."""
        g, D = spec.gqa, spec.head_dim
        H = spec.hidden_size
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        qs, ks, vs, qb, kb, vb = [], [], [], [], [], []
        for i in range(spec.num_layers):
            w = get(f"{p}.h.{i}.attn.c_attn.weight")
            bq, bk, bv = np.split(get(f"{p}.h.{i}.attn.c_attn.bias"), 3)
            qs.append(place_q_weight(w[:, :H], g, D, axis=-1))
            ks.append(replicate_kv_weight(w[:, H:2 * H], g, D, axis=-1))
            vs.append(replicate_kv_weight(w[:, 2 * H:], g, D, axis=-1))
            qb.append(place_q_weight(bq, g, D))
            kb.append(replicate_kv_weight(bk, g, D))
            vb.append(replicate_kv_weight(bv, g, D))
        layers = {
            "input_norm": stack(p + ".h.{i}.ln_1.weight", _ident),
            "input_norm_b": stack(p + ".h.{i}.ln_1.bias", _ident),
            "post_norm": stack(p + ".h.{i}.ln_2.weight", _ident),
            "post_norm_b": stack(p + ".h.{i}.ln_2.bias", _ident),
            "qkv_proj": np.concatenate(
                [np.stack(qs), np.stack(ks), np.stack(vs)], axis=-1),
            "qkv_bias": np.concatenate(
                [np.stack(qb), np.stack(kb), np.stack(vb)], axis=-1),
            "o_proj": stack(p + ".h.{i}.attn.c_proj.weight",
                            lambda w: place_q_weight(w, g, D, axis=0)),
            "o_bias": stack(p + ".h.{i}.attn.c_proj.bias", _ident),
            "gate_proj": stack(p + ".h.{i}.mlp.c_fc.weight", _ident),
            "gate_bias": stack(p + ".h.{i}.mlp.c_fc.bias", _ident),
            "down_proj": stack(p + ".h.{i}.mlp.c_proj.weight", _ident),
            "down_bias": stack(p + ".h.{i}.mlp.c_proj.bias", _ident),
        }
        return {
            "embed": _vpad(get(p + ".wte.weight"), spec.padded_vocab),
            "pos_embed": get(p + ".wpe.weight"),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
        }


@register_family("gpt_neox")
class GPTNeoXFamily(DecoderFamily):
    """GPT-NeoX / Pythia: the per-head-interleaved fused QKV, partial
    rotary, the parallel-dual residual, a plain gelu MLP with biases,
    LayerNorms with biases, an untied ``embed_out`` head."""
    config_cls = _SimpleConfig
    hf_prefix = "gpt_neox"

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = H // nh
        return spec_from_config(
            config, tp_degree,
            num_kv_heads=nh,
            head_dim=hd,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            act=getattr(config, "hidden_act", "gelu"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True,
            rotary_dim=int(hd * getattr(config, "rotary_pct", 0.25)),
            block_style=("parallel_dual"
                         if getattr(config, "use_parallel_residual", True)
                         else "sequential"),
            tie_word_embeddings=False,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        g, D = spec.gqa, spec.head_dim
        p = cls.hf_prefix
        get, stack = _stacker(sd, spec.num_layers)
        lp = p + ".layers.{i}."
        layers = {
            "input_norm": stack(lp + "input_layernorm.weight", _ident),
            "input_norm_b": stack(lp + "input_layernorm.bias", _ident),
            "post_norm": stack(lp + "post_attention_layernorm.weight",
                               _ident),
            "post_norm_b": stack(lp + "post_attention_layernorm.bias",
                                 _ident),
            **_split_interleaved_qkv(get, lp + "attention.query_key_value",
                                     spec.num_layers, spec.num_q_heads, g,
                                     D),
            "o_proj": stack(lp + "attention.dense.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "o_bias": stack(lp + "attention.dense.bias", _ident),
            "gate_proj": stack(lp + "mlp.dense_h_to_4h.weight", _t),
            "gate_bias": stack(lp + "mlp.dense_h_to_4h.bias", _ident),
            "down_proj": stack(lp + "mlp.dense_4h_to_h.weight", _t),
            "down_bias": stack(lp + "mlp.dense_4h_to_h.bias", _ident),
        }
        return {
            "embed": _vpad(get(p + ".embed_in.weight"), spec.padded_vocab),
            "layers": layers,
            "final_norm": get(p + ".final_layer_norm.weight"),
            "final_norm_b": get(p + ".final_layer_norm.bias"),
            "lm_head": _t(_vpad(get("embed_out.weight"), spec.padded_vocab)),
        }


@register_family("falcon")
class FalconFamily(DecoderFamily):
    """Falcon: the grouped fused QKV, the parallel-shared residual
    (Falcon-7B: one norm for both blocks) or parallel-dual (the new
    architecture of Falcon-40B / 180B: ``ln_attn`` and ``ln_mlp``, both
    over the block input), a plain gelu MLP, LayerNorms with biases."""
    config_cls = _SimpleConfig
    hf_prefix = "transformer"

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.hidden_size
        nh = config.num_attention_heads
        new_arch = bool(getattr(config, "new_decoder_architecture", False))
        n_kv = (config.num_kv_heads if new_arch
                else (1 if getattr(config, "multi_query", True) else nh))
        if new_arch:
            style = "parallel_dual"
        elif getattr(config, "parallel_attn", True):
            style = "parallel_shared"
        else:
            style = "sequential"
        bias = bool(getattr(config, "bias", False))
        return spec_from_config(
            config, tp_degree,
            num_kv_heads=n_kv,
            head_dim=H // nh,
            intermediate_size=getattr(config, "ffn_hidden_size", None)
            or 4 * H,
            rms_eps=float(getattr(config, "layer_norm_epsilon", 1e-5)),
            act="gelu",
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=bias, qkv_bias=bias, o_bias=bias,
            block_style=style,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        """The fused layout (nkv, G + 2, D, H): each KV group's q heads,
        then its k and its v. Falcon-7B's unused ``post_norm`` is ones and
        zeros (the parallel-shared block never reads it)."""
        g, D = spec.gqa, spec.head_dim
        nh, nkv = spec.num_q_heads, spec.num_kv_heads
        p = cls.hf_prefix
        L, H = spec.num_layers, spec.hidden_size
        get, stack = _stacker(sd, L)
        gsize = nh // nkv
        qs, ks, vs = [], [], []
        for i in range(L):
            w = get(f"{p}.h.{i}.self_attention.query_key_value.weight")
            w = w.reshape(nkv, gsize + 2, D, -1)
            qs.append(place_q_weight(
                _t(w[:, :gsize].reshape(nkv * gsize * D, -1)), g, D,
                axis=-1))
            ks.append(replicate_kv_weight(
                _t(w[:, gsize].reshape(nkv * D, -1)), g, D, axis=-1))
            vs.append(replicate_kv_weight(
                _t(w[:, gsize + 1].reshape(nkv * D, -1)), g, D, axis=-1))
        new_arch = any(".ln_attn." in k for k in sd)
        ln = "ln_attn" if new_arch else "input_layernorm"
        if new_arch:
            post_norm = stack(p + ".h.{i}.ln_mlp.weight", _ident)
            post_norm_b = stack(p + ".h.{i}.ln_mlp.bias", _ident)
        else:
            post_norm = np.ones((L, H), np.float32)
            post_norm_b = np.zeros((L, H), np.float32)
        layers = {
            "input_norm": stack(p + ".h.{i}." + ln + ".weight", _ident),
            "input_norm_b": stack(p + ".h.{i}." + ln + ".bias", _ident),
            "post_norm": post_norm,
            "post_norm_b": post_norm_b,
            "qkv_proj": np.concatenate(
                [np.stack(qs), np.stack(ks), np.stack(vs)], axis=-1),
            "o_proj": stack(p + ".h.{i}.self_attention.dense.weight",
                            lambda w: place_q_weight(_t(w), g, D, axis=0)),
            "gate_proj": stack(p + ".h.{i}.mlp.dense_h_to_4h.weight", _t),
            "down_proj": stack(p + ".h.{i}.mlp.dense_4h_to_h.weight", _t),
        }
        if spec.qkv_bias:
            qbs, kbs, vbs = [], [], []
            for i in range(L):
                b = get(f"{p}.h.{i}.self_attention.query_key_value.bias")
                b = b.reshape(nkv, gsize + 2, D)
                qbs.append(place_q_weight(b[:, :gsize].reshape(-1), g, D))
                kbs.append(replicate_kv_weight(b[:, gsize].reshape(-1), g,
                                               D))
                vbs.append(replicate_kv_weight(b[:, gsize + 1].reshape(-1),
                                               g, D))
            layers["qkv_bias"] = np.concatenate(
                [np.stack(qbs), np.stack(kbs), np.stack(vbs)], axis=-1)
        if spec.o_bias:
            layers["o_bias"] = stack(p + ".h.{i}.self_attention.dense.bias",
                                     _ident)
        if spec.mlp_bias:
            layers["gate_bias"] = stack(p + ".h.{i}.mlp.dense_h_to_4h.bias",
                                        _ident)
            layers["down_bias"] = stack(p + ".h.{i}.mlp.dense_4h_to_h.bias",
                                        _ident)
        return {
            "embed": _vpad(get(p + ".word_embeddings.weight"),
                           spec.padded_vocab),
            "layers": layers,
            "final_norm": get(p + ".ln_f.weight"),
            "final_norm_b": get(p + ".ln_f.bias"),
        }


@register_family("starcoder2")
class Starcoder2Family(DecoderFamily):
    """StarCoder2: Llama attention with biases, a plain ``c_fc`` /
    ``c_proj`` MLP, LayerNorms with biases."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        bias = bool(getattr(config, "use_bias", True))
        return spec_from_config(
            config, tp_degree,
            rms_eps=float(getattr(config, "norm_epsilon", 1e-5)),
            act=getattr(config, "hidden_act", "gelu_pytorch_tanh"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=bias,
            qkv_bias=bias, o_bias=bias,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             True)),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}.mlp."
        out = {"gate_proj": layer_stack(lp + "c_fc.weight", _t),
               "down_proj": layer_stack(lp + "c_proj.weight", _t)}
        if spec.mlp_bias:
            out["gate_bias"] = layer_stack(lp + "c_fc.bias", _ident)
            out["down_bias"] = layer_stack(lp + "c_proj.bias", _ident)
        return out

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "input_norm_b": layer_stack(lp + "input_layernorm.bias", _ident),
            "post_norm_b": layer_stack(lp + "post_attention_layernorm.bias",
                                       _ident),
        }

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        out = super().convert_hf_state_dict(sd, spec)
        out["final_norm_b"] = np.asarray(sd["model.norm.bias"])
        return out


@register_family("phi")
class PhiFamily(DecoderFamily):
    """Phi-1 / Phi-2: the parallel-shared residual, partial rotary, a plain
    gelu MLP with biases, LayerNorms with biases, a biased lm-head."""
    config_cls = _SimpleConfig
    # Phi has no post_attention_layernorm (the parallel-shared block reads
    # no post_norm) and names its output projection ``dense``
    post_norm_src = "input_layernorm"
    attn_o_src = "self_attn.dense"

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = H // nh
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            act=getattr(config, "hidden_act", "gelu_new"),
            norm_type="layernorm", norm_bias=True,
            mlp_glu=False, mlp_bias=True,
            qkv_bias=True, o_bias=True, lm_head_bias=True,
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.5)),
            block_style="parallel_shared",
            tie_word_embeddings=False,
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}.mlp."
        return {"gate_proj": layer_stack(lp + "fc1.weight", _t),
                "gate_bias": layer_stack(lp + "fc1.bias", _ident),
                "down_proj": layer_stack(lp + "fc2.weight", _t),
                "down_bias": layer_stack(lp + "fc2.bias", _ident)}

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec):
        L, H = spec.num_layers, spec.hidden_size
        return {
            "input_norm_b": layer_stack(
                cls.hf_prefix + ".layers.{i}.input_layernorm.bias", _ident),
            "post_norm": np.ones((L, H), np.float32),
            "post_norm_b": np.zeros((L, H), np.float32),
        }

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        """Phi's final norm is ``final_layernorm`` (weight and bias); the
        lm-head bias is padded to the padded vocabulary."""
        sd = dict(sd)
        sd.setdefault("model.norm.weight",
                      np.asarray(sd["model.final_layernorm.weight"]))
        out = super().convert_hf_state_dict(sd, spec)
        out["final_norm"] = np.asarray(sd["model.final_layernorm.weight"])
        out["final_norm_b"] = np.asarray(sd["model.final_layernorm.bias"])
        out["lm_head_b"] = _vpad1(np.asarray(sd["lm_head.bias"]),
                                  spec.padded_vocab)
        return out


@register_family("gemma")
class GemmaFamily(DecoderFamily):
    """Gemma v1: (1 + w) RMSNorms, the embeddings times sqrt(hidden), the
    tanh gelu, tied embeddings."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        return spec_from_config(
            config, tp_degree,
            head_dim=config.head_dim,
            norm_offset=1.0,
            embed_scale=math.sqrt(config.hidden_size),
            act=getattr(config, "hidden_activation", None)
            or "gelu_pytorch_tanh",
            tie_word_embeddings=True,
        )


@register_family("olmo")
class OlmoFamily(DecoderFamily):
    """OLMo v1: non-parametric LayerNorms (no weight or bias in the
    checkpoint: unit weights), the optional q/k/v clamp."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        return spec_from_config(
            config, tp_degree,
            norm_type="layernorm",
            rms_eps=1e-5,
            qkv_clip=getattr(config, "clip_qkv", None),
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        ones = np.ones((spec.hidden_size,), np.float32)
        sd = dict(sd)
        for i in range(spec.num_layers):
            sd.setdefault(f"model.layers.{i}.input_layernorm.weight", ones)
            sd.setdefault(f"model.layers.{i}.post_attention_layernorm.weight",
                          ones)
        sd.setdefault("model.norm.weight", ones)
        return super().convert_hf_state_dict(sd, spec)


@register_family("glm4")
class Glm4Family(DecoderFamily):
    """GLM-4 (dense): a fused ``gate_up_proj`` (gate rows [0, I), up rows
    [I, 2I)), sandwich norms, interleaved partial rotary, the q/k/v
    bias."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = getattr(config, "head_dim", None) or H // nh
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            qkv_bias=bool(getattr(config, "attention_bias", True)),
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.5)),
            rope_interleaved=True,
            sandwich_norm=True,
            tie_word_embeddings=bool(getattr(config, "tie_word_embeddings",
                                             False)),
        )

    @classmethod
    def convert_mlp_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}.mlp."
        I = spec.intermediate_size
        return {
            "gate_proj": layer_stack(lp + "gate_up_proj.weight",
                                     lambda w: _t(np.asarray(w)[:I])),
            "up_proj": layer_stack(lp + "gate_up_proj.weight",
                                   lambda w: _t(np.asarray(w)[I:])),
            "down_proj": layer_stack(lp + "down_proj.weight", _t),
        }

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "post_attn_norm": layer_stack(
                lp + "post_self_attn_layernorm.weight", _ident),
            "post_ff_norm": layer_stack(lp + "post_mlp_layernorm.weight",
                                        _ident),
        }


@register_family("stablelm")
class StableLmFamily(DecoderFamily):
    """StableLM: Llama's GLU MLP, LayerNorms with biases, partial rotary,
    the optional q/k/v bias, an untied head."""
    config_cls = _SimpleConfig

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        H = config.hidden_size
        nh = config.num_attention_heads
        hd = H // nh
        return spec_from_config(
            config, tp_degree,
            head_dim=hd,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            norm_type="layernorm", norm_bias=True,
            qkv_bias=bool(getattr(config, "use_qkv_bias", False)),
            rotary_dim=int(hd * getattr(config, "partial_rotary_factor",
                                        0.25)),
            tie_word_embeddings=False,
        )

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec):
        lp = cls.hf_prefix + ".layers.{i}."
        return {
            "input_norm_b": layer_stack(lp + "input_layernorm.bias", _ident),
            "post_norm_b": layer_stack(lp + "post_attention_layernorm.bias",
                                       _ident),
        }

    @classmethod
    def convert_hf_state_dict(cls, sd, spec):
        out = super().convert_hf_state_dict(sd, spec)
        out["final_norm"] = np.asarray(sd["model.norm.weight"])
        out["final_norm_b"] = np.asarray(sd["model.norm.bias"])
        return out


@register_family("cohere")
class CohereFamily(DecoderFamily):
    """Cohere / Command-R: the parallel-shared residual, a bias-free
    LayerNorm, the logits times ``logit_scale``, tied embeddings."""
    config_cls = _SimpleConfig
    post_norm_src = "input_layernorm"   # the parallel-shared block reads none

    @classmethod
    def build_spec(cls, config, tp_degree=None):
        scale = float(getattr(config, "logit_scale", 1.0))
        return spec_from_config(
            config, tp_degree,
            rms_eps=float(getattr(config, "layer_norm_eps", 1e-5)),
            norm_type="layernorm",
            block_style="parallel_shared",
            logits_divide=1.0 / scale if scale else None,
            tie_word_embeddings=True,
        )

    @classmethod
    def convert_extra_layer_weights(cls, get, layer_stack, spec):
        L, H = spec.num_layers, spec.hidden_size
        return {"post_norm": np.ones((L, H), np.float32)}
