"""The contrib hub's dense families of the port against the JAX
package's, on the contiguous app: the first wave here (GPT-2, GPT-NeoX,
Falcon old and new, StarCoder2, Phi, Gemma, OLMo, GLM-4, StableLM,
Cohere), the later waves' (HunYuan-Dense, BLOOM, MPT, Persimmon,
openai-gpt, Apertus) in test_torch_contrib_dense_hub23.py through the
same checks.

The tiny HF configs are the reference's own (tests/test_contrib_hub.py:
38-181, tests/test_contrib_hub2.py:189-200 and 250-303,
tests/test_contrib_hub3.py:12-22 and 74-86: hidden 64, 4 heads, vocab
256), built with ``transformers`` from a torch seed and saved locally.
Then every weight is redrawn from a seeded numpy normal at std 0.25, every
norm weight at N(1, 0.1) and every bias (the LayerNorm, q/k/v, o, MLP and
lm-head biases, zero at HF's init) at N(0, 0.1), so that a dropped bias, a
swapped norm or a wrong rotation width shows in the logits.

Both packages load each checkpoint with ``load_weights``: the converted
trees are equal leaf for leaf, the specs field for field; fp32 logits
agree at atol=2e-3, rtol=1e-3 (the suite's HF tolerance,
tests/test_llama_golden.py:63) with greedy tokens identical. Each knob
this slice added carries a control (:data:`CONTROLS`): the port app with
the knob removed parts from the JAX logits beyond the tolerance. The
paged app and the ragged engine: test_torch_contrib_dense_serving.py; the
knobs' ops and the kernel gates: test_torch_contrib_dense_knobs.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from test_torch_dense_families import _transformers, ids_of
from test_torch_gpt_oss import _same_fields

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
NO_DROP = dict(attention_dropout=0.0, torch_dtype="float32")
# name -> (HF model class, HF config class, model_type, config kwargs): the
# reference tests' configs
VARIANTS = {
    "gpt2": ("GPT2LMHeadModel", "GPT2Config", "gpt2", dict(
        n_embd=64, n_head=4, n_layer=3, n_positions=128, vocab_size=256,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        torch_dtype="float32")),
    "gpt_neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig", "gpt_neox", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        intermediate_size=128, vocab_size=256, rotary_pct=0.25,
        max_position_embeddings=128, use_parallel_residual=True,
        hidden_dropout=0.0)),
    "falcon": ("FalconForCausalLM", "FalconConfig", "falcon", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        vocab_size=256, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False,
        hidden_dropout=0.0)),
    "falcon_new": ("FalconForCausalLM", "FalconConfig", "falcon", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4, num_kv_heads=2,
        num_hidden_layers=3, vocab_size=256, new_decoder_architecture=True,
        bias=True, alibi=False, hidden_dropout=0.0)),
    "starcoder2": ("Starcoder2ForCausalLM", "Starcoder2Config",
                   "starcoder2", dict(
                       NO_DROP, hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=3,
                       intermediate_size=128, vocab_size=256,
                       max_position_embeddings=128, use_bias=True,
                       residual_dropout=0.0, embedding_dropout=0.0,
                       sliding_window=None)),
    "phi": ("PhiForCausalLM", "PhiConfig", "phi", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        intermediate_size=128, vocab_size=256, partial_rotary_factor=0.5,
        max_position_embeddings=128, resid_pdrop=0.0, embd_pdrop=0.0)),
    "gemma": ("GemmaForCausalLM", "GemmaConfig", "gemma", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, num_hidden_layers=3,
        intermediate_size=128, vocab_size=256,
        max_position_embeddings=128)),
    "olmo": ("OlmoForCausalLM", "OlmoConfig", "olmo", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=3, intermediate_size=128,
        vocab_size=256, max_position_embeddings=128, clip_qkv=8.0)),
    "glm4": ("Glm4ForCausalLM", "Glm4Config", "glm4", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=3, intermediate_size=96,
        vocab_size=256, partial_rotary_factor=0.5, head_dim=16,
        max_position_embeddings=128, attention_bias=True, pad_token_id=0,
        eos_token_id=1)),
    "stablelm": ("StableLmForCausalLM", "StableLmConfig", "stablelm", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=3, intermediate_size=128,
        vocab_size=256, partial_rotary_factor=0.25,
        max_position_embeddings=128, use_qkv_bias=False)),
    "cohere": ("CohereForCausalLM", "CohereConfig", "cohere", dict(
        NO_DROP, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=4, num_hidden_layers=3, intermediate_size=128,
        vocab_size=256, logit_scale=0.25, max_position_embeddings=128,
        use_qk_norm=False)),
    "hunyuan": ("HunYuanDenseV1ForCausalLM", "HunYuanDenseV1Config",
                "hunyuan_v1_dense", dict(
                    NO_DROP, hidden_size=64, num_attention_heads=4,
                    num_key_value_heads=2, num_hidden_layers=3,
                    intermediate_size=128, head_dim=16, vocab_size=256)),
    "bloom": ("BloomForCausalLM", "BloomConfig", "bloom", dict(
        hidden_size=64, n_head=4, n_layer=3, vocab_size=256,
        hidden_dropout=0.0, attention_dropout=0.0, torch_dtype="float32")),
    "mpt": ("MptForCausalLM", "MptConfig", "mpt", dict(
        d_model=64, n_heads=4, n_layers=3, vocab_size=256,
        torch_dtype="float32")),
    "persimmon": ("PersimmonForCausalLM", "PersimmonConfig", "persimmon",
                  dict(NO_DROP, hidden_size=64, num_attention_heads=4,
                       num_hidden_layers=3, intermediate_size=128,
                       vocab_size=256, qk_layernorm=True,
                       partial_rotary_factor=0.5, hidden_act="relu2",
                       hidden_dropout=0.0)),
    "openai_gpt": ("OpenAIGPTLMHeadModel", "OpenAIGPTConfig", "openai-gpt",
                   dict(n_embd=64, n_head=4, n_layer=3, n_positions=128,
                        vocab_size=256, resid_pdrop=0.0, embd_pdrop=0.0,
                        attn_pdrop=0.0, torch_dtype="float32")),
    "apertus": ("ApertusForCausalLM", "ApertusConfig", "apertus", dict(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        num_hidden_layers=3, intermediate_size=128, vocab_size=256,
        max_position_embeddings=128, torch_dtype="float32")),
}
# head_dim 64 (the kernels' width): the serving and the kernel-gate tests
VARIANTS["gpt_neox_d64"] = ("GPTNeoXForCausalLM", "GPTNeoXConfig",
                            "gpt_neox", dict(
                                VARIANTS["gpt_neox"][3], hidden_size=256,
                                num_hidden_layers=2, intermediate_size=512))
VARIANTS["bloom_d64"] = ("BloomForCausalLM", "BloomConfig", "bloom", dict(
    VARIANTS["bloom"][3], hidden_size=256, n_layer=2))
WAVE1 = ("cohere", "falcon", "falcon_new", "gemma", "glm4", "gpt2",
         "gpt_neox", "olmo", "phi", "stablelm", "starcoder2")
HUB23 = ("apertus", "bloom", "hunyuan", "mpt", "openai_gpt", "persimmon")
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def hf_model(name, seed=0, **over):
    """A tiny HF model of ``VARIANTS[name]`` with its weights redrawn from
    a seeded numpy normal: std 0.25, norms N(1, 0.1), biases N(0, 0.1)."""
    tf = _transformers()
    model_cls, cfg_cls, _, kw = VARIANTS[name]
    torch.manual_seed(seed)
    model = getattr(tf, model_cls)(getattr(tf, cfg_cls)(**dict(kw, **over)))
    model.eval()
    rng = np.random.default_rng(seed + 100)

    def draw(shape, mean, std):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32))
    with torch.no_grad():
        for pname, p in model.named_parameters():
            shape = tuple(p.shape)
            if pname.endswith("bias"):
                p.copy_(draw(shape, 0.0, 0.1))
            elif "norm" in pname or ".ln_" in pname:
                p.copy_(draw(shape, 1.0, 0.1))
            else:
                p.copy_(draw(shape, 0.0, 0.25))
    return model


def save_ckpt(d, name, **over):
    hf_model(name, **over).save_pretrained(d, safe_serialization=True)
    return str(d)


def save_ckpts(tmp_path_factory, names):
    """variant -> directory of its saved tiny HF checkpoint."""
    return {name: save_ckpt(tmp_path_factory.mktemp(name), name)
            for name in names}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory, WAVE1)


def make_apps(ckpt, name, tcfg=CONTIG, paged=False):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``, built
    the reference's way (tests/test_contrib_hub.py:19-35)."""
    mt = VARIANTS[name][2]
    jfam, tfam = j_get_family(mt), get_family(mt)
    japp = (JPagedApp if paged else JApp)(
        ckpt, jfam.config_cls(JTpuConfig(**tcfg),
                              load_config=j_load_config(ckpt)), jfam)
    tapp = (PagedCausalLMApplication if paged else CausalLMApplication)(
        ckpt, tfam.config_cls(TpuConfig(**tcfg),
                              load_config=load_pretrained_config(ckpt)),
        tfam, device="cpu")
    return japp.load_weights().init_cache(), tapp.load_weights().init_cache()


def assert_logits_close(got, want, what=""):
    assert len(got) == len(want) and len(got) > 0
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what} step {step}",
                                   **LOGIT_TOL)


def parts(got, want):
    """Whether two logits lists part beyond LOGIT_TOL at some step."""
    return not all(np.allclose(np.asarray(a), np.asarray(b), **LOGIT_TOL)
                   for a, b in zip(got, want))


# the spec assertions of the reference tests, and this slice's knobs
EXPECT = {
    "gpt2": dict(no_rope=True, learned_pos=128, mlp_glu=False,
                 mlp_bias=True, norm_bias=True),
    "gpt_neox": dict(block_style="parallel_dual", mlp_glu=False),
    "falcon": dict(block_style="parallel_shared", num_kv_heads=1),
    "falcon_new": dict(block_style="parallel_dual", num_kv_heads=2,
                       qkv_bias=True, mlp_bias=True),
    "starcoder2": dict(mlp_glu=False, mlp_bias=True),
    "phi": dict(block_style="parallel_shared", lm_head_bias=True),
    "gemma": dict(norm_offset=1.0, embed_scale=8.0),
    "olmo": dict(norm_type="layernorm", qkv_clip=8.0),
    "glm4": dict(sandwich_norm=True, rope_interleaved=True),
    "stablelm": dict(norm_bias=True),
    "cohere": dict(block_style="parallel_shared", logits_divide=4.0),
    "hunyuan": dict(qk_norm=True, qk_norm_after_rope=True),
    "bloom": dict(alibi=True, embed_norm=True, no_rope=True),
    "mpt": dict(alibi=True, mlp_bias=False),
    "persimmon": dict(qk_norm=True, qk_norm_type="layernorm"),
    "openai_gpt": dict(norm_position="post_residual", skip_final_norm=True,
                       no_rope=True),
    "apertus": dict(act="xielu", mlp_glu=False, qk_norm=True),
}
ROTARY = {"gpt_neox": 4, "persimmon": 8}


def _specs(ckpt, name):
    mt = VARIANTS[name][2]
    jfam, tfam = j_get_family(mt), get_family(mt)
    want = jfam.build_spec(jfam.config_cls(
        JTpuConfig(**CONTIG), load_config=j_load_config(ckpt)), tp_degree=1)
    got = tfam.build_spec(tfam.config_cls(
        TpuConfig(**CONTIG), load_config=load_pretrained_config(ckpt)),
        tp_degree=1)
    return got, want


def check_spec_and_tree(ckpts, name):
    """Every field of the port's spec (RopeConfig included) equals the JAX
    family's, with the reference tests' assertions; the converted tree
    equals the JAX tree leaf for leaf and exactly (the position table, the
    embeddings' norm, the ALiBi slopes, the xIELU row, the MLP and q/k
    LayerNorm biases among them)."""
    got, want = _specs(ckpts[name], name)
    _same_fields(got, want, "spec")
    for field, value in EXPECT[name].items():
        assert getattr(got, field) == value, (name, field)
    if name in ROTARY:
        assert got.rope.rotary_dim == ROTARY[name]
    japp, tapp = make_apps(ckpts[name], name)
    jtree = jax.tree.map(np.asarray, japp.params)
    ttree = jax.tree.map(lambda t: t.numpy(), tapp.params)
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    jax.tree.map(np.testing.assert_array_equal, ttree, jtree)
    leaves = set(ttree) | set(ttree["layers"])
    new = {"gpt2": {"pos_embed", "gate_bias", "down_bias"},
           "bloom": {"embed_norm", "embed_norm_b", "alibi_slopes"},
           "mpt": {"alibi_slopes"}, "apertus": {"xielu"},
           "persimmon": {"q_norm_b", "k_norm_b"}}.get(name, set())
    assert new <= leaves, new - leaves
    assert ("final_norm" in ttree) == (name != "openai_gpt")
    assert ("up_proj" in ttree["layers"]) == got.mlp_glu


# each knob of this slice, removed from the port: the logits must part
# from JAX's. A spec field replaced, or (the plain MLP, the final norm) a
# tree edit: the GLU path over fc1 twice, a unit final LayerNorm
CONTROLS = {
    "gpt2": (dict(learned_pos=0), dict(no_rope=False), dict(mlp_bias=False),
             "glu"),
    "gpt_neox": (dict(block_style="sequential"),),
    "falcon": (dict(block_style="sequential"),),
    "phi": (dict(block_style="sequential"),),
    "hunyuan": (dict(qk_norm_after_rope=False),),
    "bloom": (dict(alibi=False), dict(embed_norm=False)),
    "mpt": (dict(alibi=False),),
    "persimmon": (dict(qk_norm_type="rms"),),
    "openai_gpt": (dict(norm_position="pre"), "final_norm"),
    "apertus": (dict(act="silu"),),
}


def without(app, knob):
    """``app`` with one knob removed: (spec, params) to install."""
    spec, params = app.spec, app.params
    if knob == "glu":
        layers = dict(params["layers"], up_proj=params["layers"]["gate_proj"])
        return (dataclasses.replace(spec, mlp_glu=True, mlp_bias=False),
                dict(params, layers=layers))
    if knob == "final_norm":
        h = spec.hidden_size
        return (dataclasses.replace(spec, skip_final_norm=False),
                dict(params, final_norm=torch.ones(h),
                     final_norm_b=torch.zeros(h)))
    return dataclasses.replace(spec, **knob), params


def check_contiguous(ckpts, name):
    """The contiguous app's ``generate`` (a 20- and a 13-token prompt, 8
    new tokens): fp32 logits at LOGIT_TOL and greedy tokens equal to
    JAX's. Each knob of the family removed from the port parts from JAX
    beyond the tolerance."""
    japp, tapp = make_apps(ckpts[name], name)
    ids, mask = ids_of([20, 13], seed=3)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    base = (tapp.spec, tapp.params)
    for knob in CONTROLS.get(name, ()):
        tapp.spec, tapp.params = without(tapp, knob)
        tapp._inv_freq = model_base.rope_inv_freq(tapp.spec, tapp.device)
        tapp.init_cache()
        off = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                            return_logits=True)["logits"]
        assert parts(off, want["logits"]), knob
        tapp.spec, tapp.params = base


@pytest.mark.parametrize("name", WAVE1)
def test_spec_and_converter_match_jax(ckpts, name):
    """:func:`check_spec_and_tree` for the first wave."""
    check_spec_and_tree(ckpts, name)


@pytest.mark.parametrize("name", WAVE1)
def test_contiguous_logits_and_greedy_match_jax(ckpts, name):
    """:func:`check_contiguous` for the first wave (the controls of GPT-2's
    learned positions, rotation, MLP biases and plain MLP; the parallel
    blocks of GPT-NeoX, Falcon and Phi)."""
    check_contiguous(ckpts, name)
