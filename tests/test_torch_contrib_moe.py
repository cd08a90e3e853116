"""The contrib hub's MoE families of the port (Phi-3.5-MoE, OLMoE,
GraniteMoE, GLM-4-MoE, dots.llm1) against the JAX package's.

The tiny HF configs are the reference's own (tests/test_contrib_hub2.py:
202-243 and 305-320, tests/test_contrib_hub3.py:87-102: hidden 64, 4 q /
2 kv heads, vocab 256, 4 experts, top 2), built with ``transformers`` from
a torch seed and saved locally. Then every weight is redrawn from a seeded
numpy normal at std 0.25, every norm weight at N(1, 0.1), every bias (the
LayerNorm, q/k/v, o, lm-head and router-correction biases, all zero at HF's
init) at N(0, 0.1) and the routers at N(0, 0.5), so that a dropped bias, a
swapped norm or a wrong rotation width shows in the logits and the routing
is far from ties. Two more variants take the decode kernels' branches at
head_dim 64: GLM-4-MoE at GQA group 12 (12 q heads over one KV head,
GLM-4.5-Air's group) and GraniteMoE at group 3 with the attention
multiplier 1/64 (granite-3.0-3b-a800m's); on the CPU the port's wrappers
run their plain twins and the JAX package its Pallas kernels in interpret
mode.

Both packages load each checkpoint with ``load_weights``: the converted
trees are equal leaf for leaf, the specs field for field; fp32 logits
agree at atol=2e-3, rtol=1e-3 (the suite's HF tolerance,
tests/test_llama_golden.py:63) with greedy tokens identical, on the
contiguous app (the paged app and the ragged engine:
test_torch_contrib_moe_serving.py). Each knob this slice added carries a control: the port app with
the knob removed parts from the JAX logits beyond the tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models import model_base as jmb
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
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from test_torch_dense_families import _transformers, ids_of
from test_torch_gpt_oss import _same_fields

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
BASE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            vocab_size=256, attention_dropout=0.0, torch_dtype="float32")
# name -> (transformers class stem, model_type, HF config kwargs); the
# first five are the reference tests' configs
VARIANTS = {
    "phimoe": ("Phimoe", "phimoe", dict(
        BASE, num_hidden_layers=2, intermediate_size=96,
        num_local_experts=4, num_experts_per_tok=2,
        router_jitter_noise=0.01, input_jitter_noise=0.0,
        attention_bias=True, lm_head_bias=True,
        max_position_embeddings=128, tie_word_embeddings=False)),
    "olmoe": ("Olmoe", "olmoe", dict(
        BASE, num_hidden_layers=3, intermediate_size=32, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=False)),
    "granitemoe": ("GraniteMoe", "granitemoe", dict(
        BASE, num_hidden_layers=3, intermediate_size=64,
        num_local_experts=4, num_experts_per_tok=2,
        embedding_multiplier=2.0, logits_scaling=2.0,
        residual_multiplier=0.5, attention_multiplier=0.25)),
    "glm4_moe": ("Glm4Moe", "glm4_moe", dict(
        BASE, num_hidden_layers=3, intermediate_size=64,
        moe_intermediate_size=32, head_dim=16, n_routed_experts=4,
        num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
        n_group=1, topk_group=1, norm_topk_prob=True, use_qk_norm=True,
        attention_bias=True, partial_rotary_factor=0.5)),
    "dots1": ("Dots1", "dots1", dict(
        BASE, num_hidden_layers=3, intermediate_size=64,
        moe_intermediate_size=32, head_dim=16, n_routed_experts=4,
        num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
        n_group=1, topk_group=1, norm_topk_prob=True,
        routed_scaling_factor=1.0)),
}
# head_dim 64 at the served groups: the kernel branches
VARIANTS["glm4_moe_g12"] = ("Glm4Moe", "glm4_moe", dict(
    VARIANTS["glm4_moe"][2], num_hidden_layers=2, num_attention_heads=12,
    num_key_value_heads=1, head_dim=64, use_qk_norm=False))
VARIANTS["granitemoe_g3"] = ("GraniteMoe", "granitemoe", dict(
    VARIANTS["granitemoe"][2], num_hidden_layers=2, hidden_size=192,
    num_attention_heads=3, num_key_value_heads=1,
    attention_multiplier=1 / 64))
FAMILIES = ("phimoe", "olmoe", "granitemoe", "glm4_moe", "dots1")
NAMES = sorted(VARIANTS)
GROUPS = {"glm4_moe_g12": 12, "granitemoe_g3": 3}
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _is_router(pname):
    return (pname.endswith("mlp.gate.weight")
            or pname.endswith("block_sparse_moe.gate.weight")
            or pname.endswith("router.layer.weight"))


def hf_model(name, seed=0, **over):
    """A tiny HF model of ``VARIANTS[name]`` with its weights redrawn from
    a seeded numpy normal: std 0.25, norms N(1, 0.1), biases N(0, 0.1),
    routers N(0, 0.5)."""
    tf = _transformers()
    stem, _, kw = VARIANTS[name]
    torch.manual_seed(seed)
    model = getattr(tf, stem + "ForCausalLM")(
        getattr(tf, stem + "Config")(**dict(kw, **over))).eval()
    rng = np.random.default_rng(seed + 100)

    def draw(shape, mean, std):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32))
    with torch.no_grad():
        for pname, p in model.named_parameters():
            shape = tuple(p.shape)
            if pname.endswith("bias"):
                p.copy_(draw(shape, 0.0, 0.1))
            elif "norm" in pname:
                p.copy_(draw(shape, 1.0, 0.1))
            elif _is_router(pname):
                p.copy_(draw(shape, 0.0, 0.5))
            else:
                p.copy_(draw(shape, 0.0, 0.25))
        for bname, b in model.named_buffers():
            if bname.endswith("e_score_correction_bias"):
                b.copy_(draw(tuple(b.shape), 0.0, 0.1))
    return model


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """variant -> directory of its saved tiny HF checkpoint."""
    out = {}
    for name in NAMES:
        d = tmp_path_factory.mktemp(name)
        hf_model(name).save_pretrained(d, safe_serialization=True)
        out[name] = str(d)
    return out


def make_apps(ckpt, name, tcfg=CONTIG, paged=False):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``, built
    the reference's way (tests/test_contrib_hub.py:19-35)."""
    mt = VARIANTS[name][1]
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


# ---------------------------------------------------------------------------
# the two knobs against the reference's functions
# ---------------------------------------------------------------------------

def test_norm_bias_and_lm_head_bias_match_reference():
    """``model_base._norm`` with a LayerNorm bias and ``_lm_head`` with
    ``final_norm_b`` and ``lm_head_b`` against the reference's functions
    (model_base.py:678-683, :1671-1684) on the same fp32 inputs, to 1e-5;
    the bias moves each output (the check is not vacuous), and the padded
    vocabulary stays masked."""
    from neuronx_distributed_inference_tpu.ops.rope import \
        RopeConfig as JRope
    from neuronx_distributed_inference_tpu.parallel.layers import \
        resolve_gqa_sharding as j_gqa
    from neuronx_distributed_inference_tpu_torch.ops.rope import RopeConfig
    from neuronx_distributed_inference_tpu_torch.parallel.layers import \
        resolve_gqa_sharding
    rng = np.random.default_rng(5)
    base = dict(num_layers=1, hidden_size=64, num_q_heads=4, num_kv_heads=2,
                head_dim=16, intermediate_size=64, vocab_size=200,
                padded_vocab=256, rms_eps=1e-5)
    knobs = dict(norm_type="layernorm", norm_bias=True, lm_head_bias=True,
                 logits_divide=2.0)
    jspec = jmb.DecoderSpec(**base, rope=JRope(head_dim=16),
                            gqa=j_gqa(4, 2, 1), dtype=jnp.float32, **knobs)
    tspec = model_base.DecoderSpec(**base, rope=RopeConfig(head_dim=16),
                                   gqa=resolve_gqa_sharding(4, 2, 1),
                                   dtype=torch.float32, **knobs)
    x = (2.0 + rng.standard_normal((2, 3, 64))).astype(np.float32)
    params = {
        "final_norm": (1.0 + 0.1 * rng.standard_normal(64)),
        "final_norm_b": 0.5 * rng.standard_normal(64),
        "lm_head": 0.3 * rng.standard_normal((64, 256)),
        "lm_head_b": rng.standard_normal(256),
        "embed": rng.standard_normal((256, 64)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jmb._norm(jspec, jnp.asarray(x), jparams["final_norm"],
                                jparams["final_norm_b"]))
    got = model_base._norm(tspec, torch.from_numpy(x), tparams["final_norm"],
                           tparams["final_norm_b"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    no_b = model_base._norm(tspec, torch.from_numpy(x),
                            tparams["final_norm"]).numpy()
    assert np.abs(no_b - want).max() > 0.1
    want = np.asarray(jmb._lm_head(jspec, jparams, jnp.asarray(x)))
    got = model_base._lm_head(tspec, tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[..., 200:] < -1e30)
    for drop in ("lm_head_b", "final_norm_b"):
        off = model_base._lm_head(
            tspec, {k: v for k, v in tparams.items() if k != drop},
            torch.from_numpy(x)).numpy()
        assert np.abs(off[..., :200] - want[..., :200]).max() > 0.1, drop


def test_spec_from_config_takes_the_new_overrides():
    """``norm_bias`` and ``lm_head_bias`` are knobs; ``rotary_dim`` is an
    override that wins over the config's (GLM-4-MoE's partial rotary),
    else the config's is read; the param specs carry the bias leaves
    (zeros) only where the spec asks for them."""
    from neuronx_distributed_inference_tpu_torch.config import \
        InferenceConfig
    hf = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              num_hidden_layers=2, intermediate_size=96, vocab_size=250,
              rotary_dim=8)
    cfg = InferenceConfig(TpuConfig(batch_size=1, seq_len=32), **hf)
    spec = model_base.spec_from_config(cfg, norm_type="layernorm",
                                       norm_bias=True, lm_head_bias=True,
                                       rotary_dim=4)
    assert spec.norm_bias and spec.lm_head_bias and spec.rope.rotary_dim == 4
    assert model_base.spec_from_config(cfg).rope.rotary_dim == 8
    tree = model_base.decoder_param_specs(spec)
    assert {"final_norm_b", "lm_head_b"} <= set(tree)
    assert {"input_norm_b", "post_norm_b"} <= set(tree["layers"])
    assert tree["lm_head_b"].shape == (256,)
    plain = model_base.decoder_param_specs(model_base.spec_from_config(cfg))
    assert not {"final_norm_b", "lm_head_b"} & set(plain)
    assert not {"input_norm_b", "post_norm_b"} & set(plain["layers"])
    params = model_base.init_params(spec, 0, torch.device("cpu"))
    assert float(params["lm_head_b"].abs().max()) == 0.0
    assert float(params["layers"]["input_norm_b"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# specs and converted trees
# ---------------------------------------------------------------------------

def _specs(ckpt, name):
    mt = VARIANTS[name][1]
    jfam, tfam = j_get_family(mt), get_family(mt)
    want = jfam.build_spec(jfam.config_cls(
        JTpuConfig(**CONTIG), load_config=j_load_config(ckpt)), tp_degree=1)
    got = tfam.build_spec(tfam.config_cls(
        TpuConfig(**CONTIG), load_config=load_pretrained_config(ckpt)),
        tp_degree=1)
    return got, want


@pytest.mark.parametrize("name", NAMES)
def test_spec_and_converter_match_jax(ckpts, name):
    """Every field of the port's spec (MoESpec and RopeConfig included)
    equals the JAX family's, with the reference tests' assertions; the
    converted tree equals the JAX tree leaf for leaf and exactly, in the
    same stacks (GLM-4-MoE and dots.llm1: one dense layer in ``"layers"``,
    the MoE layers in ``"moe_layers"``)."""
    got, want = _specs(ckpts[name], name)
    _same_fields(got, want, "spec")
    mt = VARIANTS[name][1]
    if mt == "phimoe":
        assert got.moe.router_act == "sparsemixer"
        assert got.norm_type == "layernorm" and got.norm_bias
        assert got.lm_head_bias and got.qkv_bias and got.o_bias
    elif mt == "olmoe":
        assert got.qk_norm_full and not got.moe.normalize_topk
    elif mt == "granitemoe":
        assert got.moe.pre_softmax_topk
        assert got.attn_scale == VARIANTS[name][2]["attention_multiplier"]
    elif mt == "glm4_moe":
        assert got.first_dense == 1 and got.moe.router_act == "sigmoid"
        assert got.moe.shared_intermediate == 32 and got.qkv_bias
        assert got.rope.rotary_dim == got.head_dim // 2
        assert got.qk_norm == (name == "glm4_moe")
    else:
        assert got.qk_norm and got.moe.router_act == "sigmoid"
        assert got.first_dense == 1 and got.rope.rotary_dim is None
    assert got.gqa.q_per_kv == GROUPS.get(name, 2)
    japp, tapp = make_apps(ckpts[name], name)
    jtree = jax.tree.map(np.asarray, japp.params)
    ttree = jax.tree.map(lambda t: t.numpy(), tapp.params)
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    jax.tree.map(np.testing.assert_array_equal, ttree, jtree)
    stacks = {k for k in ttree if k.endswith("layers")}
    assert stacks == ({"layers", "moe_layers"}
                      if mt in ("glm4_moe", "dots1") else {"layers"})
    if mt == "phimoe":
        assert {"final_norm_b", "lm_head_b"} <= set(ttree)
        assert ttree["lm_head_b"].shape == (tapp.spec.padded_vocab,)


@pytest.mark.parametrize("tokens", [8, 96], ids=["dense", "ragged"])
@pytest.mark.parametrize("name", FAMILIES)
def test_moe_block_routing_matches_jax_on_both_expert_paths(
        ckpts, name, tokens, monkeypatch):
    """The port's ``moe_block`` at each family's MoESpec (sparsemixer,
    unnormalised top-k, ``pre_softmax_topk``, sigmoid with the selection
    bias, shared experts and the routed scaling) and its first MoE layer's
    converted weights, against the JAX ``moe_block`` on the same fp32
    inputs: 8 tokens take the dense all-experts path, 96 the sorted
    grouped product (each seen taken), within 1e-5 of the largest output
    (fp32 sums of 64- and 32-long products taken in another order; the
    outputs reach ~10 at these weights), while a wrong expert or weight
    moves outputs by whole units."""
    from neuronx_distributed_inference_tpu.modules import moe as jmoe
    from neuronx_distributed_inference_tpu.utils.checkpoint import \
        load_state_dict as j_load_state_dict
    from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
    got_spec, want_spec = _specs(ckpts[name], name)
    tree = get_family(name).convert_hf_state_dict(
        j_load_state_dict(ckpts[name]), got_spec)
    stack = tree.get("moe_layers", tree["layers"])
    w = {k: np.asarray(v[0], np.float32) for k, v in stack.items()
         if k.startswith(("router", "expert_", "shared_"))}
    x = np.random.default_rng(9).standard_normal(
        (2, tokens // 2, 64)).astype(np.float32)
    seen = []
    for fn in ("experts_dense", "experts_ragged"):
        def counted(*a, _orig=getattr(tmoe, fn), _fn=fn, **k):
            seen.append(_fn)
            return _orig(*a, **k)
        monkeypatch.setattr(tmoe, fn, counted)
    want = jmoe.moe_block(want_spec.moe, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in w.items()})
    got = tmoe.moe_block(got_spec.moe, torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in w.items()})
    assert seen == ["experts_dense" if tokens <= 64 else "experts_ragged"]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the apps and the ragged engine against JAX
# ---------------------------------------------------------------------------

# each knob of this slice, removed from the port's spec: the logits must
# part from JAX's
CONTROLS = {
    "phimoe": (dict(norm_bias=False), dict(lm_head_bias=False)),
    "glm4_moe": (dict(rope=None),),
    # pre_softmax_topk computes what softmax, top-k and renormalisation
    # do, so no control parts there; the attention multiplier as the
    # scale does at head_dim 64 (1/64, not 64 ** -0.5; the reference
    # test's 0.25 is 16 ** -0.5)
    "granitemoe_g3": (dict(attn_scale=None),),
    "olmoe": (dict(moe="normalize_topk"),),
}


def _without(spec, knob):
    key, val = next(iter(knob.items()))
    if key == "rope":            # full rotary in place of partial
        return dataclasses.replace(spec, rope=dataclasses.replace(
            spec.rope, rotary_dim=None))
    if key == "moe":             # the routing flag flipped
        return dataclasses.replace(spec, moe=dataclasses.replace(
            spec.moe, **{val: not getattr(spec.moe, val)}))
    return dataclasses.replace(spec, **knob)


@pytest.mark.parametrize("name", NAMES)
def test_contiguous_logits_and_greedy_match_jax(ckpts, name):
    """The contiguous app's ``generate`` (a 20- and a 13-token prompt, 8
    new tokens): fp32 logits at LOGIT_TOL and greedy tokens equal to
    JAX's. Each knob of the family removed from the port's spec (the norm
    and lm-head biases, partial rotary, OLMoE's unnormalised top-k,
    Granite's attention multiplier as the scale) parts from JAX beyond the
    tolerance."""
    japp, tapp = make_apps(ckpts[name], name)
    ids, mask = ids_of([20, 13], seed=3)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    base = tapp.spec
    for knob in CONTROLS.get(name, ()):
        tapp.spec = _without(base, knob)
        tapp._inv_freq = model_base.rope_inv_freq(tapp.spec, tapp.device)
        tapp.init_cache()
        off = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                            return_logits=True)["logits"]
        assert parts(off, want["logits"]), knob


def test_phimoe_sliding_window_takes_the_rolling_cache(tmp_path):
    """Phi-3.5-MoE with ``sliding_window`` 8 at ``seq_len`` 48: both
    packages take the rolling cache (8 slots a row), and with the biases
    on, prompts of 20 and 13 tokens and 8 new tokens give the same fp32
    logits and greedy tokens; the port without the window parts."""
    d = tmp_path / "phimoe_w8"
    hf_model("phimoe", sliding_window=8).save_pretrained(
        d, safe_serialization=True)
    japp, tapp = make_apps(str(d), "phimoe")
    assert tapp.spec.sliding_window == 8 and tapp.spec.rolling_window
    assert tapp.spec.rolling_window == japp.spec.rolling_window
    assert tapp.cache["k"].shape[-1] == 8
    ids, mask = ids_of([20, 13], seed=7)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], "phimoe_w8")
    tapp.spec = dataclasses.replace(tapp.spec, sliding_window=0,
                                    rolling_window=False)
    tapp.init_cache()
    off = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)["logits"]
    assert parts(off, want["logits"])


# ---------------------------------------------------------------------------
# the kernel gate at the served groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GROUPS))
def test_decode_kernel_gate_admits_the_served_groups(ckpts, name):
    """``decode_attention.supports`` admits G 12 (GLM-4.5-Air's 96 q over 8
    KV heads) and G 3 at head_dim 64 (granite-3.0-3b-a800m's), single-token
    steps only."""
    spec, _ = _specs(ckpts[name], name)
    assert spec.head_dim == 64 and spec.gqa.q_per_kv == GROUPS[name]
    assert decode_attention.supports(spec, 1)
    assert not decode_attention.supports(spec, 2)


def test_chip_smoke_contrib_moe_helpers(capsys):
    """Phase 21's helpers (chip_smoke), none defined twice in the script:
    the full-width specs pass ``check_contrib_moe_specs`` (GLM-4.5-Air at G
    12 with rotary 64 of 128, Phi-3.5-MoE's biases and window, OLMoE at G
    1, granite at G 3 / D 64 with scale 1/64, dots.llm1's two shared
    experts); the cuts keep the first dense layer; ``sparsemixer_forced``
    at the router's own selection gives the router's affinities (either
    order), and at another pair the masked softmax of that pair;
    ``contrib_kernel_inputs`` builds each case's shapes."""
    import ast

    from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    names = [n.name for n in ast.parse(open(cs.__file__).read()).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert len(names) == len(set(names)), "a helper defined twice"
    cs.check_contrib_moe_specs()
    assert '"contrib_moe_specs"' in capsys.readouterr().out
    cut = cs.moe_families_cut(cs.GLM_45_AIR, cs.GLM_CUT)
    spec = cs.family_spec(cut)
    assert spec.num_layers == 6 and cs.GLM_45_AIR["num_hidden_layers"] == 46
    assert [k for *_, k in model_base.layer_plan(spec)] == (
        ["dense"] + ["moe"] * 5)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(
        np.float32))
    moe = tmoe.MoESpec(num_experts=16, top_k=2, intermediate_size=8,
                       normalize_topk=False, router_act="sparsemixer")
    vals, idx = tmoe._sparsemixer_route(moe, logits)
    for order in (idx, idx.flip(-1)):
        got = cs.sparsemixer_forced(logits, order, 0.01)
        want = vals if order is idx else vals.flip(-1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    # forced to (the winner, the 3rd-ranked): the second pick's masked
    # softmax over the scores left, read at the forced expert
    third = logits.topk(3, dim=-1).indices[..., 2:3]
    forced = torch.cat([idx[..., :1], third], dim=-1)
    got = cs.sparsemixer_forced(logits, forced, 0.01)
    np.testing.assert_allclose(got[..., 0].numpy(), vals[..., 0].numpy(),
                               rtol=1e-6)
    assert not np.allclose(got[..., 1].numpy(), vals[..., 1].numpy())
    gen = torch.Generator().manual_seed(0)
    x, kw = cs.contrib_kernel_inputs("granite_g3_d64_bf16",
                                     torch.device("cpu"), gen, "contig")
    assert x["q"].shape == (4, 24, 64) and x["k_cache"].shape == (
        1, 4, 8, 64, 4096)
    assert kw == {"scale": 0.015625}


def test_chip_smoke_forced_routes_reproduce_served_streams():
    """Phase 21's route forcing (chip_smoke) on a tiny Phi-3.5-MoE served
    in bf16 on the CPU (four requests through the ragged engine, prefill
    chunks of 32): :meth:`ServedRoutes.row_routes` holds every position a
    request's passes routed, and ``generate`` with those routes imposed
    (``forced_route_deficits``) ranks every served token first, while the
    same routes with each expert id moved to the next expert part (served
    tokens fall below the top at several steps of at least two requests,
    1 logit std in all)."""
    from neuronx_distributed_inference_tpu_torch.config import \
        ChunkedPrefillConfig
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    hf = dict(cs.PHI_35_MOE, hidden_size=256, intermediate_size=64,
              num_attention_heads=4, num_key_value_heads=1,
              num_local_experts=4, num_hidden_layers=2, vocab_size=512)
    # prompts within one chunk: the served prefill and generate's are one
    # forward each (on this tiny config generate does not chunk)
    cfg = dict(lens=(5, 31, 17, 24), seq_len=256, chunk=32, block=32)
    got = {}

    def after(app, prompts, streams):
        for i, prompt in enumerate(prompts):
            served = list(streams[i].tokens)
            vals, idx, have = routes.row_routes(prompt, 2)
            assert bool(have[:len(prompt) + len(served) - 1].all())
            got[i] = cs.forced_route_deficits(app, prompt, served,
                                              (vals, idx, have))
            got[i, "moved"] = cs.forced_route_deficits(
                app, prompt, served, (vals, (idx + 1) % 4, have))
    with cs.ServedRoutes() as routes:
        cs.phase_ragged_serving(
            hf, torch.device("cpu"), cfg=cfg, new_tokens=6, on_card=False,
            phase="forced_routes",
            tcfg_over=dict(batch=4, output_logits=True,
                           is_chunked_prefill=True,
                           chunked_prefill_config=ChunkedPrefillConfig(
                               kernel_q_tile_size=32)),
            after=after)
    for i in range(4):
        assert len(got[i]) == 6 and max(got[i]) == 0.0, got[i]
    moved = [got[i, "moved"] for i in range(4)]
    assert sum(map(sum, moved)) > 1.0, moved
    assert sum(max(m) > 0.1 for m in moved) >= 2, moved
