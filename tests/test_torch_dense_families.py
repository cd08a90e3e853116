"""The dense families of the port (Qwen2, Granite, Phi-3 with and without
longrope, OLMo-2, Gemma-2, Gemma-3) against the JAX package's, on the
contiguous app.

Tiny HF checkpoints (hidden 64, 4 layers, 4 q / 2 kv heads of 16, vocab
256) are saved locally and loaded by both packages with ``load_weights``.
Every norm weight of the HF model is drawn from its own seeded normal
(N(0, 0.1) for Gemma's zero-centred (1 + w) norms, N(1, 0.1) for the
others), so a converter that swapped two norms or dropped the offset
would show. The weights are drawn at std 0.25 (``initializer_range``) so
the tiny model's attention scores and logits reach the small soft-caps
set here (attention 1.0, final 2.0; the published 50 / 30 would never
bite at this size).

Tolerance: fp32 logits at atol=2e-3, rtol=1e-3 (the suite's HF tolerance,
tests/test_llama_golden.py:63) and greedy tokens equal. Each knob carries
a control: the same port app with the knob removed must part from the
JAX logits by more than that tolerance."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.ops import rope as jrope
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.models.gemma2 import \
    TpuGemma2ForCausalLM
from neuronx_distributed_inference_tpu_torch.models.gemma3 import \
    TpuGemma3ForCausalLM
from neuronx_distributed_inference_tpu_torch.models.granite import \
    TpuGraniteForCausalLM
from neuronx_distributed_inference_tpu_torch.models.olmo2 import \
    TpuOlmo2ForCausalLM
from neuronx_distributed_inference_tpu_torch.models.phi3 import \
    TpuPhi3ForCausalLM
from neuronx_distributed_inference_tpu_torch.models.qwen2 import \
    TpuQwen2ForCausalLM
from neuronx_distributed_inference_tpu_torch.ops import rope as trope
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
ATTN_CAP, FINAL_CAP = 1.0, 2.0
COMMON = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=256, rms_norm_eps=1e-5,
              max_position_embeddings=128, initializer_range=0.25,
              torch_dtype="float32")
# head_dim 16: 8 frequency slots
LONGROPE = {"type": "longrope",
            "short_factor": [1.0 + 0.25 * i for i in range(8)],
            "long_factor": [1.5 + 0.75 * i for i in range(8)]}
GEMMA = dict(intermediate_size=128, head_dim=16, query_pre_attn_scalar=16,
             sliding_window=8, attention_dropout=0.0)
# (transformers class stem, model_type, HF config kwargs)
VARIANTS = {
    "qwen2": ("Qwen2", "qwen2", dict(intermediate_size=96,
                                     tie_word_embeddings=False)),
    "granite": ("Granite", "granite", dict(
        intermediate_size=96, embedding_multiplier=6.0,
        attention_multiplier=0.3, residual_multiplier=0.5,
        logits_scaling=4.0, tie_word_embeddings=True)),
    "phi3": ("Phi3", "phi3", dict(intermediate_size=96, pad_token_id=0,
                                  tie_word_embeddings=False)),
    # the long factors apply: 128 deployed positions over 32 trained
    "phi3_longrope": ("Phi3", "phi3", dict(
        intermediate_size=96, pad_token_id=0, tie_word_embeddings=False,
        rope_scaling=LONGROPE, original_max_position_embeddings=32)),
    "olmo2": ("Olmo2", "olmo2", dict(intermediate_size=96,
                                     tie_word_embeddings=False)),
    "gemma2": ("Gemma2", "gemma2", dict(
        GEMMA, final_logit_softcapping=FINAL_CAP,
        attn_logit_softcapping=ATTN_CAP)),
    "gemma3": ("Gemma3", "gemma3_text", dict(
        GEMMA, layer_types=["sliding_attention", "sliding_attention",
                            "full_attention", "sliding_attention"],
        rope_theta=1e6, rope_scaling={"rope_type": "linear", "factor": 8.0},
        rope_local_base_freq=1e4)),
}
NAMES = sorted(VARIANTS)
ENTRY = {"qwen2": TpuQwen2ForCausalLM, "granite": TpuGraniteForCausalLM,
         "phi3": TpuPhi3ForCausalLM, "olmo2": TpuOlmo2ForCausalLM,
         "gemma2": TpuGemma2ForCausalLM, "gemma3_text": TpuGemma3ForCausalLM}
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _transformers():
    saved = {k: os.environ.get(k) for k in ("USE_TF", "USE_FLAX")}
    # the torch models need neither TensorFlow nor Flax
    os.environ.update(USE_TF="0", USE_FLAX="0")
    try:
        import transformers
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return transformers


def hf_model(name, seed=0, **over):
    """A tiny HF model of ``VARIANTS[name]``: weights at std 0.25, every
    norm weight (and bias) redrawn from its own seeded normal."""
    tf = _transformers()
    stem, mt, kw = VARIANTS[name]
    cfg_cls = getattr(tf, ("Gemma3Text" if mt == "gemma3_text" else stem)
                      + "Config")
    model_cls = getattr(tf, ("Gemma3" if mt == "gemma3_text" else stem)
                        + "ForCausalLM")
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**{**COMMON, **kw, **over})).eval()
    rng = np.random.default_rng(seed + 100)
    zero_centred = mt.startswith("gemma")
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                mean = 0.0 if zero_centred else 1.0
                p.copy_(torch.from_numpy(mean + 0.1 * rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)))
            elif pname.endswith(".bias"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)))
    return model


def save_checkpoint(model, d):
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """variant -> directory of its saved tiny HF checkpoint."""
    return {n: save_checkpoint(hf_model(n), tmp_path_factory.mktemp(n))
            for n in NAMES}


def model_type(name):
    return VARIANTS[name][1]


def make_apps(ckpt, name, tcfg=CONTIG, paged=False, sampling=None):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``;
    ``sampling``: OnDeviceSamplingConfig fields for both."""
    from neuronx_distributed_inference_tpu.config import \
        OnDeviceSamplingConfig as JSampling
    from neuronx_distributed_inference_tpu.models.application import \
        PagedCausalLMApplication as JPagedApp
    from neuronx_distributed_inference_tpu_torch.config import \
        OnDeviceSamplingConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        PagedCausalLMApplication
    mt = model_type(name)
    jfam, tfam = j_get_family(mt), get_family(mt)
    jkw, kw = dict(tcfg), dict(tcfg)
    if sampling is not None:
        jkw["on_device_sampling_config"] = JSampling(**sampling)
        kw["on_device_sampling_config"] = OnDeviceSamplingConfig(**sampling)
    japp = (JPagedApp if paged else JApp)(
        ckpt, jfam.config_cls(JTpuConfig(**jkw),
                              load_config=j_load_config(ckpt)), jfam)
    tcfg_obj = tfam.config_cls(TpuConfig(**kw),
                               load_config=load_pretrained_config(ckpt))
    tapp = (PagedCausalLMApplication(ckpt, tcfg_obj, tfam, device="cpu")
            if paged else ENTRY[mt](ckpt, tcfg_obj, device="cpu"))
    return japp.load_weights().init_cache(), tapp.load_weights().init_cache()


def ids_of(lens, seed, vocab=256):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def assert_logits_close(got, want, what=""):
    assert len(got) == len(want) and len(got) > 0
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what} step {step}",
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# specs and converted trees
# ---------------------------------------------------------------------------

SKIP_FIELDS = {"gqa", "dtype", "kv_dtype", "quant", "low_rank", "moe", "mla",
               "rope", "local_rope"}


def _rope_fields(port, jax_cfg):
    if port is None or jax_cfg is None:
        assert port is None and jax_cfg is None
        return
    names = ({f.name for f in dataclasses.fields(port)}
             & {f.name for f in dataclasses.fields(jax_cfg)})
    for n in sorted(names):
        assert getattr(port, n) == getattr(jax_cfg, n), n


@pytest.mark.parametrize("name", NAMES)
def test_build_spec_equals_jax_field_by_field(ckpts, name):
    """Every DecoderSpec field the two packages share is equal, the rope
    configs (and Gemma-3's local one) field by field."""
    japp, tapp = make_apps(ckpts[name], name)
    js, ts = japp.spec, tapp.spec
    shared = ({f.name for f in dataclasses.fields(ts)}
              & {f.name for f in dataclasses.fields(js)}) - SKIP_FIELDS
    assert {"act", "norm_offset", "sandwich_norm", "norm_position",
            "qk_norm_full", "residual_multiplier", "logits_divide",
            "logits_soft_cap", "attn_soft_cap", "embed_scale"} <= shared
    for n in sorted(shared):
        assert getattr(ts, n) == getattr(js, n), n
    _rope_fields(ts.rope, js.rope)
    _rope_fields(ts.local_rope, js.local_rope)
    assert ts.gqa.q_per_kv == js.gqa.q_per_kv


@pytest.mark.parametrize("name", NAMES)
def test_converted_tree_equals_jax_leaf_by_leaf(ckpts, name):
    """The port's converted tree has the JAX tree's leaves, shapes and
    values, bit for bit (fp32)."""
    japp, tapp = make_apps(ckpts[name], name)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, japp.params))[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(
               tapp.params, is_leaf=lambda n: isinstance(n, torch.Tensor))[0]}
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)].numpy(),
                                      leaf, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the contiguous app
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_contiguous_logits_and_greedy_tokens_match_jax(ckpts, name):
    """``generate`` on the contiguous app (Gemma: the mixed per-layer
    cache, seq_len 48 past the window of 8): the prefill and 8 decode
    steps' fp32 logits at LOGIT_TOL and the greedy tokens equal."""
    japp, tapp = make_apps(ckpts[name], name)
    ids, mask = ids_of([20, 13], seed=1)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    assert tapp.spec.mixed_kv == name.startswith("gemma")
    if tapp.spec.mixed_kv:
        assert set(tapp.cache) == {"k", "v", "k_l", "v_l"}


# each knob of a variant and the value that removes it
CONTROLS = [
    ("gemma2", "norm_offset", 0.0),
    ("gemma2", "sandwich_norm", False),
    ("gemma2", "embed_scale", None),
    ("gemma2", "attn_soft_cap", None),
    ("gemma2", "logits_soft_cap", None),
    ("gemma3", "local_rope", None),
    ("gemma3", "norm_offset", 0.0),
    ("olmo2", "norm_position", "pre"),
    ("olmo2", "sandwich_norm", False),
    ("olmo2", "qk_norm_full", False),
    ("granite", "residual_multiplier", 1.0),
    ("granite", "embed_scale", None),
    ("granite", "logits_divide", None),
    ("phi3_longrope", "rope", "no_longrope"),
]


@pytest.mark.parametrize("name,knob,off", CONTROLS,
                         ids=[f"{n}-{k}" for n, k, _ in CONTROLS])
def test_knob_control_parts_from_jax(ckpts, name, knob, off):
    """With ``knob`` removed from the port's spec, the prefill logits part
    from the JAX package's by more than LOGIT_TOL (they agree with it
    set, test_contiguous_logits_and_greedy_tokens_match_jax)."""
    japp, tapp = make_apps(ckpts[name], name)
    ids, mask = ids_of([20, 13], seed=1)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=1,
                         return_logits=True)["logits"][0]
    if knob == "rope":
        tapp.spec = dataclasses.replace(tapp.spec, rope=dataclasses.replace(
            tapp.spec.rope, scaling_type=None))
    else:
        tapp.spec = dataclasses.replace(tapp.spec, **{knob: off})
    tapp._inv_freq = model_base.rope_inv_freq(tapp.spec, tapp.device)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=1,
                        return_logits=True)["logits"][0]
    assert not np.allclose(np.asarray(got), np.asarray(want), **LOGIT_TOL)
    assert np.isfinite(np.asarray(got)).all()


def test_soft_caps_bite_in_the_tiny_model(ckpts):
    """The caps of the Gemma-2 variant bite: most final logits of the
    port's uncapped twin exceed FINAL_CAP / 2 in magnitude (where tanh
    bends them by more than 4 %), and the capped logits stay within the
    cap."""
    japp, tapp = make_apps(ckpts["gemma2"], "gemma2")
    ids, mask = ids_of([20, 13], seed=1)
    tapp.spec = dataclasses.replace(tapp.spec, logits_soft_cap=None)
    raw = np.asarray(tapp.generate(ids, attention_mask=mask,
                                   max_new_tokens=1,
                                   return_logits=True)["logits"][0])
    capped = np.asarray(japp.generate(ids, attention_mask=mask,
                                      max_new_tokens=1,
                                      return_logits=True)["logits"][0])
    assert (np.abs(raw) > FINAL_CAP / 2).mean() > 0.5
    assert np.abs(capped).max() <= FINAL_CAP


# ---------------------------------------------------------------------------
# longrope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_pos,factors", [(32, "short"), (128, "long")])
@pytest.mark.parametrize("theta", [10000.0, 250000.0])
def test_longrope_inv_freq_and_cos_sin_bit_exact(max_pos, factors, theta):
    """The longrope inverse frequencies equal the JAX function's bit for
    bit (the long list above the original 32 positions, the short one at
    it), and cos/sin with the attention factor too."""
    kw = dict(head_dim=16, rope_theta=theta, scaling_type="longrope",
              original_max_position=32, max_position=max_pos,
              short_factor=tuple(LONGROPE["short_factor"]),
              long_factor=tuple(LONGROPE["long_factor"]))
    got = trope.compute_inv_freq(trope.RopeConfig(**kw)).numpy()
    want = np.asarray(jrope.compute_inv_freq(jrope.RopeConfig(**kw)))
    np.testing.assert_array_equal(got, want)
    base = trope.compute_inv_freq(trope.RopeConfig(16, theta)).numpy()
    ext = np.asarray(LONGROPE[factors + "_factor"], np.float32)
    np.testing.assert_array_equal(got, base / ext)
    pos = np.arange(0, 128, dtype=np.int32)[None, :]
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos),
                                trope.RopeConfig(**kw))
    jc, js = jrope.rope_cos_sin(pos, jrope.RopeConfig(**kw))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    f = trope.longrope_attention_factor(trope.RopeConfig(**kw))
    assert (f > 1.0) == (max_pos > 32)


@pytest.mark.parametrize("legacy", ["su", "longrope"])
def test_su_alias_and_top_level_original_positions(legacy):
    """``spec_from_config`` maps the legacy ``"su"`` to longrope and reads
    ``original_max_position_embeddings`` from the config's top level, as
    the JAX package does; the inverse frequencies equal JAX's."""
    hf = dict(model_type="phi3", hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=256, rms_norm_eps=1e-5,
              max_position_embeddings=128,
              original_max_position_embeddings=32,
              rope_scaling=dict(LONGROPE, type=legacy))
    jfam, tfam = j_get_family("phi3"), get_family("phi3")
    jspec = jfam.build_spec(jfam.config_cls(
        JTpuConfig(batch_size=1, seq_len=32), **hf), tp_degree=1)
    tspec = tfam.build_spec(tfam.config_cls(
        TpuConfig(batch_size=1, seq_len=32), **hf), tp_degree=1)
    assert tspec.rope.scaling_type == "longrope"
    assert tspec.rope.original_max_position == 32
    assert tspec.rope.max_position == 128
    _rope_fields(tspec.rope, jspec.rope)
    np.testing.assert_array_equal(
        model_base.rope_inv_freq(tspec, torch.device("cpu")).numpy(),
        np.asarray(jrope.compute_inv_freq(jspec.rope)))


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------

def test_dual_rope_tables_and_activation_refusal():
    """Gemma-3's app keeps both inverse-frequency tables on its device
    (the local one at rope_local_base_freq); an activation outside
    ACT_FNS is refused by name, every one inside it is accepted; an
    unknown override is a TypeError."""
    hf = dict(model_type="gemma3_text", hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              vocab_size=256, sliding_window=8, rope_theta=1e6,
              rope_local_base_freq=1e4, query_pre_attn_scalar=16)
    cls = get_family("gemma3").config_cls
    app = TpuGemma3ForCausalLM(None, cls(TpuConfig(batch_size=1,
                                                   seq_len=32), **hf),
                               device="cpu")
    inv_g, inv_l = app._inv_freq
    np.testing.assert_array_equal(
        inv_l.numpy(), trope.compute_inv_freq(
            trope.RopeConfig(16, 1e4)).numpy())
    np.testing.assert_array_equal(
        inv_g.numpy(), trope.compute_inv_freq(
            trope.RopeConfig(16, 1e6)).numpy())
    assert app.spec.act == "gelu_pytorch_tanh"
    assert app.spec.layer_pattern == (True, True)
    qcls = get_family("qwen2").config_cls
    base = dict(model_type="qwen2", hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=256)
    for act in sorted(model_base.ACT_FNS):
        TpuQwen2ForCausalLM(None, qcls(TpuConfig(batch_size=1, seq_len=32),
                                       hidden_act=act, **base),
                            device="cpu")
    with pytest.raises(ConfigurationError, match="quick_gelu"):
        TpuQwen2ForCausalLM(None, qcls(TpuConfig(batch_size=1, seq_len=32),
                                       hidden_act="quick_gelu", **base),
                            device="cpu")
    with pytest.raises(TypeError, match="post_residual"):
        model_base.spec_from_config(
            qcls(TpuConfig(batch_size=1, seq_len=32), **base),
            post_residual=True)


def test_gelu_tanh_matches_jax():
    """``gelu_pytorch_tanh`` (and ``gelu_new``) is the tanh approximation
    on both sides, ``gelu`` the exact one."""
    from neuronx_distributed_inference_tpu.models import model_base as jmb
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    for name in ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu2"):
        np.testing.assert_allclose(
            model_base.ACT_FNS[name](torch.from_numpy(x)).numpy(),
            np.asarray(jmb.ACT_FNS[name](x)), atol=2e-6, err_msg=name)
