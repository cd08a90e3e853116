"""The GPT-OSS family of the port against the JAX package's, end to end:
YaRN RoPE, the spec, the converter (bf16 and MXFP4 checkpoint layouts),
the paged app's logits, the ragged and two-phase engines' streams, the
contiguous app, and its mixed per-layer cache above the window.

The tiny GPT-OSS of tests/test_gpt_oss.py:17-37 (hidden 64, 4 layers
alternating sliding / full, window 8, 4 q / 2 kv heads, 4 experts of
which 2 per token, YaRN factor 2 with ``truncate`` false) is written as
HF stores it, from numpy with a seed, at head_dim 16 (the paged step's
gather path on both sides) and head_dim 64 (the kernel-gated branch: the
JAX Pallas kernel in interpret mode, the port's wrapper on its plain
twin). Its sinks are drawn N(0, 1) and every bias N(0, 0.02), so those
paths carry values. Both packages load it with ``load_weights``; prompts
are longer than the window, so the window bites. fp32 logits agree at
atol=2e-3, rtol=1e-3 (the suite's HF tolerance,
tests/test_llama_golden.py:63); tokens and streams are equal; converted
leaves are equal bit for bit."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.gpt_oss import \
    GptOssFamily as JGptOssFamily
from neuronx_distributed_inference_tpu.models.model_base import \
    fuse_qkv_host as j_fuse_qkv_host
from neuronx_distributed_inference_tpu.modules.quantization import \
    dequant_oai_mxfp4_blocks as j_dequant
from neuronx_distributed_inference_tpu.ops import rope as jrope
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.models.gpt_oss import (
    GptOssFamily, TpuGptOssForCausalLM)
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.modules.quantization import \
    dequant_oai_mxfp4_blocks
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from neuronx_distributed_inference_tpu_torch.ops import rope as trope
from neuronx_distributed_inference_tpu_torch.utils.checkpoint import \
    load_state_dict
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_serving_engine import _serve

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
WINDOW = 8
HEAD_DIMS = {"hd16": 16, "hd64": 64}
PAGED = dict(batch_size=2, seq_len=128, dtype="float32",
             is_block_kv_layout=True, pa_block_size=16,
             is_prefix_caching=True, context_encoding_buckets=[32, 64])
RNG = np.random.default_rng(23)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (40, 23, 57)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


HF_CONFIG = dict(
    model_type="gpt_oss", architectures=["GptOssForCausalLM"],
    hidden_size=64, intermediate_size=32, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
    rms_norm_eps=1e-5, max_position_embeddings=128, rope_theta=150000.0,
    sliding_window=WINDOW, num_local_experts=4, num_experts_per_tok=2,
    rope_scaling={"rope_type": "yarn", "factor": 2.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "truncate": False,
                  "original_max_position_embeddings": 64},
    layer_types=["sliding_attention", "full_attention"] * 2,
    attention_bias=True, tie_word_embeddings=False, hidden_act="silu",
    swiglu_limit=7.0, torch_dtype="float32")


def _save_checkpoint(d, head_dim, window=WINDOW):
    """The tiny model of tests/test_gpt_oss.py:17-37 as HF
    ``GptOssForCausalLM`` stores it (config.json + model.safetensors),
    written from numpy with a seed: matrices N(0, 0.02), norms 1 + N(0,
    0.1), sinks N(0, 1) and every bias N(0, 0.02)."""
    from safetensors.numpy import save_file
    cfg = dict(HF_CONFIG, head_dim=head_dim, sliding_window=window)
    rng = np.random.default_rng(1)
    h, v, n_exp, inter = 64, 256, 4, 32
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]

    def w(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(v, h), "lm_head.weight": w(v, h),
          "model.norm.weight": 1 + w(h, std=0.1)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, rows in (("q", nq * head_dim), ("k", nkv * head_dim),
                           ("v", nkv * head_dim)):
            sd[p + f"self_attn.{name}_proj.weight"] = w(rows, h)
            sd[p + f"self_attn.{name}_proj.bias"] = w(rows)
        sd[p + "self_attn.o_proj.weight"] = w(h, nq * head_dim)
        sd[p + "self_attn.o_proj.bias"] = w(h)
        sd[p + "self_attn.sinks"] = w(nq, std=1.0)
        sd[p + "input_layernorm.weight"] = 1 + w(h, std=0.1)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(h, std=0.1)
        sd[p + "mlp.router.weight"] = w(n_exp, h, std=0.2)
        sd[p + "mlp.router.bias"] = w(n_exp)
        sd[p + "mlp.experts.gate_up_proj"] = w(n_exp, h, 2 * inter)
        sd[p + "mlp.experts.gate_up_proj_bias"] = w(n_exp, 2 * inter)
        sd[p + "mlp.experts.down_proj"] = w(n_exp, inter, h)
        sd[p + "mlp.experts.down_proj_bias"] = w(n_exp, h)
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """'hd16' / 'hd64' -> a saved tiny checkpoint; '<hd>_w48' -> the same
    weights with ``sliding_window`` 48 (the contiguous app's case)."""
    out = {}
    for tag, hd in HEAD_DIMS.items():
        out[tag] = _save_checkpoint(tmp_path_factory.mktemp(tag), hd)
        out[tag + "_w48"] = _save_checkpoint(
            tmp_path_factory.mktemp(tag + "_w48"), hd, window=48)
    return out


def _configs(ckpt, **tcfg):
    """(JAX config, port config) of ``ckpt`` under the same TpuConfig."""
    return (JGptOssFamily.config_cls(JTpuConfig(**tcfg),
                                     load_config=j_load_config(ckpt)),
            GptOssFamily.config_cls(TpuConfig(**tcfg),
                                    load_config=load_pretrained_config(
                                        ckpt)))


# ---------------------------------------------------------------------------
# RoPE, spec, converter
# ---------------------------------------------------------------------------

YARN = {
    # gpt-oss-20b's rope_scaling
    "gpt_oss": dict(head_dim=64, rope_theta=150000.0, scaling_type="yarn",
                    scaling_factor=32.0, beta_fast=32.0, beta_slow=1.0,
                    mscale=0.0, mscale_all_dim=0.0,
                    original_max_position=4096, truncate=False),
    # DeepSeek-V3's: mscale over mscale_all_dim, truncated bounds, the
    # 64-wide rope part of its heads
    "deepseek": dict(head_dim=64, rope_theta=10000.0, scaling_type="yarn",
                     scaling_factor=40.0, beta_fast=32.0, beta_slow=1.0,
                     mscale=1.0, mscale_all_dim=1.0,
                     original_max_position=4096, truncate=True),
}


@pytest.mark.parametrize("case", sorted(YARN))
def test_yarn_cos_sin_match_jax(case):
    """YaRN cos/sin (attention factor included) at positions up to 131072
    against JAX's, fp32: inverse frequencies equal, cos/sin within 1e-6."""
    kw = YARN[case]
    pos = np.random.default_rng(3).integers(0, 131072, size=(2, 64))
    jc, js = jrope.rope_cos_sin(jax.numpy.asarray(pos), jrope.RopeConfig(**kw))
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), trope.RopeConfig(**kw))
    np.testing.assert_array_equal(
        trope.compute_inv_freq(trope.RopeConfig(**kw)).numpy(),
        np.asarray(jrope.compute_inv_freq(jrope.RopeConfig(**kw))))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert trope.yarn_attention_factor(trope.RopeConfig(**kw)) == \
        jrope.yarn_attention_factor(jrope.RopeConfig(**kw))


def _same_fields(got, want, where):
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, getattr(want, f.name), f"{where}.{f.name}")
        elif f.name not in ("gqa", "dtype", "kv_dtype"):
            assert a == getattr(want, f.name), (where, f.name)


def test_build_spec_matches_jax(ckpts):
    """``GptOssFamily.build_spec`` field by field against JAX's: every
    field of the port's spec, RopeConfig and MoESpec included, equals the
    reference's; GQA layout and dtypes by name."""
    jcfg, tcfg = _configs(ckpts["hd16"], **PAGED)
    want = JGptOssFamily.build_spec(jcfg, tp_degree=1)
    got = get_family("gpt_oss").build_spec(tcfg, tp_degree=1)
    _same_fields(got, want, "spec")
    assert got.layer_pattern == (True, False, True, False)
    assert got.attn_sink and got.qkv_bias and got.o_bias
    assert not want.mixed_kv and not want.rolling_window
    assert got.rope.scaling_type == "yarn" and not got.rope.truncate
    assert (got.gqa.num_q_heads, got.gqa.num_kv_heads) == (
        want.gqa.num_q_heads, want.gqa.num_kv_heads)
    assert str(got.dtype) == "torch." + np.dtype(want.dtype).name
    assert [got.window(got.is_local(i)) for i in range(4)] == [WINDOW, 0,
                                                                WINDOW, 0]


def _mxfp4_layout(sd, rng):
    """The state dict with each layer's expert projections replaced by
    random MXFP4 ``_blocks`` (uint8 (E, out, K/32, 16)) and ``_scales``
    (e8m0 around 2^0)."""
    sd = dict(sd)
    for name in [k for k in sd if k.endswith(("gate_up_proj", "down_proj"))
                 and ".experts." in k]:
        e, k_in, n_out = sd.pop(name).shape
        sd[name + "_blocks"] = rng.integers(0, 256, size=(
            e, n_out, k_in // 32, 16), dtype=np.uint8)
        sd[name + "_scales"] = rng.integers(120, 130, size=(
            e, n_out, k_in // 32), dtype=np.uint8)
    return sd


@pytest.mark.parametrize("layout", ["bf16", "mxfp4"])
def test_converter_matches_jax_leaf_by_leaf(ckpts, layout):
    """``convert_hf_state_dict`` + ``fuse_qkv_host`` on the tiny
    checkpoint's state dict (as stored, and with its experts in the native
    MXFP4 layout): the same leaves as JAX's, equal bit for bit, fp32
    sinks and router included."""
    sd = load_state_dict(ckpts["hd16"])
    if layout == "mxfp4":
        sd = _mxfp4_layout(sd, np.random.default_rng(4))
    jcfg, tcfg = _configs(ckpts["hd16"], **PAGED)
    jspec = JGptOssFamily.build_spec(jcfg, tp_degree=1)
    tspec = GptOssFamily.build_spec(tcfg, tp_degree=1)
    want = j_fuse_qkv_host(JGptOssFamily.convert_hf_state_dict(sd, jspec))
    got = model_base.fuse_qkv_host(
        GptOssFamily.convert_hf_state_dict(sd, tspec))
    assert set(got) == set(want) and set(got["layers"]) == set(
        want["layers"])
    assert {"qkv_bias", "o_bias", "sink", "router_bias", "expert_gate_bias",
            "expert_up_bias", "expert_down_bias"} <= set(got["layers"])
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[key], want[key])
    for key, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][key], w, err_msg=key)
        assert got["layers"][key].dtype == np.asarray(w).dtype, key
    shapes = jax.tree.map(lambda p: tuple(p.shape),
                          model_base.decoder_param_specs(tspec),
                          is_leaf=lambda n: not isinstance(n, dict))
    assert shapes == jax.tree.map(lambda a: np.asarray(a).shape, got)


def test_dequant_oai_mxfp4_blocks_exact():
    """The MXFP4 decoder on random bytes and exponents equals JAX's bit
    for bit."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 256, size=(3, 5, 4, 16), dtype=np.uint8)
    scales = rng.integers(100, 150, size=(3, 5, 4), dtype=np.uint8)
    got = dequant_oai_mxfp4_blocks(blocks, scales)
    want = j_dequant(blocks, scales)
    assert got.shape == (3, 5, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The paged app and the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged(ckpts):
    """'hd16' / 'hd64' -> (JAX paged app, port paged app), both from
    ``load_weights`` of the checkpoint, with logits out."""
    out = {}
    for tag in HEAD_DIMS:
        jcfg, tcfg = _configs(ckpts[tag], output_logits=True, **PAGED)
        japp = JPagedApp(ckpts[tag], jcfg, JGptOssFamily)
        tapp = PagedCausalLMApplication(ckpts[tag], tcfg, GptOssFamily,
                                        device="cpu")
        out[tag] = (japp.load_weights().init_cache(),
                    tapp.load_weights().init_cache())
    return out


@pytest.mark.parametrize("hd", sorted(HEAD_DIMS))
def test_paged_logits_and_tokens_match_jax(paged, monkeypatch, hd):
    """Greedy paged ``generate`` of 6 tokens for prompts of 20 tokens
    (the window of 8 bites): prefill and every decode step's fp32 logits
    at LOGIT_TOL, tokens equal. At head_dim 64 the port's decode steps go
    through the kernel wrapper (its plain twin here) with each layer's
    window and sink; at head_dim 16 through the gather + ``mha``."""
    japp, tapp = paged[hd]
    japp.init_cache()
    tapp.init_cache()
    seen = []
    orig = decode_attention.paged_decode_attention

    def spy(*a, **k):
        seen.append((k["window"], k["sink"] is not None))
        return orig(*a, **k)
    monkeypatch.setattr(decode_attention, "paged_decode_attention", spy)
    ids = np.random.default_rng(6).integers(1, 256, size=(2, 20)).astype(
        np.int32)
    want = japp.generate(ids, max_new_tokens=6, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=6, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert len(got["logits"]) == len(want["logits"]) == 6
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)
    if hd == "hd64":
        assert seen[:4] == [(WINDOW, True), (0, True), (WINDOW, True),
                            (0, True)]
        assert len(seen) == 4 * 5
    else:
        assert seen == []


@pytest.mark.parametrize("hd", sorted(HEAD_DIMS))
@pytest.mark.parametrize("path,chunk", [("ragged", 16), ("ragged", 48),
                                        ("two_phase", 16)])
def test_served_streams_match_jax(paged, monkeypatch, hd, path, chunk):
    """Three requests (40, 23 and 57 tokens) through a batch of two on the
    port's ServingEngine equal the JAX engine's streams, finish reasons
    and counters, on the ragged path and the two-phase path. The ragged
    path runs mixed passes (a decode row beside a prefill chunk in one
    dispatch); all-decode passes take the MoE block's dense path, and a
    48-token chunk puts the mixed passes on its ragged one."""
    japp, tapp = paged[hd]
    japp.init_cache()                    # cold prefix caches
    tapp.init_cache()
    mixed = []
    orig = model_base.paged_ragged_step

    def spy(spec, tpu_cfg, params, cache, input_ids, position_ids,
            slot_mapping, block_table, widths, emit_modes, *a, **k):
        w = widths.tolist()
        mixed.append(1 in w and max(w) > 1)
        return orig(spec, tpu_cfg, params, cache, input_ids, position_ids,
                    slot_mapping, block_table, widths, emit_modes, *a, **k)
    monkeypatch.setattr(model_base, "paged_ragged_step", spy)
    experts = {"experts_dense": 0, "experts_ragged": 0}
    for name in experts:
        def counted(*a, _orig=getattr(tmoe, name), _name=name, **k):
            experts[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tmoe, name, counted)
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    ragged = path == "ragged"
    want = _serve(japp, "jax", ragged, subs, chunk=chunk)
    got = _serve(tapp, "port", ragged, subs, chunk=chunk)
    assert got[:3] == want[:3]
    assert all(len(t) == n for t, (_, n, _) in zip(got[0], subs))
    assert any(mixed) == ragged
    assert experts["experts_dense"] > 0
    assert (experts["experts_ragged"] > 0) == (ragged and chunk == 48)


def test_jax_gpt_oss_tree_carries_over(paged):
    """The JAX app's tree through ``params_from_numpy``: the fused
    ``qkv_bias``, ``o_bias``, fp32 ``sink``, router bias and expert biases
    keep their values and dtypes, and the port app holding it gives the
    logits of the one that loaded the checkpoint."""
    japp, tapp = paged["hd16"]
    host = jax.tree.map(np.asarray, japp.params)
    got = params_from_numpy(host, device="cpu")
    for key in ("qkv_bias", "o_bias", "sink", "router_bias",
                "expert_gate_bias", "expert_up_bias", "expert_down_bias"):
        np.testing.assert_array_equal(got["layers"][key].numpy(),
                                      host["layers"][key], err_msg=key)
        torch.testing.assert_close(got["layers"][key],
                                   tapp.params["layers"][key], rtol=0,
                                   atol=0)
    assert got["layers"]["sink"].dtype == torch.float32
    assert float(got["layers"]["sink"].abs().max()) > 0.1


# ---------------------------------------------------------------------------
# The contiguous app and TpuGptOssForCausalLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", sorted(HEAD_DIMS))
def test_contiguous_app_matches_jax(ckpts, hd):
    """``TpuGptOssForCausalLM`` at seq_len 48 <= sliding_window 48 (the
    reference keeps the full cache there): prefill and decode logits and
    tokens against JAX's contiguous app. At head_dim 64 decode runs the
    contiguous kernel's wrapper with the per-layer window and the sink on
    both sides; at head_dim 16 the gather + ``mha_hl``."""
    ckpt = ckpts[hd + "_w48"]
    kw = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
    jcfg, tcfg = _configs(ckpt, **kw)
    japp = JApp(ckpt, jcfg, JGptOssFamily).load_weights().init_cache()
    tapp = TpuGptOssForCausalLM(ckpt, tcfg, device="cpu")
    assert type(tapp) is CausalLMApplication
    tapp.load_weights().init_cache()
    assert not japp.spec.mixed_kv
    ids = np.random.default_rng(7).integers(1, 256, size=(2, 30)).astype(
        np.int32)
    want = japp.generate(ids, max_new_tokens=6, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=6, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)


def test_mixed_cache_is_refused_where_the_reference_picks_it(ckpts,
                                                            monkeypatch):
    """At seq_len 48 > sliding_window 8 ``TpuGptOssForCausalLM`` takes the
    mixed per-layer cache where the reference's contiguous app does (the
    port refused it before it had the cache): the same stacks (global
    rows of 48 slots, local rows of 8), and at head_dim 64 every step's
    logits and the greedy tokens equal JAX's, with the decode kernel (its
    plain twin here) on the two global layers at their index in the
    global stack and the local layers on the gather path over their
    rolling rows. The paged layout serves the same config over the
    uniform block cache. (The name is the one the test had while it
    checked the refusal.)"""
    kw = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
    jcfg, tcfg = _configs(ckpts["hd64"], **kw)
    japp = JApp(ckpts["hd64"], jcfg, JGptOssFamily).load_weights()
    tapp = TpuGptOssForCausalLM(ckpts["hd64"], tcfg, device="cpu")
    assert japp.spec.mixed_kv and tapp.spec.mixed_kv
    japp.init_cache()
    tapp.load_weights().init_cache()
    assert {k: tuple(v.shape) for k, v in tapp.cache.items()} == {
        k: tuple(v.shape) for k, v in japp.cache.items()}
    assert tapp.cache["k_l"].shape[-1] == WINDOW
    layers = []
    kernel = decode_attention.decode_attention_stacked

    def spy(*a, **k):
        layers.append((a[5], k["window"], k["sink"] is not None))
        return kernel(*a, **k)
    monkeypatch.setattr(decode_attention, "decode_attention_stacked", spy)
    ids = np.random.default_rng(8).integers(1, 256, size=(2, 21)).astype(
        np.int32)
    want = japp.generate(ids, max_new_tokens=6, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=6, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)
    assert layers == [(0, 0, True), (1, 0, True)] * 5
    _, pcfg = _configs(ckpts["hd16"], **dict(kw, is_block_kv_layout=True,
                                             pa_block_size=16))
    app = PagedCausalLMApplication(None, pcfg, GptOssFamily, device="cpu")
    assert app.spec.layer_pattern == (True, False, True, False)
    assert not app.spec.mixed_kv


@pytest.mark.cuda
def test_cuda_bf16_mha_sink_rides_the_scores_buffer():
    """On the card: ``mha`` with a sink at a mixed pass's shapes (64 q
    over 8 kv heads, D 64, 256 queries over 4096 keys) writes its scores
    into the buffer that holds the sink column (no copy of the scores:
    peak memory below 2.2x the fp32 scores, the buffer and the softmax's
    output; appending the column by concatenation takes 3.5x) and equals
    a float64 softmax with the sink appended as a column, within bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    from neuronx_distributed_inference_tpu_torch.ops import attention as ta
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, t, s, hq, hkv, d = 1, 256, 4096, 64, 8, 64
    q = torch.randn((b, t, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
    sink = torch.randn((hq,), generator=g, device=dev)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, -t:, None] >= pos[None, None, :])      # causal tail
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ta.mha(q, k, v, mask, d ** -0.5, sink=sink)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    scores = b * hq * t * s * 4
    assert extra < 2.2 * scores, (extra, scores)
    qf, kf, vf = (x.double() for x in (q, k, v))
    sc = torch.einsum("bthd,bshd->bhts", qf, kf.repeat_interleave(
        hq // hkv, dim=2)) * d ** -0.5
    sc = sc.masked_fill(~mask[:, None], float("-inf"))
    col = sink.double()[None, :, None, None].expand(b, hq, t, 1)
    p = torch.softmax(torch.cat([sc, col], -1), -1)[..., :s]
    want = torch.einsum("bhts,bshd->bthd", p, vf.repeat_interleave(
        hq // hkv, dim=2))
    assert float((out.double() - want).abs().max()) < 2e-2
