"""The DeepSeek-V2/V3 family of the port against HF and the JAX package:
multi-head latent attention (MLA), the mixed dense / MoE stack, the V
narrower than K in the cache, the interleaved RoPE pairing, and their
gates and refusals.

The two tiny configs of tests/test_deepseek_dbrx.py:42-91 (q-LoRA with
``first_k_dense_replace=2`` and ``n_group=2``; no q-LoRA, all-MoE, YaRN
with mscale) and an all-dense DeepSeek (no ``n_routed_experts``) are
built as HF ``DeepseekV3ForCausalLM`` from a torch seed, with the router
weights scaled to N(0, 0.2) and ``e_score_correction_bias`` drawn N(0,
0.05) (HF leaves it at zero), so routing is decisive and the bias path
carries values. Both packages load each checkpoint with ``load_weights``
(the port's app then takes the JAX tree through ``params_from_numpy``
where the two are compared). fp32 logits agree at atol=2e-3, rtol=1e-3
(the suite's HF tolerance, tests/test_llama_golden.py:63); greedy tokens
and served streams are equal; caches and converted leaves are equal."""

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
from neuronx_distributed_inference_tpu.models.deepseek import \
    DeepseekFamily as JDeepseekFamily
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.ops import rope as jrope
from neuronx_distributed_inference_tpu.serving import \
    ContinuousBatchingAdapter as JCbAdapter
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.deepseek import (
    DeepseekFamily, TpuDeepseekForCausalLM)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.modules import kv_cache as tkv
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.ops import (decode_attention,
                                                         flash_attention)
from neuronx_distributed_inference_tpu_torch.ops import rope as trope
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.serving import \
    ContinuousBatchingAdapter
from neuronx_distributed_inference_tpu_torch.serving.warmup import precompile
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_contiguous_app import _staggered
from test_torch_gpt_oss import _same_fields

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
BASE = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            vocab_size=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            tie_word_embeddings=False, attention_bias=False,
            torch_dtype="float32")
CONFIGS = {
    # tests/test_deepseek_dbrx.py:44-54
    "qlora_mixed": (0, dict(
        BASE, num_hidden_layers=4, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=2, n_group=2,
        topk_group=1, norm_topk_prob=True, routed_scaling_factor=1.5,
        q_lora_rank=24, max_position_embeddings=128, rope_scaling=None)),
    # tests/test_deepseek_dbrx.py:70-83
    "yarn_all_moe": (1, dict(
        BASE, num_hidden_layers=2, n_routed_experts=4, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=0, n_group=1,
        topk_group=1, q_lora_rank=None, max_position_embeddings=256,
        rope_scaling={"rope_type": "yarn", "factor": 2.0,
                      "original_max_position_embeddings": 64,
                      "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 1.0,
                      "mscale_all_dim": 1.0})),
    # every layer dense: no routed experts
    "all_dense": (2, dict(
        BASE, num_hidden_layers=3, n_routed_experts=None,
        first_k_dense_replace=3, q_lora_rank=24,
        max_position_embeddings=128, rope_scaling=None)),
}
STATIC = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
CB = dict(batch_size=4, seq_len=32, dtype="float32",
          context_encoding_buckets=[16], is_continuous_batching=True)
PROMPT_LEN = 12


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _hf_model(case):
    os.environ.setdefault("USE_TF", "0")
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM
    seed, kw = CONFIGS[case]
    torch.manual_seed(seed)
    hf = DeepseekV3ForCausalLM(DeepseekV3Config(**kw))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in hf.named_buffers():
            if name.endswith("e_score_correction_bias"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=gen))
        for name, w in hf.named_parameters():
            if name.endswith("mlp.gate.weight"):
                w.copy_(0.2 * torch.randn(w.shape, generator=gen))
    return hf.eval()


def _port_app(ckpt, **tcfg):
    fam = get_family("deepseek_v3")
    return TpuDeepseekForCausalLM(ckpt, fam.config_cls(
        TpuConfig(**tcfg), load_config=load_pretrained_config(ckpt)),
        device="cpu")


def _jax_app(ckpt, **tcfg):
    return JApp(ckpt, JDeepseekFamily.config_cls(
        JTpuConfig(**tcfg), load_config=j_load_config(ckpt)),
        JDeepseekFamily)


def _carry(japp, tapp):
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    return tapp.init_cache()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """case -> dict: the saved checkpoint, the HF model, its prefill
    logits and greedy stream on one batch of prompts, the JAX app and the
    port app (own ``load_weights``), each at STATIC."""
    out = {}
    ids = np.random.default_rng(0).integers(1, 250, size=(2, PROMPT_LEN))
    for case in CONFIGS:
        hf = _hf_model(case)
        d = str(tmp_path_factory.mktemp(case))
        hf.save_pretrained(d, safe_serialization=True)
        with torch.no_grad():
            seq = hf.generate(torch.tensor(ids), max_new_tokens=8,
                              do_sample=False, pad_token_id=0,
                              eos_token_id=None).numpy()
            logits = hf(torch.tensor(seq[:, :-1])).logits.numpy()
        out[case] = dict(
            ckpt=d, ids=ids, hf_seq=seq, hf_logits=logits,
            japp=_jax_app(d, **STATIC).load_weights().init_cache(),
            tapp=_port_app(d, **STATIC).load_weights().init_cache())
    return out


# ---------------------------------------------------------------------------
# spec, converter, RoPE and the attention cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["deepseek_v2", "deepseek_v3"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_build_spec_matches_jax(case, model_type):
    """The spec the port resolves equals the JAX family's on every field
    the port has (MLASpec, RopeConfig and MoESpec included; GQA and
    dtypes by name), for both registered model types."""
    hf = dict(CONFIGS[case][1], model_type=model_type)
    want = JDeepseekFamily.build_spec(JDeepseekFamily.config_cls(
        JTpuConfig(**STATIC), **hf), tp_degree=1)
    fam = get_family(model_type)
    assert fam is DeepseekFamily
    got = fam.build_spec(fam.config_cls(TpuConfig(**STATIC), **hf),
                         tp_degree=1)
    _same_fields(got, want, "spec")
    assert (got.gqa.num_q_heads, got.gqa.num_kv_heads) == (
        want.gqa.num_q_heads, want.gqa.num_kv_heads)
    assert str(got.dtype) == "torch." + np.dtype(want.dtype).name
    assert got.head_dim == 24 and got.v_head_dim == 16
    assert got.rope.head_dim == 8 and got.rope_interleaved
    assert (got.moe is None) == (case == "all_dense")


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_converter_and_param_specs_match_jax(models, case):
    """The port's converted tree equals the JAX tree leaf for leaf (the
    mixed stack's ``layers`` / ``moe_layers``, every MLA leaf, the fp32
    router and its bias); ``params_from_numpy`` carries the JAX tree bit
    for bit; ``decoder_param_specs`` gives every leaf's shape."""
    m = models[case]
    want = jax.tree.map(np.asarray, m["japp"].params)
    got = jax.tree.map(lambda t: t.numpy(), m["tapp"].params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    carried = jax.tree.map(lambda t: t.numpy(),
                           params_from_numpy(want, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, carried, want)
    shapes = jax.tree.map(
        lambda p: tuple(p.shape),
        model_base.decoder_param_specs(m["tapp"].spec),
        is_leaf=lambda n: not isinstance(n, dict))
    assert shapes == jax.tree.map(lambda a: a.shape, want)
    stacks = {"qlora_mixed": {"layers": 2, "moe_layers": 2},
              "yarn_all_moe": {"layers": 2},
              "all_dense": {"layers": 3}}[case]
    assert {k: got[k]["input_norm"].shape[0] for k in stacks} == stacks
    assert "moe_layers" in got or case != "qlora_mixed"
    for stack in stacks:
        assert "qkv_proj" not in got[stack] and "kv_b_proj" in got[stack]


@pytest.mark.parametrize("interleaved", [True, False])
def test_apply_rope_matches_jax(interleaved):
    """``apply_rope`` in both pairings against JAX's, fp32, on heads
    wider than the rotary dim (the rest passes through)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 12)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(2, 5, 4)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = jrope.apply_rope(x, cos, sin, interleaved=interleaved)
    got = trope.apply_rope(*(torch.from_numpy(a) for a in (x, cos, sin)),
                           interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


@pytest.mark.parametrize("dim,theta", [(8, 10000.0), (64, 50000.0),
                                       (64, 10000.0)])
def test_rope_head_inv_freq_bit_exact(dim, theta):
    """The rope head's inverse frequencies (DeepSeek replaces the rope
    width with ``qk_rope_head_dim``; Moonlight-16B-A3B: 64 at theta
    50000) equal XLA's bit for bit, plain and YaRN."""
    for kw in ({}, dict(scaling_type="yarn", scaling_factor=40.0,
                        mscale=1.0, mscale_all_dim=1.0,
                        original_max_position=4096)):
        np.testing.assert_array_equal(
            trope.compute_inv_freq(trope.RopeConfig(dim, theta, **kw))
            .numpy(),
            np.asarray(jrope.compute_inv_freq(
                jrope.RopeConfig(dim, theta, **kw))))


def _attn_inputs(dk, dv, seed=0, b=2, t=3, s=11, hq=4, hkv=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    mask = rng.random((b, t, s)) < 0.8
    mask[..., 0] = True
    return q, k, v, mask


def _mha_f64(q, k, v, mask, scale):
    g = q.shape[2] // k.shape[2]
    k = np.repeat(k, g, axis=2).astype(np.float64)
    v = np.repeat(v, g, axis=2).astype(np.float64)
    sc = np.einsum("bthd,bshd->bhts", q.astype(np.float64), k) * scale
    sc = np.where(mask[:, None], sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
def test_attention_cores_take_a_narrow_v(dk, dv):
    """``mha``, ``mha_hl`` and ``mha_decode_merged`` with V narrower than
    K (MLA) give (B, T, Hq, Dv) equal to a float64 softmax attention and
    to JAX's ``mha``, on the CPU route (fp32 copies)."""
    q, k, v, mask = _attn_inputs(dk, dv)
    scale = dk ** -0.5
    want = _mha_f64(q, k, v, mask, scale)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = tattn.mha(tq, tk, tv, tm, scale)
    assert got.shape == q.shape[:3] + (dv,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jattn.mha(q, k, v, mask, scale)),
        atol=1e-5, rtol=1e-5)
    hl = tattn.mha_hl(tq, tk.permute(0, 2, 3, 1), tv.transpose(1, 2), tm,
                      scale)
    np.testing.assert_allclose(hl.numpy(), want, atol=1e-5, rtol=1e-5)
    # one decode query over prior slots [0, 6), side slots [6, 10) (two
    # written) and the active token at 10
    q1, m1 = tq[:, :1], np.zeros((2, 1, 11), bool)
    m1[..., :6] = m1[..., 8:] = True
    sl = slice(6, 10)
    merged = tattn.mha_decode_merged(
        q1, tk.permute(0, 2, 3, 1)[..., :6], tv.transpose(1, 2)[:, :, :6],
        torch.from_numpy(m1[..., :6]), tk[:, sl].permute(0, 2, 3, 1),
        tv[:, sl].transpose(1, 2), torch.from_numpy(m1[..., sl]),
        tk[:, 10:], tv[:, 10:], scale)
    np.testing.assert_allclose(merged.numpy(),
                               _mha_f64(q[:, :1], k, v, m1, scale),
                               atol=1e-5, rtol=1e-5)


def test_kv_cache_spec_v_width():
    """``KVCacheSpec.v_head_dim``: K (L, B, H, Dk, S), V (L, B, H, S, Dv);
    writes, reads, row gathers and ``commit_chunk`` take each tensor's own
    width."""
    spec = tkv.KVCacheSpec(2, 3, 10, 2, 24, torch.float32, v_head_dim=16)
    assert spec.k_shape == (2, 3, 2, 24, 10)
    assert spec.v_shape == (2, 3, 2, 10, 16)
    c = tkv.init_cache(spec, torch.device("cpu"))
    assert tkv.cache_len_of(c) == 10
    k = torch.randn(3, 1, 2, 24)
    v = torch.randn(3, 1, 2, 16)
    pos = torch.tensor([[1], [4], [7]])
    rows = torch.tensor([2, 0, 1])
    tkv.write_tokens_at_layer(c["k"], k, 1, rows, pos, k_transposed=True)
    tkv.write_tokens_at_layer(c["v"], v, 1, rows, pos)
    for r, (row, p) in enumerate(zip(rows.tolist(), pos[:, 0].tolist())):
        assert torch.equal(c["k"][1, row, :, :, p], k[r, 0])
        assert torch.equal(c["v"][1, row, :, p], v[r, 0])
    got = tkv.gather_cache_rows(tkv.read_layer_hl(c["v"], 1), rows)
    assert got.shape == (3, 2, 10, 16)
    side_k = torch.randn(2, 3, 2, 24, 4)
    side_v = torch.randn(2, 3, 2, 4, 16)
    start = torch.tensor([0, 2, 6])
    tkv.commit_chunk(c["k"], side_k, torch.arange(3), start,
                     k_transposed=True)
    tkv.commit_chunk(c["v"], side_v, torch.arange(3), start)
    assert torch.equal(c["k"][:, 1, :, :, 2:6], side_k[:, 1])
    assert torch.equal(c["v"][:, 2, :, 6:10], side_v[:, 2])


# ---------------------------------------------------------------------------
# the model against HF and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_logits_and_stream_match_hf(models, case):
    """The port (its own ``load_weights``) against HF: the prefill's and
    every decode step's logits, and the greedy stream."""
    m = models[case]
    app = m["tapp"]
    app.reset()
    res = app.generate(m["ids"].astype(np.int32), max_new_tokens=8,
                       return_logits=True)
    np.testing.assert_array_equal(res["sequences"], m["hf_seq"])
    hf = m["hf_logits"]
    p = PROMPT_LEN
    np.testing.assert_allclose(res["logits"][0][:, :p], hf[:, :p],
                               **LOGIT_TOL)
    for j in range(1, 8):
        np.testing.assert_allclose(res["logits"][j][:, 0], hf[:, p - 1 + j],
                                   err_msg=f"step {j}", **LOGIT_TOL)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_logits_stream_and_cache_match_jax(models, case, chunk):
    """On the JAX tree (``params_from_numpy``): the K and V caches after a
    ragged-length prefill equal JAX's in layout (K 24 wide on axis 3, V 16
    on the last axis) and value; every step's logits agree; the greedy
    streams are equal, per step (chunk 1) and through the chunked
    side-buffer decode loop (chunk 4: V side buffers at ``v_head_dim``)."""
    m = models[case]
    japp, tapp = m["japp"], m["tapp"]
    tapp = _carry(japp, _port_app(m["ckpt"], **dict(
        STATIC, decode_chunk_tokens=chunk)))
    japp.reset()
    ids = m["ids"].astype(np.int32)
    lens = np.asarray([PROMPT_LEN, 9], np.int32)
    pad = np.zeros((2, 48), np.int32)
    pad[:, :PROMPT_LEN] = ids
    jout = japp._run_prefill(pad, lens)
    tout = tapp._run_prefill(pad, lens)
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **LOGIT_TOL)
    for name, shape in (("k", (2, 4, 24, 48)), ("v", (2, 4, 48, 16))):
        want = np.asarray(japp.cache[name])
        got = tapp.cache[name].numpy()
        assert got.shape == want.shape == (tapp.spec.num_layers,) + shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    mask = (np.arange(PROMPT_LEN)[None] < lens[:, None]).astype(np.int64)
    japp.reset()
    tapp.reset()
    kw = dict(attention_mask=mask, max_new_tokens=9)
    want = japp.generate(ids, return_logits=chunk == 1, **kw)
    got = tapp.generate(ids, return_logits=chunk == 1, **kw)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    if chunk == 1:
        for j, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {j}",
                                       **LOGIT_TOL)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_continuous_batching_streams_match_generate_and_jax(models, case):
    """``ContinuousBatchingAdapter`` (two requests joining at different
    times, then a fused ``step_many``) gives the JAX adapter's streams,
    and each stream equals its prompt's single-request ``generate``."""
    m = models[case]
    japp = _jax_app(m["ckpt"], **CB).load_weights().init_cache()
    tapp = _carry(japp, _port_app(m["ckpt"], **CB))
    rng = np.random.default_rng(1)
    p1 = rng.integers(1, 250, size=9).tolist()
    p2 = rng.integers(1, 250, size=14).tolist()
    got = _staggered(ContinuousBatchingAdapter(tapp), p1, p2)
    assert got == _staggered(JCbAdapter(japp), p1, p2)
    ref = m["tapp"]
    for prompt, stream in ((p1, got[0] + got[2]), (p2, got[1])):
        ref.reset()
        want = ref.generate(np.asarray([prompt], np.int32),
                            max_new_tokens=len(stream))["generated"][0]
        assert stream == want.tolist()


def test_decode_step_reads_no_device_value(models, monkeypatch):
    """A T = 1 decode step of the mixed stack (dense layers, then MoE
    layers on the dense all-experts path at B·T = 2 <= 64) reads no
    device value on the host, so it can be captured in a CUDA graph:
    every read of a tensor's data raises inside the step."""
    app = models["qlora_mixed"]["tapp"]
    app.reset()
    app.generate(models["qlora_mixed"]["ids"].astype(np.int32),
                 max_new_tokens=1)
    ids = torch.tensor([[5], [7]], dtype=torch.int32)
    pos = torch.full((2, 1), PROMPT_LEN, dtype=torch.int32)
    dense = []
    orig_dense = tmoe.experts_dense
    monkeypatch.setattr(tmoe, "experts_dense",
                        lambda *a, **k: dense.append(1) or orig_dense(*a,
                                                                      **k))

    def refuse(*a, **k):
        raise AssertionError("device read inside the decode step")
    for name in ("cpu", "item", "numpy", "tolist", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = model_base.token_generation_step(
        app.spec, app.tpu_config, app.params, app.cache, ids, pos,
        torch.arange(2, dtype=torch.int32), None, app.generator, None,
        app._inv_freq)
    monkeypatch.undo()
    assert out["tokens"].shape == (2,) and len(dense) == 2


# ---------------------------------------------------------------------------
# gates and refusals
# ---------------------------------------------------------------------------

# a q/k head of 128 (Instella-MoE-16B-A3B's 96 + 32): a width both kernels
# take, so only the MLA term of their gates keeps MLA off them
WIDE_HEAD = dict(BASE, model_type="deepseek_v3", num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=2,
                 qk_nope_head_dim=96, qk_rope_head_dim=32, v_head_dim=64,
                 n_routed_experts=4, n_shared_experts=1,
                 num_experts_per_tok=2, first_k_dense_replace=1,
                 q_lora_rank=None, max_position_embeddings=256)


def test_kernel_gates_refuse_mla_at_a_kernel_width(monkeypatch):
    """Latent fault 1, the MLA half: at a q/k head of 128 with
    ``attn_kernel_enabled=True``, ``decode_attention.supports`` and
    ``use_flash_prefill`` say no (each would say yes without MLA), and a
    prefill plus decode steps call neither kernel entry point."""
    fam = get_family("deepseek_v3")
    app = TpuDeepseekForCausalLM(None, fam.config_cls(TpuConfig(
        batch_size=2, seq_len=128, dtype="float32", attn_kernel_enabled=True,
        enable_bucketing=False), **WIDE_HEAD), device="cpu")
    spec = app.spec
    assert spec.head_dim == 128 and spec.v_head_dim == 64
    assert spec.flash_prefill and flash_attention.supports(128, 128, False, 0)
    plain = dataclasses.replace(spec, mla=None)
    assert decode_attention.supports(plain, 1)
    assert model_base.use_flash_prefill(plain, 128)
    assert not decode_attention.supports(spec, 1)
    assert not model_base.use_flash_prefill(spec, 128)
    calls = []
    for owner, name in ((decode_attention, "decode_attention_stacked"),
                        (decode_attention, "paged_decode_attention"),
                        (flash_attention, "flash_attention")):
        fn = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    app.init_random_weights(3).init_cache()
    ids = np.random.default_rng(2).integers(1, 250, size=(2, 20))
    out = app.generate(ids, max_new_tokens=4)
    assert out["generated"].shape == (2, 4) and calls == []


def _refusal(case):
    fam = get_family("deepseek_v3")
    hf = dict(CONFIGS["qlora_mixed"][1], model_type="deepseek_v3")
    cfg = fam.config_cls(TpuConfig(batch_size=1, seq_len=32), **hf)
    spec = fam.build_spec(cfg)
    mla, moe = spec.mla, spec.moe
    kw = dict(mla=mla, moe=moe, first_dense=2, head_dim=24)
    if case == "mla_rolling_cache":
        model_base.spec_from_config(cfg, sliding_window=8, **kw)
    elif case == "mla_mixed_cache":
        model_base.spec_from_config(cfg, sliding_window=8,
                                    layer_pattern=(True, False) * 2, **kw)
    elif case == "paged_app":
        PagedCausalLMApplication(None, fam.config_cls(TpuConfig(
            batch_size=1, seq_len=32, is_block_kv_layout=True,
            pa_block_size=16), **hf), fam, device="cpu")


# the two refusals Llama4's knobs lifted: each spec change now builds in
# both packages (the reference refuses neither)
LIFTED = {"mla_attn_chunk": dict(attn_chunk=8),
          "moe_pattern": dict(first_dense=0,
                              moe_pattern=(False, True, False, True))}


def _lifted_pair(case):
    """(JAX app, port app) of the qlora_mixed DeepSeek with ``LIFTED[case]``
    applied to both families' specs; the port holds the JAX app's random
    weights."""
    over = LIFTED[case]

    class JFam(JDeepseekFamily):
        @classmethod
        def build_spec(cls, config, tp_degree=None):
            return dataclasses.replace(
                JDeepseekFamily.build_spec(config, tp_degree), **over)

    class TFam(DeepseekFamily):
        @classmethod
        def build_spec(cls, config, tp_degree=None):
            return dataclasses.replace(
                DeepseekFamily.build_spec(config, tp_degree), **over)
    hf = dict(CONFIGS["qlora_mixed"][1], model_type="deepseek_v3")
    japp = JApp(None, JFam.config_cls(JTpuConfig(**STATIC), **hf),
                JFam).init_random_weights(5).init_cache()
    tapp = CausalLMApplication(None, TFam.config_cls(TpuConfig(**STATIC),
                                                     **hf), TFam,
                               device="cpu")
    return japp, _carry(japp, tapp)


@pytest.mark.parametrize("case", ["mla_rolling_cache", "mla_mixed_cache",
                                  "mla_attn_chunk", "moe_pattern",
                                  "paged_app"])
def test_refusals(case):
    """What the port does not run raises ConfigurationError: MLA over the
    rolling or mixed cache (no DeepSeek config takes them) and MLA on the
    paged app, whose block cache holds one head width. The two refusals
    Llama4's knobs lifted now build and match JAX: MLA with chunked
    attention (chunk 8 under a 12-token prompt and 9 decode steps) and an
    interleaved ``moe_pattern`` over the MLA stack (dense, MoE, dense,
    MoE): fp32 logits at LOGIT_TOL and greedy tokens equal to the JAX
    app's on the same weights."""
    if case in LIFTED:
        japp, tapp = _lifted_pair(case)
        for k, v in LIFTED[case].items():
            assert getattr(tapp.spec, k) == v
        if case == "moe_pattern":
            assert [k for k, *_ in model_base.layer_plan(tapp.spec)] == [
                "layers", "moe_layers", "layers", "moe_layers"]
        ids = np.random.default_rng(6).integers(1, 250, size=(2, 12))
        want = japp.generate(ids, max_new_tokens=9, return_logits=True)
        got = tapp.generate(ids, max_new_tokens=9, return_logits=True)
        np.testing.assert_array_equal(got["generated"], want["generated"])
        for j, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {j}",
                                       **LOGIT_TOL)
        return
    why = {"mla_rolling_cache": "latent attention over the rolling",
           "mla_mixed_cache": "latent attention over the rolling or mixed",
           "paged_app": "one head width"}[case]
    with pytest.raises(ConfigurationError, match=why):
        _refusal(case)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
def test_cuda_attention_cores_take_a_narrow_v(dk, dv):
    """On the card the bf16 cores take the ``out_dtype`` product route
    with V narrower than K: ``mha`` and ``mha_hl`` agree with the fp32
    route within bf16 rounding of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    q, k, v, mask = (torch.from_numpy(a).to(dev)
                     for a in _attn_inputs(dk, dv, b=2, t=4, s=300))
    scale = dk ** -0.5
    want = torch.from_numpy(_mha_f64(*(a.cpu().numpy()
                                       for a in (q, k, v, mask)), scale))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = torch.from_numpy(_mha_f64(qb.float().cpu().numpy(),
                                    kb.float().cpu().numpy(),
                                    vb.float().cpu().numpy(),
                                    mask.cpu().numpy(), scale))
    for got in (tattn.mha(qb, kb, vb, mask, scale),
                tattn.mha_hl(qb, kb.permute(0, 2, 3, 1), vb.transpose(1, 2),
                             mask, scale)):
        assert got.shape == (2, 4, 4, dv) and got.dtype == torch.bfloat16
        tol = 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 6)
        assert float((got.float().cpu() - ref).abs().max()) <= tol
    assert float((tattn.mha(q, k, v, mask, scale).cpu() - want).abs()
                 .max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager_mixed_stack():
    """On the card a tiny fp32 DeepSeek app (the mixed stack, q-LoRA,
    grouped routing) gives the same tokens and logits when its T = 1
    decode step replays the graph ``precompile`` captured as when every
    step runs eagerly; the warm-up report lists the decode signatures as
    captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    fam = get_family("deepseek_v3")
    hf = dict(CONFIGS["qlora_mixed"][1], model_type="deepseek_v3")
    apps = [CausalLMApplication(None, fam.config_cls(TpuConfig(**STATIC),
                                                     **hf),
                                fam, device=dev, cuda_graphs=graphs)
            for graphs in (True, False)]
    apps[0].init_random_weights(3)
    apps[1].params = apps[0].params
    for a in apps:
        a.init_cache()
    rep = precompile(apps[0], declare_steady=False)
    decode = [g for g in rep["graphs"] if g["kind"] == "decode"]
    assert decode and all(g["outcome"] == "capture" for g in decode)
    ids = np.random.default_rng(0).integers(1, 250, size=(2, PROMPT_LEN))
    got, want = (a.generate(ids, max_new_tokens=12, return_logits=True)
                 for a in apps)
    assert len(apps[0].graphs) >= 1 and apps[0].graphs.replays
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
