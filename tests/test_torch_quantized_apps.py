"""Quantized tiny Llamas of the port against the JAX package's, end to end:
the contiguous app and the ragged engine with each weight scheme, the
scaled fp8 KV cache, and quantized checkpoints saved by one package and
loaded by the other.

Geometry: the tiny Llama of tests/test_torch_ragged.py (hidden 64, 2
layers, 4 q / 2 kv heads of 16, intermediate 128, vocab 512), fp32. One
fp weight tree is drawn from a numpy seed; the JAX app quantizes it in its
``_put_params``, and the port gets it twice: carried over from the JAX
app's quantized tree (``params_from_numpy``) and quantized by itself from
the same fp weights. Both port trees are equal bit for bit; greedy
streams are identical across the three; fp32 logits agree at atol 2e-3,
rtol 1e-3 (the suite's tolerance)."""

import copy

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_quantization import LEAF_FAMILIES
from test_torch_ragged import HF, P_A, P_B, P_LONG, TCFG
from test_torch_serving_engine import _serve

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
SCHEMES = {
    "int8_channel": dict(quantization_dtype="int8",
                         quantization_type="per_channel_symmetric"),
    "int8_tensor": dict(quantization_dtype="int8",
                        quantization_type="per_tensor_symmetric"),
    "int8_blockwise": dict(quantization_dtype="int8",
                           quantization_type="blockwise_symmetric"),
    "fp8_channel": dict(quantization_dtype="fp8",
                        quantization_type="per_channel_symmetric"),
    "fp8_blockwise": dict(quantization_dtype="fp8",
                          quantization_type="blockwise_symmetric"),
    "mxfp4": dict(quantization_dtype="mxfp4"),
}
CONTIG = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True,
              context_encoding_buckets=[16, 32])
FP8_KV = dict(kv_cache_dtype="float8_e4m3fn", kv_cache_quant=True,
              kv_cache_scale=2.0)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _host_weights(seed=7, hf=HF):
    """A fp32 numpy tree in the layout of both packages (fused qkv,
    stacked layers): matrices N(0, 0.08), norms 1 + N(0, 0.1)."""
    tapp = CausalLMApplication(None, get_family(hf["model_type"]).config_cls(
        TpuConfig(batch_size=1, seq_len=16), **hf), device="cpu")
    rng = np.random.default_rng(seed)

    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(node[k], k) for k in sorted(node)}
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        return (0.08 * rng.standard_normal(node.shape)).astype(np.float32)
    return fill(model_base.decoder_param_specs(tapp.spec), "")


HOST = _host_weights()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k].view(torch.uint8) if la[k].dtype ==
                           torch.float8_e4m3fn else la[k],
                           lb[k].view(torch.uint8) if lb[k].dtype ==
                           torch.float8_e4m3fn else lb[k]), k


def _apps(jcls, tcls, **kw):
    """(JAX app, port app carrying its tree, port app quantizing HOST)."""
    japp = jcls(None, JLlamaConfig(JTpuConfig(**kw), **HF), JLlamaFamily)
    japp._put_params(copy.deepcopy(HOST))
    japp.init_cache()
    carried = tcls(None, LlamaInferenceConfig(TpuConfig(**kw), **HF),
                   LlamaFamily, device="cpu")
    carried.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                       device="cpu")
    carried.init_cache()
    own = tcls(None, LlamaInferenceConfig(TpuConfig(**kw), **HF),
               LlamaFamily, device="cpu")
    own._put_params(copy.deepcopy(HOST))
    own.init_cache()
    _assert_trees_equal(own.params, carried.params)
    return japp, carried, own


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 500, size=n)
        mask[i, :n] = 1
    return ids, mask


def _check_generate(japp, apps, new=5):
    ids, mask = _prompts([11, 16])
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=new,
                         return_logits=True)
    for app in apps:
        got = app.generate(ids, attention_mask=mask, max_new_tokens=new,
                           return_logits=True)
        np.testing.assert_array_equal(got["generated"], want["generated"])
        for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_contiguous_app_quantized_matches_jax(scheme):
    """The contiguous app with quantized weights: the port's own tree
    equals the JAX app's bit for bit, and both port apps' greedy tokens
    and per-step logits equal the JAX app's."""
    japp, carried, own = _apps(JApp, CausalLMApplication, quantized=True,
                               **CONTIG, **SCHEMES[scheme])
    q = own.params["layers"]["o_proj"]
    assert set(q) == {"qweight", "scale"}
    assert not isinstance(own.params["layers"]["qkv_proj"], dict)
    _check_generate(japp, (carried, own))


SUBS = [(P_A, 5, "default"), (P_B, 4, "default"), (P_LONG, 4, "default")]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_ragged_engine_quantized_matches_jax(scheme):
    """Three requests through the ragged engine over a batch of two (the
    third waits; one prompt takes two prefill chunks) with quantized
    weights: both port apps' streams and finish reasons equal the JAX
    engine's."""
    japp, carried, own = _apps(JPagedApp, PagedCausalLMApplication,
                               quantized=True, **TCFG, **SCHEMES[scheme])
    want, reasons, *_ = _serve(japp, "jax", True, SUBS)
    for app in (carried, own):
        got, got_reasons, *_ = _serve(app, "port", True, SUBS)
        assert got == want and got_reasons == reasons


@pytest.mark.parametrize("weights", ["plain", "int8_channel"])
def test_scaled_fp8_kv_cache_matches_jax(weights):
    """The scaled fp8 KV cache (``kv_cache_quant``, values stored as x /
    2.0 in e4m3) end to end (the reference's ``test_e2e_fp8_kv_scaled``):
    the contiguous app's tokens and logits and the ragged engine's
    streams equal the JAX apps', with plain and with int8 weights."""
    over = dict(FP8_KV, **(dict(quantized=True, **SCHEMES[weights])
                           if weights != "plain" else {}))
    japp, carried, own = _apps(JApp, CausalLMApplication, **CONTIG, **over)
    assert own.spec.kv_scale == 2.0
    assert own.cache["k"].dtype == torch.float8_e4m3fn
    _check_generate(japp, (carried, own))
    japp, _, own = _apps(JPagedApp, PagedCausalLMApplication, **TCFG,
                         **over)
    want, reasons, *_ = _serve(japp, "jax", True, SUBS)
    got, got_reasons, *_ = _serve(own, "port", True, SUBS)
    assert got == want and got_reasons == reasons


@pytest.mark.parametrize("scheme", ["fp8_channel", "int8_blockwise",
                                    "mxfp4"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_quantized_checkpoint_loads_both_ways(tmp_path, direction, scheme):
    """``save_quantized_state_dict`` of one package loads in the other's
    ``load_quantized_state_dict`` (the reference's flat names; fp8 codes
    stay fp8), and the loaded app's logits and tokens equal the saver's."""
    kw = dict(quantized=True, **CONTIG, **SCHEMES[scheme])
    japp, _, own = _apps(JApp, CausalLMApplication, **kw)
    path = str(tmp_path / "q")
    if direction == "jax_to_port":
        japp.save_quantized_state_dict(path)
        loaded = CausalLMApplication(
            None, LlamaInferenceConfig(TpuConfig(**kw), **HF), LlamaFamily,
            device="cpu").load_quantized_state_dict(path).init_cache()
        _assert_trees_equal(loaded.params, own.params)
        _check_generate(japp, (loaded,))
    else:
        own.save_quantized_state_dict(path)
        loaded = JApp(None, JLlamaConfig(JTpuConfig(**kw), **HF),
                      JLlamaFamily).load_quantized_state_dict(path)
        loaded.init_cache()
        _check_generate(loaded, (own,))


@pytest.mark.parametrize("tree", ["int8_channel", "fp8_blockwise", "mxfp4",
                                  "low_rank_int8"])
def test_params_from_numpy_carries_quantized_trees(tree):
    """``params_from_numpy`` carries the JAX app's quantized and low-rank
    trees over unchanged: every leaf (int8 / uint8 / fp8 codes, fp32
    scales, ``lr_u`` / ``lr_v`` factors) keeps its nesting, shape, dtype
    and bytes."""
    over = (dict(quantized=True, **SCHEMES[tree]) if tree in SCHEMES
            else dict(mlp_low_rank=16, quantized=True,
                      quantization_dtype="int8"))
    japp = JApp(None, JLlamaConfig(JTpuConfig(**CONTIG, **over), **HF),
                JLlamaFamily)
    japp._put_params(copy.deepcopy(HOST))
    host = jax.tree.map(np.asarray, japp.params)
    got = _leaves(params_from_numpy(host, device="cpu"))
    want = _leaves(host)
    assert got.keys() == want.keys()
    for k, v in want.items():
        t = got[k]
        assert str(t.dtype).replace("torch.", "") == v.dtype.name, k
        assert tuple(t.shape) == v.shape, k
        raw = t.view(torch.uint8) if t.element_size() == 1 else t
        np.testing.assert_array_equal(
            raw.numpy(), v.view(np.uint8) if v.dtype.itemsize == 1 else v)
    names = set(want)
    assert ("layers.gate_proj.lr_u.qweight" in names) == (
        tree == "low_rank_int8")


MOE_APPS = {"qwen3_moe": "int8_channel", "gpt_oss": "mxfp4",
            "deepseek_v3": "fp8_blockwise"}


@pytest.mark.parametrize("family", sorted(MOE_APPS))
def test_moe_family_app_quantized_matches_jax(family):
    """Quantized MoE families on the contiguous app (Qwen3-MoE int8,
    gpt-oss MXFP4 with sinks, biases and the mixed cache, DeepSeek-V3 fp8
    blockwise with MLA's quantized ``q_proj`` and shared experts): the
    port's own tree equals the JAX app's bit for bit, and both port apps'
    tokens and logits equal the JAX app's."""
    hf = dict(LEAF_FAMILIES[family], vocab_size=512)
    kw = dict(quantized=True, **CONTIG, **SCHEMES[MOE_APPS[family]])
    host = _host_weights(11, hf)
    jfam = j_get_family(family)
    japp = JApp(None, jfam.config_cls(JTpuConfig(**kw), **hf), jfam)
    japp._put_params(copy.deepcopy(host))
    japp.init_cache()
    tfam = get_family(family)
    apps = []
    for carried in (True, False):
        app = CausalLMApplication(None, tfam.config_cls(TpuConfig(**kw),
                                                        **hf), tfam,
                                  device="cpu")
        if carried:
            app.params = params_from_numpy(
                jax.tree.map(np.asarray, japp.params), device="cpu")
        else:
            app._put_params(copy.deepcopy(host))
        apps.append(app.init_cache())
    _assert_trees_equal(apps[1].params, apps[0].params)
    _check_generate(japp, apps)
