"""The port's low-rank (SVD) MLP (``modules/low_rank.py``) against the JAX
package's: factorization, factor quantization, the compression report,
the config check, and tiny Llama apps with factorized MLPs.

Singular vectors may differ in sign between ``torch.linalg.svd`` and
numpy's, so products U·V and logits are compared, never the factors.
Weights come from a numpy seed (tests/test_torch_quantized_apps.py's
tree); fp32 throughout, at the suite's tolerance (atol 2e-3, rtol
1e-3)."""

import copy

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.modules import low_rank as jlr
from neuronx_distributed_inference_tpu.modules import quantization as jq
from neuronx_distributed_inference_tpu.resilience import \
    ConfigurationError as JConfigurationError
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.modules import low_rank as tlr
from neuronx_distributed_inference_tpu_torch.modules import quantization as tq
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_quantized_apps import CONTIG, HOST, SUBS, _check_generate
from test_torch_ragged import HF, TCFG
from test_torch_serving_engine import _serve

TOL = dict(atol=2e-3, rtol=1e-3)
FULL_RANK = 64          # min(hidden 64, intermediate 128)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _dense(factor):
    if isinstance(factor, dict):
        return tq.dequantize(factor, torch.float32)
    return factor.float()


def _layer(factor, layer):
    if isinstance(factor, dict):
        return {k: v[layer] for k, v in factor.items()}
    return factor[layer]


def _jdense(factor):
    if isinstance(factor, dict):
        return np.asarray(jq.dequantize(
            jax.tree.map(np.asarray, factor), np.float32))
    return np.asarray(factor, np.float32)


@pytest.mark.parametrize("rank", [8, 48])
def test_factorize_tensor_matches_reference(rank):
    """A stacked (L, K, N) weight: the port's U·V equals the reference's
    at every layer, the reconstruction errors agree, and a full-rank pair
    reconstructs the weight."""
    w = np.random.default_rng(0).standard_normal((2, 64, 48)).astype(
        np.float32)
    want = jlr.factorize_tensor(w, rank)
    got = tlr.factorize_tensor(torch.from_numpy(w), rank)
    assert got["lr_u"].shape == want["lr_u"].shape
    assert got["lr_v"].shape == want["lr_v"].shape
    np.testing.assert_allclose((got["lr_u"] @ got["lr_v"]).numpy(),
                               want["lr_u"] @ want["lr_v"], atol=1e-4,
                               rtol=1e-4)
    err = tlr.reconstruction_error(torch.from_numpy(w), got)
    assert err == pytest.approx(jlr.reconstruction_error(w, want), abs=1e-5)
    full = tlr.factorize_tensor(torch.from_numpy(w), 64)
    assert tlr.reconstruction_error(torch.from_numpy(w), full) < 1e-5


QUANT_FACTORS = {
    "none": None,
    "int8_channel": ("int8", jq.PER_CHANNEL),
    "int8_blockwise": ("int8", jq.BLOCKWISE),   # rank 16 -> per-channel
    "mxfp4": ("mxfp4", jq.PER_CHANNEL),         # lr_v (K = 16) kept fp
}


def _table(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_table(v, prefix + k + "."))
        else:
            out[prefix + k] = (tuple(v.shape),
                               str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("quant", sorted(QUANT_FACTORS))
def test_factorize_params_matches_reference(quant):
    """Only gate / up / down are factorized; their factors are quantized
    as the reference quantizes them (blockwise falls back to per-channel
    and mxfp4 keeps a factor whose contraction axis is the rank when the
    rank does not divide into groups), with the same leaves, shapes and
    dtypes; the dense products of the factors agree."""
    qs = QUANT_FACTORS[quant]
    jspec = None if qs is None else jq.QuantSpec(*qs)
    tspec = None if qs is None else tq.QuantSpec(*qs)
    host = copy.deepcopy(HOST)
    want = jlr.factorize_params(host["layers"], jlr.LowRankSpec(16),
                                quant=jspec)
    got = tlr.factorize_params(
        {k: torch.from_numpy(v) for k, v in host["layers"].items()},
        tlr.LowRankSpec(16), quant=tspec)
    assert _table(got) == {k: (s, np.dtype(d).name if d != "float8_e4m3fn"
                               else d)
                           for k, (s, d) in _table(jax.tree.map(
                               np.asarray, want)).items()}
    # a factor quantized from another SVD's (sign-flipped, rounded)
    # vectors may hold a code one step away
    tol = TOL if qs is None else dict(atol=0.02, rtol=0.0)
    for name in ("gate_proj", "up_proj", "down_proj"):
        for layer in range(2):
            a = (_dense(_layer(got[name]["lr_u"], layer))
                 @ _dense(_layer(got[name]["lr_v"], layer)))
            b = (_jdense(_layer(want[name]["lr_u"], layer))
                 @ _jdense(_layer(want[name]["lr_v"], layer)))
            np.testing.assert_allclose(a.numpy(), b, **tol)


@pytest.mark.parametrize("glu", [True, False])
def test_compression_report_matches_reference(glu):
    for args in ((64, 128, 2, 16), (4096, 14336, 32, 512)):
        assert tlr.compression_report(*args, glu=glu) == \
            jlr.compression_report(*args, glu=glu)


@pytest.mark.parametrize("rank", [0, -4])
def test_config_rejects_rank_below_one(rank):
    """``mlp_low_rank`` < 1 is a ConfigurationError in both packages;
    None disables the low-rank MLP."""
    with pytest.raises(JConfigurationError, match="mlp_low_rank"):
        JTpuConfig(batch_size=1, seq_len=64, mlp_low_rank=rank)
    with pytest.raises(ConfigurationError, match="mlp_low_rank"):
        TpuConfig(batch_size=1, seq_len=64, mlp_low_rank=rank)
    assert tlr.low_rank_spec_from_config(
        TpuConfig(batch_size=1, seq_len=64)) is None
    assert tlr.low_rank_spec_from_config(TpuConfig(
        batch_size=1, seq_len=64, mlp_low_rank=16)) == tlr.LowRankSpec(16)


def _port_app(cls, **kw):
    app = cls(None, LlamaInferenceConfig(TpuConfig(**kw), **HF),
              LlamaFamily, device="cpu")
    app._put_params(copy.deepcopy(HOST))
    return app.init_cache()


def _jax_app(cls, **kw):
    app = cls(None, JLlamaConfig(JTpuConfig(**kw), **HF), JLlamaFamily)
    app._put_params(copy.deepcopy(HOST))
    return app.init_cache()


@pytest.mark.parametrize("app", ["contiguous", "ragged"])
def test_full_rank_equals_dense(app):
    """At full rank (``mlp_low_rank`` = min(H, I)) the factorized port app
    emits the dense JAX app's tokens and logits (contiguous) or streams
    (ragged engine)."""
    if app == "contiguous":
        dense = _jax_app(JApp, **CONTIG)
        full = _port_app(CausalLMApplication, mlp_low_rank=FULL_RANK,
                         **CONTIG)
        assert set(full.params["layers"]["gate_proj"]) == {"lr_u", "lr_v"}
        _check_generate(dense, (full,))
        return
    dense = _jax_app(JPagedApp, **TCFG)
    full = _port_app(PagedCausalLMApplication, mlp_low_rank=FULL_RANK,
                     **TCFG)
    want, reasons, *_ = _serve(dense, "jax", True, SUBS)
    got, got_reasons, *_ = _serve(full, "port", True, SUBS)
    assert got == want and got_reasons == reasons


@pytest.mark.parametrize("factors", ["plain", "int8_channel"])
def test_truncated_rank_matches_reference(factors):
    """Rank 16 (a quarter of the hidden width), with plain or int8
    factors: the port app on the JAX app's factor tree equals its tokens
    and logits; the port app factorizing the same fp weights itself (its
    own SVD) agrees in logits at the suite's tolerance for plain factors,
    and within 1e-2 for int8 factors (a factor code may round to the
    neighbouring step from the other SVD's vectors)."""
    over = dict(mlp_low_rank=16, **CONTIG)
    if factors != "plain":
        over.update(quantized=True, quantization_dtype="int8")
    japp = _jax_app(JApp, **over)
    carried = CausalLMApplication(
        None, LlamaInferenceConfig(TpuConfig(**over), **HF), LlamaFamily,
        device="cpu")
    carried.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                       device="cpu")
    carried.init_cache()
    _check_generate(japp, (carried,))
    own = _port_app(CausalLMApplication, **over)
    ids = np.random.default_rng(3).integers(1, 500, size=(2, 12))
    want = japp.generate(ids, max_new_tokens=3, return_logits=True)
    got = own.generate(ids, max_new_tokens=3, return_logits=True)
    tol = TOL if factors == "plain" else dict(atol=1e-2, rtol=0.0)
    np.testing.assert_allclose(got["logits"][0], np.asarray(
        want["logits"][0]), **tol)
