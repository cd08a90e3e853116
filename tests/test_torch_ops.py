"""The port's tensor ops against the JAX package's, on the same numpy
inputs, in fp32 at rtol=atol=1e-5 unless a test states otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import kv_cache as jkv
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.ops import normalization as jnorm
from neuronx_distributed_inference_tpu.ops import rope as jrope
from neuronx_distributed_inference_tpu.ops import sampling as jsamp
from neuronx_distributed_inference_tpu_torch.modules import kv_cache as tkv
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.ops import normalization as tnorm
from neuronx_distributed_inference_tpu_torch.ops import rope as trope
from neuronx_distributed_inference_tpu_torch.ops import sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **(tol or TOL))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(rng, offset):
    x, w = _randn(rng, 3, 5, 64), _randn(rng, 64)
    want = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    got = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                         offset)
    _close(got, want)


def test_rms_norm_bf16_casts_back(rng):
    """bf16 in: fp32 math inside, bf16 out (one rounding at the end)."""
    x, w = _randn(rng, 2, 4, 128), _randn(rng, 128)
    want = jnorm.rms_norm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16), 1e-6)
    got = tnorm.rms_norm(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at |x| < 8 (rounding of identical fp32 values may land
    # on either side only through fp32 sum order)
    _close(got.float(), np.asarray(want, np.float32), rtol=0, atol=6.25e-2)


ROPE_CASES = {
    "default": dict(head_dim=64, rope_theta=10000.0),
    "linear": dict(head_dim=64, rope_theta=10000.0, scaling_type="linear",
                   scaling_factor=4.0),
    "llama3": dict(head_dim=64, rope_theta=500000.0, scaling_type="llama3",
                   scaling_factor=32.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position=8192),
    "llama3_partial": dict(head_dim=128, rotary_dim=64, rope_theta=500000.0,
                           scaling_type="llama3", scaling_factor=8.0,
                           original_max_position=8192),
}


@pytest.mark.parametrize("theta,dim", [(10000.0, 128), (150000.0, 64),
                                       (500000.0, 64), (1000000.0, 128),
                                       (50000.0, 128)])
def test_rope_inv_freq_bit_exact(theta, dim):
    """The inverse frequencies equal JAX's bit for bit (an ulp off moves
    cos/sin by ~1e-3 at position 1e5): torch's fp32 ``pow`` is an ulp off
    XLA's for some thetas (150000 at dim 64, 1e6 at dim 128), so the port
    takes the power in fp64 and rounds once."""
    jcfg = jrope.RopeConfig(head_dim=dim, rope_theta=theta)
    tcfg = trope.RopeConfig(head_dim=dim, rope_theta=theta)
    np.testing.assert_array_equal(trope.compute_inv_freq(tcfg).numpy(),
                                  np.asarray(jrope.compute_inv_freq(jcfg)))


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_inv_freq_cos_sin_apply(rng, case):
    kw = ROPE_CASES[case]
    jcfg, tcfg = jrope.RopeConfig(**kw), trope.RopeConfig(**kw)
    _close(trope.compute_inv_freq(tcfg), jrope.compute_inv_freq(jcfg),
           rtol=1e-6, atol=0)
    pos = rng.integers(0, 131072, size=(2, 7)).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jcfg)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), tcfg)
    # angles up to ~1.3e5 rad: fp32 sin/cos of equal fp32 angles agree to
    # ~1e-5 absolute across libm implementations
    _close(tc, jc, rtol=0, atol=2e-5)
    _close(ts, js, rtol=0, atol=2e-5)
    x = _randn(rng, 2, 7, 3, kw["head_dim"])
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.array(jc)), torch.from_numpy(np.array(js)))
    _close(got, want)


def test_repeat_kv(rng):
    x = _randn(rng, 2, 5, 2, 16)
    _close(tattn.repeat_kv(torch.from_numpy(x), 3),
           jattn.repeat_kv(jnp.asarray(x), 3), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["decode", "causal", "window_sink_cap"])
def test_mha_masks(rng, kind):
    b, hq, hkv, d = 2, 8, 2, 64
    if kind == "decode":
        t, s = 1, 96
        pos = np.array([[17], [95]], np.int32)
        jm = jattn.decode_mask(jnp.asarray(pos), s)
        tm = tattn.decode_mask(torch.from_numpy(pos), s)
        extra = {}
    elif kind == "causal":
        t = s = 24
        pos = np.stack([np.arange(t), np.arange(t) + 5]).astype(np.int32)
        jm = jattn.prefill_causal_mask(t, jnp.asarray(pos))
        tm = tattn.prefill_causal_mask(torch.from_numpy(pos))
        extra = {}
    else:
        t, s = 3, 80
        pos = np.array([[40, 41, 42], [70, 71, 72]], np.int32)
        jm = jattn.decode_mask(jnp.asarray(pos), s, window=16)
        tm = tattn.decode_mask(torch.from_numpy(pos), s, window=16)
        extra = dict(logits_soft_cap=5.0, sink=_randn(rng, hq))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    q, k, v = _randn(rng, b, t, hq, d), _randn(rng, b, s, hkv, d), \
        _randn(rng, b, s, hkv, d)
    jx = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
          for k_, v_ in extra.items()}
    tx = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
          for k_, v_ in extra.items()}
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                     d ** -0.5, **jx)
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), tm, d ** -0.5, **tx)
    _close(got, want)


def test_truncated_probs(rng):
    logits = _randn(rng, 4, 1000) * 3
    sp = np.array([[1, 1.0, 1.0], [8, 0.9, 0.7], [0, 0.5, 1.3],
                   [300, 0.95, 2.0]], np.float32)
    jp, ji = jsamp.truncated_probs(jnp.asarray(logits), jnp.asarray(sp), 256)
    tp, ti = tsamp.truncated_probs(torch.from_numpy(logits),
                                   torch.from_numpy(sp), 256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp)
    # deterministic sampling is the argmax of the truncated distribution
    got = tsamp.topk_topp_sample(torch.from_numpy(logits),
                                 torch.from_numpy(sp), None, 256,
                                 deterministic=True)
    want = jsamp.topk_topp_sample(jnp.asarray(logits), jnp.asarray(sp),
                                  None, 256, deterministic=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_topp_sample_stays_in_support(rng):
    """Random draws use a torch.Generator (not threefry bits): check they
    land only on tokens the shared truncation keeps."""
    logits = _randn(rng, 3, 500) * 4
    sp = np.array([[4, 1.0, 1.0], [50, 0.5, 0.8], [0, 0.9, 1.5]],
                  np.float32)
    jp, ji = jsamp.truncated_probs(jnp.asarray(logits), jnp.asarray(sp), 256)
    support = [set(np.asarray(ji)[r][np.asarray(jp)[r] > 0].tolist())
               for r in range(3)]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        toks = tsamp.topk_topp_sample(torch.from_numpy(logits),
                                      torch.from_numpy(sp), gen)
        for r in range(3):
            assert int(toks[r]) in support[r]


def test_greedy_and_padded_vocab(rng):
    logits = _randn(rng, 5, 384)
    logits[1, 10] = logits[1, 20] = 50.0        # tie -> first index
    logits[2, 380] = 99.0                       # lands in the padding
    jl = jsamp.mask_padded_logits(jnp.asarray(logits), 128)
    tl = tsamp.mask_padded_logits(torch.from_numpy(logits), 128)
    _close(tl, jl, rtol=0, atol=0)
    want = jsamp.greedy_sample(jl)
    got = tsamp.greedy_sample(tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got[1]) == 10
    np.testing.assert_array_equal(
        tsamp.sample(tl.reshape(5, 1, 384), None).numpy(),
        np.asarray(jsamp.sample(jl.reshape(5, 1, 384), None)))
    np.testing.assert_array_equal(
        tsamp.prepare_sampling_params(3, [1, 2, 3], 0.9, 0.7),
        jsamp.prepare_sampling_params(3, [1, 2, 3], 0.9, 0.7))


@pytest.mark.parametrize("dtype,scale", [("float8_e4m3fn", None),
                                         ("float8_e4m3fn", 0.25),
                                         ("bfloat16", 2.0)])
def test_quantize_dequantize_kv(rng, dtype, scale):
    """Same scale placement and the same rounding on the cast: the stored
    values are bit-identical."""
    x = _randn(rng, 3, 4, 64) * 3
    jq = jkv.quantize_kv(jnp.asarray(x), jnp.dtype(dtype), scale)
    tq = tkv.quantize_kv(torch.from_numpy(x), getattr(torch, dtype), scale)
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    jd = jkv.dequantize_kv(jq, jnp.float32, scale)
    td = tkv.dequantize_kv(tq, torch.float32, scale)
    _close(td, jd, rtol=0, atol=0)
