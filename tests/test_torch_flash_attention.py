"""The causal flash prefill attention of the port against the JAX package's
Pallas kernel ``flash_attention`` (run in interpret mode, as
tests/test_flash_attention.py runs it), over that test's case matrix:
causal GQA (4,4) and (8,2) at S=256, a window of 100, a soft-cap of 30,
S=512, head_dim 64 and 128, the ``supports()`` gate and the kernels'
shape gate.

On the CPU the port's wrapper runs its plain twin
(``flash_attention_plain``); fp32 at rtol=atol=2e-5, the JAX kernel
tests' own tolerance. The CUDA kernel itself is compared with the twin by
the ``cuda``-marked test below, which runs only on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.ops import flash_attention as jfa
from neuronx_distributed_inference_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)

CASES = {
    "causal_4_4": dict(hq=4, hkv=4),
    "causal_8_2": dict(hq=8, hkv=2),
    "causal_8_2_d128": dict(hq=8, hkv=2, d=128),
    "causal_8_1_d128": dict(b=1, hq=8, hkv=1, d=128),
    "window100": dict(b=1, hq=4, hkv=2, window=100),
    "soft_cap30": dict(b=1, s=128, hq=4, hkv=4, soft_cap=30.0),
    "s512": dict(b=1, s=512, hq=2, hkv=2),
    "s512_window100_d128": dict(b=1, s=512, hq=4, hkv=1, d=128,
                                window=100),
}


def _build(name):
    spec = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b, s, d = spec.get("b", 2), spec.get("s", 256), spec.get("d", 64)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    qkv = (f(b, s, spec["hq"], d), f(b, s, spec["hkv"], d),
           f(b, s, spec["hkv"], d))
    kw = dict(scale=d ** -0.5, window=spec.get("window", 0),
              soft_cap=spec.get("soft_cap"))
    return qkv, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_matches_pallas_kernel(name):
    (q, k, v), kw = _build(name)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        **kw))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_supports_gate():
    """tests/test_flash_attention.py:72-77, plus the head dims the kernel
    takes (64 and 128; the JAX gate admits every multiple of 64)."""
    assert tfa.supports(512, 64, has_sink=False, chunk=0)
    assert tfa.supports(512, 128, has_sink=False, chunk=0)
    assert not tfa.supports(100, 64, False, 0)     # not block-divisible
    assert not tfa.supports(512, 80, False, 0)     # head_dim not 64-multiple
    assert not tfa.supports(512, 64, True, 0)      # sink unsupported
    assert not tfa.supports(512, 64, False, 128)   # chunked unsupported
    assert not tfa.supports(512, 192, False, 0)    # the kernel's D limit
    assert jfa.supports(512, 192, False, 0)


@pytest.mark.parametrize("dtype,s,d,ok", [
    (torch.bfloat16, 256, 128, True),
    (torch.bfloat16, 128, 64, True),
    (torch.bfloat16, 192, 128, False),   # bf16 tiles are 128 queries
    (torch.float32, 192, 128, True),     # fp32 tiles are 64
    (torch.float32, 96, 64, False),
    (torch.bfloat16, 256, 96, False),    # head_dim 64 or 128 only
])
def test_kernel_shape_gate(dtype, s, d, ok):
    """The checks the wrapper makes before a launch (CPU tensors here: the
    gate reads shapes, strides and alignment only)."""
    q = torch.zeros((1, s, 4, d), dtype=dtype)
    k = torch.zeros((1, s, 2, d), dtype=dtype)
    if ok:
        tfa.check_kernel_shapes(q, k, k)
    else:
        with pytest.raises(ValueError, match="multiple of|head_dim"):
            tfa.check_kernel_shapes(q, k, k)


def test_kernel_gate_refuses_misaligned_views():
    """The fused projection's views pass (every stride a multiple of 16
    bytes); a row that starts off a 16-byte boundary does not."""
    qkv = torch.zeros((1, 256, 8 * 64 + 2 * 2 * 64), dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [8 * 64, 2 * 64, 2 * 64], dim=-1)
    q, k, v = (t.reshape(1, 256, -1, 64) for t in (q, k, v))
    tfa.check_kernel_shapes(q, k, v)
    flat = torch.zeros(1 * 256 * 2 * 64 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].reshape(1, 256, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_kernel_shapes(q, shifted, v)


def test_wrapper_takes_strided_views():
    """The model hands k/v as views into the fused projection: the twin
    (and the kernel, through strides) read them without a copy."""
    (q, k, v), kw = _build("causal_8_2")
    qkv = torch.from_numpy(np.concatenate(
        [q.reshape(*q.shape[:2], -1), k.reshape(*k.shape[:2], -1),
         v.reshape(*v.shape[:2], -1)], axis=-1))
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    qv, kv_, vv = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    got = tfa.flash_attention(qv.reshape(q.shape), kv_.reshape(k.shape),
                              vv.reshape(v.shape), **kw)
    want = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(torch.from_numpy(q),
                            torch.from_numpy(k).double(),
                            torch.from_numpy(v), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_twin(name):
    """On the card: the hand-written kernel against the twin on the same
    inputs (fp32 sums in another order: 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (q, k, v), kw = _build(name)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*(torch.from_numpy(x).cuda()
                                for x in (q, k, v)), **kw)
    torch.cuda.synchronize()
    want = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert tfa.flash_attention.launches == before + 1


CUDA_BF16_CASES = {
    "s128_one_tile": dict(b=1, s=128, hq=4, hkv=2, d=128),
    "window200": dict(b=2, s=512, hq=4, hkv=1, d=128, window=200),
    "soft_cap30_window200": dict(b=1, s=512, hq=4, hkv=4, d=128,
                                 window=200, soft_cap=30.0),
    "d64": dict(b=2, s=256, hq=8, hkv=2, d=64),
    # Qwen3-30B-A3B heads (32 q over 4 kv: GQA group 8) at the 2048 bucket
    "qwen3_g8_s2048": dict(b=4, s=2048, hq=32, hkv=4, d=128),
    "qwen3_g8_window200": dict(b=1, s=512, hq=32, hkv=4, d=128,
                               window=200),
    # GLM-4.5-Air's heads (96 q over 8 kv: G 12) and granite-3.0-3b-a800m's
    # (24 q over 8 kv of 64: G 3, attention multiplier 1/64 as the scale)
    "glm_air_g12_s512": dict(b=2, s=512, hq=96, hkv=8, d=128),
    "granite_g3_d64_s512": dict(b=2, s=512, hq=24, hkv=8, d=64,
                                scale=0.015625),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_BF16_CASES))
def test_cuda_bf16_kernel_matches_plain_twin(name):
    """On the card: the tensor-core kernel against the twin on the same bf16
    inputs. Both keep scores, probabilities (the kernel to ~16 bits, as
    bf16 hi + lo) and sums in fp32 and round the output once, so they
    differ by at most one bf16 ulp of max |v| (|o| <= max |v|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    spec = CUDA_BF16_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b, s, d = spec["b"], spec["s"], spec["d"]
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).bfloat16().cuda()
        for h in (spec["hq"], spec["hkv"], spec["hkv"]))
    kw = dict(scale=spec.get("scale", d ** -0.5),
              window=spec.get("window", 0), soft_cap=spec.get("soft_cap"))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v, **kw)
    tol = 2.0 ** (np.floor(np.log2(v.float().abs().max().item())) - 7)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    assert tfa.flash_attention.launches == before + 1


@pytest.mark.cuda
def test_cuda_fp32_kernel_still_runs():
    """fp32 inputs take the CUDA-core kernel (fp32 products, not TF32): the
    twin's result to 1e-4 at S = 192, a length the bf16 kernel refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 192, h, 64)).astype(np.float32)).cuda() for h in (4, 2, 2))
    got = tfa.flash_attention(q, k, v, scale=0.125, window=50)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v, scale=0.125, window=50)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
