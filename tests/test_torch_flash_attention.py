"""The causal flash prefill attention of the port against the JAX package's
Pallas kernel ``flash_attention`` (run in interpret mode, as
tests/test_flash_attention.py runs it), over that test's case matrix:
causal GQA (4,4) and (8,2) at S=256, a window of 100, a soft-cap of 30,
S=512, head_dim 64 and 128, and the ``supports()`` gate.

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
