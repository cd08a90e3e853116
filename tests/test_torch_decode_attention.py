"""The contiguous-cache decode attention of the port against the JAX
package's Pallas kernel ``decode_attention_stacked`` (run in interpret
mode, as tests/test_decode_attention.py runs it), over that test's case
matrix: GQA groupings, a zero-length row, sliding windows, a sink, a
soft-cap, stacked layers with a per-layer window, bf16 I/O, an fp8 cache
with ``kv_scale``, and head_dim 64 and 128.

On the CPU the port's wrapper runs its plain twin
(``decode_attention_stacked_plain``); fp32 at rtol=atol=2e-5, the JAX
kernel tests' own tolerance; bf16 I/O at that test's 0.05 (both round the
output to bf16 once, and bf16 inputs stay exact in fp32). The CUDA kernel
itself is compared with the twin by the ``cuda``-marked test below, which
runs only on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import kv_cache as jkv
from neuronx_distributed_inference_tpu.ops import decode_attention as jda
from neuronx_distributed_inference_tpu_torch.ops import decode_attention as tda
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    tensor_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=0.05, atol=0.05)
ARGS = ("q", "k_cache", "v_cache", "new_k", "new_v")

CASES = {
    "gqa_4_4": dict(hq=4, hkv=4),
    "gqa_8_2": dict(hq=8, hkv=2),
    "gqa_4_1": dict(hq=4, hkv=1),
    "gqa_8_2_d128": dict(hq=8, hkv=2, d=128),
    "zero_len_row": dict(s=128, lens=(0, 64)),
    "window32": dict(lens=(200, 255), window=32),
    "window100": dict(lens=(200, 255), window=100),
    "sink": dict(s=128, lens=(60, 100), sink=True),
    "soft_cap30": dict(lens=(7, 130, 31), soft_cap=30.0),
    "stacked_L3_window": dict(lens=(40, 100, 250), layers=3,
                              layer_windows=(0, 48, 0)),
    "bf16_io": dict(s=128, hq=8, hkv=2, lens=(64, 100), dtype="bfloat16"),
    "fp8_e4m3_kv_scale": dict(lens=(100, 255), cache="float8_e4m3fn",
                              kv_scale=0.25),
    "fp8_e4m3_direct": dict(lens=(100, 255), cache="float8_e4m3fn"),
    "bf16_cache_kv_scale": dict(lens=(100, 255), cache="bfloat16",
                                kv_scale=2.0),
}


def _build(name):
    """Numpy inputs from a seed, cast like the model's write path."""
    spec = dict(CASES[name])
    rng = np.random.default_rng(sum(map(ord, name)))
    s, hq, hkv = spec.get("s", 256), spec.get("hq", 4), spec.get("hkv", 2)
    d, lens = spec.get("d", 64), spec.get("lens", (5, 130, 255))
    layers, b = spec.get("layers", 1), len(lens)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    inp = dict(q=f(b, hq, d), k_cache=f(layers, b, hkv, d, s),
               v_cache=f(layers, b, hkv, s, d), new_k=f(b, hkv, d),
               new_v=f(b, hkv, d), lens=np.asarray(lens, np.int32))
    if spec.get("dtype") == "bfloat16":
        inp = {k: (v.astype(jnp.bfloat16) if v.dtype == np.float32 else v)
               for k, v in inp.items()}
    if "cache" in spec:
        for k in ("k_cache", "v_cache"):
            inp[k] = np.asarray(jkv.quantize_kv(
                jnp.asarray(inp[k]), jnp.dtype(spec["cache"]),
                spec.get("kv_scale")))
    kw = dict(scale=d ** -0.5)
    for key in ("soft_cap", "kv_scale"):
        if key in spec:
            kw[key] = spec[key]
    if spec.get("sink"):
        kw["sink"] = f(hq)
    windows = spec.get("layer_windows", (spec.get("window", 0),) * layers)
    return inp, kw, windows


def _jax(inp, layer, window, **kw):
    if "sink" in kw:
        kw["sink"] = jnp.asarray(kw["sink"])
    out = jda.decode_attention_stacked(
        *(jnp.asarray(inp[k]) for k in ARGS), jnp.asarray(layer, jnp.int32),
        jnp.asarray(inp["lens"]), window=jnp.asarray(window, jnp.int32),
        block_s=64, interpret=True, **kw)
    return np.asarray(out, np.float32)


def _port(inp, layer, window, device="cpu", **kw):
    dev = torch.device(device)
    t = {k: tensor_from_numpy(v, dev) for k, v in inp.items()}
    if "sink" in kw:
        kw["sink"] = torch.from_numpy(kw["sink"]).to(dev)
    return tda.decode_attention_stacked(*(t[k] for k in ARGS), layer,
                                        t["lens"], window=window, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_matches_pallas_kernel(name):
    inp, kw, windows = _build(name)
    bf16 = CASES[name].get("dtype") == "bfloat16"
    tol = TOL_BF16 if bf16 else TOL
    for layer, w in enumerate(windows):
        want = _jax(inp, layer, w, **dict(kw))
        got = _port(inp, layer, w, **dict(kw))
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=f"layer {layer}", **tol)


def test_single_layer_entry_matches_jax():
    """``decode_attention`` (one (B, Hkv, D, S) layer) against JAX's."""
    inp, kw, _ = _build("window100")
    want = np.asarray(jda.decode_attention(
        *(jnp.asarray(inp[k][0]) if k.endswith("cache") else
          jnp.asarray(inp[k]) for k in ARGS), jnp.asarray(inp["lens"]),
        window=100, block_s=64, interpret=True, **kw))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = tda.decode_attention(t["q"], t["k_cache"][0], t["v_cache"][0],
                               t["new_k"], t["new_v"], t["lens"], window=100,
                               **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_twin_ignores_dead_slots():
    """Values at and past lens[b] (the active token's own slot, which the
    model writes before attending, included) and before the window must
    not change the result."""
    inp, kw, _ = _build("window32")
    base = _port(inp, 0, 32, **dict(kw))
    poisoned = {k: v.copy() for k, v in inp.items()}
    for i, ln in enumerate(inp["lens"]):
        poisoned["k_cache"][0, i, :, :, ln:] = 1e4       # K is (D, S)
        poisoned["v_cache"][0, i, :, ln:] = -1e4
        poisoned["k_cache"][0, i, :, :, :ln - 32 + 1] = 1e4
    np.testing.assert_array_equal(_port(poisoned, 0, 32, **dict(kw)).numpy(),
                                  base.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    inp, kw, _ = _build("gqa_8_2")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = [t[k] for k in ARGS]
    with pytest.raises(ValueError, match="batch"):
        tda.decode_attention_stacked(args[0][:2], *args[1:3],
                                     args[3][:2], args[4][:2], 0,
                                     t["lens"][:2], **kw)
    with pytest.raises(ValueError, match="layer"):
        tda.decode_attention_stacked(*args, 1, t["lens"], **kw)
    with pytest.raises(ValueError, match="lens"):
        tda.decode_attention_stacked(*args, 0, t["lens"].long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention_stacked(
            args[0].transpose(1, 2).contiguous().transpose(1, 2),
            *args[1:], 0, t["lens"], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_twin(name):
    """On the card: the hand-written kernel against the twin on the same
    inputs (fp32 sums in another order: 1e-4; bf16 output: one ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    inp, kw, windows = _build(name)
    tol = 1e-2 if CASES[name].get("dtype") == "bfloat16" else 1e-4
    before = tda.decode_attention_stacked.launches
    for layer, w in enumerate(windows):
        got = _port(inp, layer, w, device="cuda", **dict(kw))
        torch.cuda.synchronize()
        want = _port(inp, layer, w, device="cpu", **dict(kw))
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol)
    assert tda.decode_attention_stacked.launches == before + len(windows)
