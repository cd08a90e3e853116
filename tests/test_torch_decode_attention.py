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
    "gqa_8_1_d128": dict(hq=8, hkv=1, d=128),
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
    # multi-query groups over 16 (StarCoder's G 48 at D 128, Falcon-7B's
    # G 71 at D 64): 3 and 5 chunks of at most 16 query heads, the last of
    # 7; with sinks and a window across the chunks, in bf16
    "mqa_g48_d128": dict(hq=48, hkv=1, d=128),
    "mqa_g71_d64": dict(hq=71, hkv=1),
    "mqa_g71_sink_window": dict(s=128, hq=71, hkv=1, lens=(60, 100),
                                sink=True, window=48),
    "mqa_g48_bf16_io": dict(s=128, hq=48, hkv=1, d=128, lens=(64, 100),
                            dtype="bfloat16"),
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


@pytest.mark.parametrize("batch,hkv,seq_len,d,want", [
    (4, 8, 4096, 128, 8),       # the Mistral-7B path's decode shapes
    (4, 8, 4096, 64, 8),
    (1, 8, 4096, 128, 33),
    (1, 1, 4096, 128, 64),      # 264 wanted, capped at 64
    (64, 8, 4096, 128, 1),      # a large batch: one block per (row, head)
    (2, 8, 256, 64, 4),         # a short cache: 256 keys, tiles of 64
    (2, 2, 128, 128, 4),        # 66 wanted; 128 keys, tiles of 32
])
def test_contiguous_num_splits_from_shapes(batch, hkv, seq_len, d, want):
    """Splits of the contiguous kernel: about two blocks per SM of 132 (one
    resident wave), at most one per tile of 4096 / D keys, at most 64;
    shapes only (no sync on lens)."""
    assert tda.contiguous_num_splits(batch, hkv, seq_len, d) == want


def _chip_smoke():
    """The repo's chip_smoke.py as a module (it imports torch lazily and
    nothing of JAX)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layer,window", [(0, 0), (1, 0), (1, 40)])
def test_contiguous_sdpa_yardstick_inputs(layer, window):
    """The SDPA yardstick of the contiguous kernel (chip_smoke) is built
    from D-contiguous K and V (stride(-1) == 1, so SDPA may take a fused
    backend, not the math one), and SDPA over it computes the kernel's
    function: it equals the plain twin on the same inputs (fp32, CPU)."""
    import torch.nn.functional as F
    cs = _chip_smoke()
    rng = np.random.default_rng(11 + layer + window)
    b, hq, hkv, d, s = 3, 8, 2, 64, 96
    f = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32))
    x = dict(q=f(b, hq, d), k_cache=f(2, b, hkv, d, s),
             v_cache=f(2, b, hkv, s, d), new_k=f(b, hkv, d),
             new_v=f(b, hkv, d),
             lens=torch.tensor([0, 37, 95], dtype=torch.int32))
    q4, k, v, mask = cs.contiguous_sdpa_inputs(x, layer, window)
    assert k.shape == v.shape == (b, hkv, s, d)
    assert k.stride(-1) == 1 and v.stride(-1) == 1
    got = F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                         scale=d ** -0.5, enable_gqa=True)
    want = tda.decode_attention_stacked_plain(
        x["q"], x["k_cache"], x["v_cache"], x["new_k"], x["new_v"], layer,
        x["lens"], scale=d ** -0.5, window=window)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


# the Mistral-7B path's decode shapes (B 4, Hq 32, Hkv 8, D 128, S 4096)
MISTRAL_LENS = (100, 363, 963, 1963)


def _cuda_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


def _cuda_inputs(name, lens, *, s=4096, cache=torch.bfloat16,
                 act=torch.bfloat16, kv_scale=None, hkv=8):
    """Inputs from a numpy seed on the card: q/new_k/new_v in ``act``,
    the (1, B, hkv, 128, S) / (1, B, hkv, S, 128) cache in ``cache``
    (divided by ``kv_scale`` before the cast, as the model's write path
    does)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, d = len(lens), 128
    dev = torch.device("cuda")

    def f(*sh, dt=act, div=1.0):
        x = rng.standard_normal(sh).astype(np.float32) / div
        return torch.from_numpy(x).to(dev).to(dt)
    div = kv_scale or 1.0
    return dict(q=f(b, 32, d), k_cache=f(1, b, hkv, d, s, dt=cache,
                                         div=div),
                v_cache=f(1, b, hkv, s, d, dt=cache, div=div),
                new_k=f(b, hkv, d), new_v=f(b, hkv, d),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev)), rng


def _cuda_call(t, plain=False, **kw):
    fn = (tda.decode_attention_stacked_plain if plain
          else tda.decode_attention_stacked)
    return fn(*(t[k] for k in ARGS), 0, t["lens"], **kw)


@pytest.mark.cuda
def test_cuda_fused_merge_resets_its_counters():
    """The same call 3 times eagerly, then 10 times inside one CUDA graph
    replayed twice: every output equals the first (the merging block puts
    its counter back to 0, so no call sees a stale count), each call is
    one launch, and the counters end at 0."""
    _cuda_skip()
    t, _ = _cuda_inputs("repeat", MISTRAL_LENS)
    kw = dict(scale=128 ** -0.5)
    before = tda.decode_attention_stacked.launches
    first = _cuda_call(t, **kw)
    for _ in range(2):
        assert torch.equal(_cuda_call(t, **kw), first)
    assert tda.decode_attention_stacked.launches == before + 3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _cuda_call(t, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_cuda_call(t, **kw) for _ in range(10)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            assert torch.equal(o, first)
    assert int(tda._COUNTERS[first.device].abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_every_split_count(monkeypatch):
    """Splits 1 .. 64 (the wrapper's bound) over rows of 0 to 4095 keys,
    with a window: the kernel against the twin each time (bf16 out: one
    ulp, 1e-2)."""
    _cuda_skip()
    t, _ = _cuda_inputs("splits", (0, 31, 2777, 4095))
    kw = dict(scale=128 ** -0.5, window=3000)
    want = _cuda_call(t, plain=True, **kw)
    for n in range(1, 65):
        monkeypatch.setattr(tda, "contiguous_num_splits", lambda *a, n=n: n)
        got = _cuda_call(t, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2, (n, err)


CUDA_CASES = {
    "mistral_bf16": dict(),
    "mistral_bf16_window512_sink_softcap": dict(window=512, sink=True,
                                                soft_cap=5.0),
    "mistral_fp8_kv_scale": dict(cache=torch.float8_e4m3fn, kv_scale=0.5),
    "mistral_fp8_kv_scale_window512": dict(cache=torch.float8_e4m3fn,
                                           kv_scale=0.5, window=512),
    "fp32": dict(cache=torch.float32, act=torch.float32, window=700),
    "s4093_bf16_scalar_k": dict(s=4093, window=1000),
    "s4093_fp8_scalar_k": dict(s=4093, cache=torch.float8_e4m3fn),
    # Qwen3-30B-A3B heads: 32 q over 4 kv (GQA group 8)
    "qwen3_g8_bf16": dict(hkv=4),
    "qwen3_g8_bf16_window512": dict(hkv=4, window=512),
    "qwen3_g8_fp32": dict(hkv=4, cache=torch.float32, act=torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_serving_shapes_match_plain_twin(name):
    """Mistral-7B heads (32 q, 8 kv, D 128) and Qwen3-30B-A3B heads (32 q,
    4 kv) over a 4096-slot cache at the path's decode lens: the kernel (tensor cores for bf16, CUDA cores for
    fp8 and fp32, key-by-key K loads for an S that is not a multiple of a
    16-byte piece's keys) against the twin on the card (bf16 out: 1e-2,
    fp32: 1e-4)."""
    _cuda_skip()
    spec = dict(CUDA_CASES[name])
    t, rng = _cuda_inputs(name, MISTRAL_LENS, s=spec.get("s", 4096),
                          cache=spec.get("cache", torch.bfloat16),
                          act=spec.get("act", torch.bfloat16),
                          kv_scale=spec.get("kv_scale"),
                          hkv=spec.get("hkv", 8))
    kw = dict(scale=128 ** -0.5, window=spec.get("window", 0),
              soft_cap=spec.get("soft_cap"), kv_scale=spec.get("kv_scale"))
    if spec.get("sink"):
        kw["sink"] = torch.from_numpy(
            rng.standard_normal(32).astype(np.float32)).cuda()
    got = _cuda_call(t, **kw)
    torch.cuda.synchronize()
    want = _cuda_call(t, plain=True, **kw)
    tol = 1e-4 if t["q"].dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "glm_air_g12_bf16", "glm_air_g12_fp8", "glm_air_g12_fp32",
    "granite_g3_d64_bf16", "olmoe_g1_bf16"])
def test_cuda_kernel_at_contrib_moe_groups_matches_twin(name):
    """On the card: the contiguous decode kernel at the contrib MoE
    families' heads (chip_smoke.CONTRIB_KERNEL_CASES: G 12 over caches of
    8192 slots in bf16, scaled fp8 and fp32; G 3 at head_dim 64, scale
    1/64; G 1) against its plain twin: one bf16 ulp of the twin's largest
    output for a bf16 output, 1e-4 for fp32."""
    _cuda_skip()
    cs = _chip_smoke()
    dev = torch.device("cuda")
    x, kw = cs.contrib_kernel_inputs(
        name, dev, torch.Generator(device=dev).manual_seed(16), "contig")
    args, kw = cs.decode_args(x, kw)
    before = tda.decode_attention_stacked.launches
    got = tda.decode_attention_stacked(*args, **kw)
    torch.cuda.synchronize()
    want = tda.decode_attention_stacked_plain(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= cs.contrib_kernel_tol(want), err
    assert tda.decode_attention_stacked.launches == before + 1



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("group", ["g48_d128", "g71_d64"])
def test_cuda_kernel_at_wide_groups_matches_twin(group, dtype):
    """On the card: the contiguous kernel at G 48 / D 128 and G 71 / D 64
    over one KV head (chip_smoke.wide_kernel_inputs: phase 27 (a)'s B 4,
    S 2048) over a bf16 cache (the tensor cores) and an fp32 one (the CUDA
    cores) against its twin, in one launch: one bf16 ulp of the twin's
    largest output for a bf16 output, 1e-4 for fp32; every merge counter
    (one per row and chunk) back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    x, kw = cs.wide_kernel_inputs(
        group, dtype, dev, torch.Generator(device=dev).manual_seed(27),
        "contig")
    dargs, dkw = cs.decode_args(x, kw)
    before = tda.decode_attention_stacked.launches
    got = tda.decode_attention_stacked(*dargs, **dkw)
    torch.cuda.synchronize()
    want = tda.decode_attention_stacked_plain(*dargs, **dkw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= cs.contrib_kernel_tol(want), err
    assert tda.decode_attention_stacked.launches == before + 1
    assert int(tda.merge_counters(tda._device_key(dev), 1).abs().sum()) == 0
