"""The paged decode attention of the port against the JAX package's Pallas
kernel (run in interpret mode, as tests/test_decode_attention.py runs it).

On the CPU the port's wrapper runs its plain twin
(``paged_decode_attention_plain``); fp32 at rtol=atol=2e-5, the JAX
kernel tests' own tolerance. The CUDA kernel itself is compared with the
twin by the ``cuda``-marked tests below, which run only on the card: the
case matrix, then the fused kernel's own risks (its merge counters under
repeated calls and CUDA-graph replay, every split count, a zero-length row
beside a long one, fp8 pages, window + sink at serving shapes, GPT-OSS's
local and global layers). On the CPU
the wrapper's host logic is pinned: the scratch layout and the counters."""

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


def _case(rng, *, hq=4, hkv=2, d=64, bs=32, mb=8, lens=(5, 100, 255),
          layers=1, page_dtype=None, kv_scale=None):
    """Numpy inputs: random pages scattered through a scrambled block
    table (block 0 = null, never live), q/new_k/new_v, lens."""
    b = len(lens)
    n = 1 + b * mb
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    kp, vp = f(layers, n, bs, hkv, d), f(layers, n, bs, hkv, d)
    if page_dtype is not None:
        kp = np.asarray(jkv.quantize_kv(jnp.asarray(kp), page_dtype,
                                        kv_scale))
        vp = np.asarray(jkv.quantize_kv(jnp.asarray(vp), page_dtype,
                                        kv_scale))
    perm = rng.permutation(n - 1)[:b * mb] + 1
    table = np.zeros((b, mb), np.int32)
    for i, ln in enumerate(lens):
        live = -(-int(ln + 1) // bs)
        table[i, :live] = perm[i * mb:i * mb + live]
    return dict(q=f(b, hq, d), k_pages=kp, v_pages=vp, new_k=f(b, hkv, d),
                new_v=f(b, hkv, d), lens=np.asarray(lens, np.int32),
                block_table=table)


ARGS = ("q", "k_pages", "v_pages", "new_k", "new_v")


def _jax(inp, layer=0, **kw):
    if "window" in kw:
        kw["window"] = jnp.asarray(kw["window"], jnp.int32)
    if "sink" in kw:
        kw["sink"] = jnp.asarray(kw["sink"])
    out = jda.paged_decode_attention(
        *(jnp.asarray(inp[k]) for k in ARGS), jnp.asarray(layer, jnp.int32),
        jnp.asarray(inp["lens"]), jnp.asarray(inp["block_table"]),
        interpret=True, **kw)
    return np.asarray(out)


def _port(inp, layer=0, device="cpu", **kw):
    dev = torch.device(device)
    t = {k: tensor_from_numpy(v, dev) for k, v in inp.items()}
    if "sink" in kw:
        kw["sink"] = torch.from_numpy(kw["sink"]).to(dev)
    return tda.paged_decode_attention(
        *(t[k] for k in ARGS), layer, t["lens"], t["block_table"], **kw)


CASES = {
    "gqa_4_4_d64": dict(hq=4, hkv=4),
    "gqa_8_2_d64": dict(hq=8, hkv=2),
    "gqa_4_4_d128": dict(hq=4, hkv=4, d=128),
    "gqa_8_2_d128": dict(hq=8, hkv=2, d=128),
    "gqa_8_1_d128": dict(hq=8, hkv=1, d=128),
    "zero_len_row": dict(lens=(0, 60), mb=4),
    "window64_sink": dict(lens=(200, 90), extra="window_sink"),
    "soft_cap": dict(lens=(7, 130, 31), extra="soft_cap"),
    "stacked_layers_L3": dict(lens=(40, 100), mb=4, layers=3),
    "fp8_e4m3_kv_scale": dict(lens=(70, 130), bs=64, mb=4,
                              page_dtype="float8_e4m3fn", kv_scale=0.5),
    # gpt-oss-20b's heads (64 q over 8 kv, D 64) with its sinks: a local
    # layer (window 128, shorter than two rows) and a global one
    "gpt_oss_local_window128_sink": dict(hq=64, hkv=8, lens=(300, 37, 129),
                                         mb=12, extra="gpt_oss_local"),
    "gpt_oss_global_window0_sink": dict(hq=64, hkv=8, lens=(300, 37, 129),
                                        mb=12, extra="gpt_oss_global"),
    # multi-query groups over 16 (StarCoder's G 48 at D 128, Falcon-7B's
    # G 71 at D 64): 3 and 5 chunks of at most 16 query heads, the last of
    # 7; with a window and per-head sinks across the chunks, over fp8
    "mqa_g48_d128": dict(hq=48, hkv=1, d=128, lens=(5, 100, 255)),
    "mqa_g71_d64": dict(hq=71, hkv=1, lens=(5, 100, 255)),
    "mqa_g71_d64_window_sink": dict(hq=71, hkv=1, lens=(200, 90),
                                    extra="window_sink"),
    "mqa_g48_fp8_kv_scale": dict(hq=48, hkv=1, d=128, lens=(70, 130),
                                 bs=64, mb=4, page_dtype="float8_e4m3fn",
                                 kv_scale=0.5),
}
# the window of each case that takes a window and a sink
WINDOW_SINK = {"window_sink": 64, "gpt_oss_local": 128, "gpt_oss_global": 0}


def _kwargs(name, spec, rng, d):
    kw = dict(scale=d ** -0.5)
    extra = spec.get("extra")
    if extra in WINDOW_SINK:
        kw.update(window=WINDOW_SINK[extra], sink=rng.standard_normal(
            spec.get("hq", 4)).astype(np.float32))
    elif extra == "soft_cap":
        kw.update(soft_cap=2.0)
    if spec.get("kv_scale") is not None:
        kw.update(kv_scale=spec["kv_scale"])
    return kw


def _build(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    spec = dict(CASES[name])
    spec.pop("extra", None)
    if "page_dtype" in spec:
        spec["page_dtype"] = jnp.dtype(spec["page_dtype"])
    inp = _case(rng, **spec)
    kw = _kwargs(name, CASES[name], rng, inp["q"].shape[-1])
    layers = range(inp["k_pages"].shape[0])
    return inp, kw, layers


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_matches_pallas_kernel(name):
    inp, kw, layers = _build(name)
    for layer in layers:
        want = _jax(inp, layer, **dict(kw))
        got = _port(inp, layer, **dict(kw))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"layer "
                                   f"{layer}", **TOL)


def test_plain_twin_ignores_dead_slots():
    """Values past lens[b] (including the active token's own slot, which
    the model writes before attending) must not change the result: the
    mask is kpos < lens strictly and the active token comes from
    new_k/new_v."""
    inp, kw, _ = _build("gqa_8_2_d64")
    base = _port(inp, **dict(kw))
    poisoned = {k: v.copy() for k, v in inp.items()}
    bs = inp["k_pages"].shape[2]
    for i, ln in enumerate(inp["lens"]):
        page = inp["block_table"][i, ln // bs]
        poisoned["k_pages"][0, page, ln % bs:] = 1e4
        poisoned["v_pages"][0, page, ln % bs:] = -1e4
    poisoned["k_pages"][:, 0] = 1e4          # the null page
    np.testing.assert_array_equal(_port(poisoned, **dict(kw)).numpy(),
                                  base.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_twin(name):
    """On the card: the hand-written kernel against the twin on the same
    inputs (fp32 sums in another order: 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    inp, kw, layers = _build(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    before = tda.paged_decode_attention.launches
    for layer in layers:
        got = _port(inp, layer, device="cuda", **dict(kw))
        torch.cuda.synchronize()
        want = _port(inp, layer, device="cpu", **dict(kw))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert tda.paged_decode_attention.launches == before + len(layers)


def test_scratch_layout():
    """acc (B, Hkv, splits, G, D) then (m, l) per head, in fp32 elements."""
    assert tda.scratch_layout(4, 8, 4, 64, 32) == (4 * 8 * 32 * 4 * 64,
                                                   4 * 8 * 32 * 4 * 2)
    assert tda.scratch_layout(1, 1, 1, 128, 1) == (128, 2)


@pytest.mark.parametrize("batch,hkv,max_blocks,block_size,d,want", [
    (4, 8, 64, 32, 64, 16),     # the paged path's decode shapes
    (1, 8, 64, 32, 64, 32),     # capped by the table's 32 tiles of 64 keys
    (1, 1, 512, 32, 128, 64),   # capped at 64
    (64, 8, 64, 32, 64, 1),     # a large batch: one block per (row, head)
    (8, 8, 4, 32, 128, 4),      # a short table: 128 keys, tiles of 32
])
def test_num_splits_from_shapes(batch, hkv, max_blocks, block_size, d, want):
    """Splits of the paged kernel: about four blocks per SM of 132, at most
    one per tile of 4096 / D keys, at most 64; shapes only (no sync)."""
    assert tda.num_splits(batch, hkv, max_blocks, block_size, d) == want


def test_merge_counters_cached_zeroed_and_grown():
    """One zeroed int32 counter per (row, KV head), cached per device (a
    call launches no memset), grown only past its size."""
    dev = torch.device("cpu")
    tda._COUNTERS.pop(dev, None)
    a = tda.merge_counters(dev, 32)
    assert a.dtype == torch.int32 and a.numel() >= 32
    assert int(a.abs().sum()) == 0
    assert tda.merge_counters(dev, 32) is a
    assert tda.merge_counters(dev, a.numel()) is a
    big = tda.merge_counters(dev, a.numel() + 1)
    assert big is not a and big.numel() == a.numel() + 1
    assert int(big.abs().sum()) == 0
    tda._COUNTERS.pop(dev, None)


def _cuda_inputs(name, lens, *, d=64, hkv=8, page_dtype=None,
                 kv_scale=None, act=None):
    """32 q heads over ``hkv`` KV heads on the card; ``act`` casts q /
    new_k / new_v (bf16 pages take bf16 activations on the model's
    path)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    inp = _case(rng, hq=32, hkv=hkv, d=d, bs=32, mb=64, lens=lens,
                page_dtype=page_dtype, kv_scale=kv_scale)
    t = {k: tensor_from_numpy(v, torch.device("cuda"))
         for k, v in inp.items()}
    if act is not None:
        for k in ("q", "new_k", "new_v"):
            t[k] = t[k].to(act)
    return t, rng


def _call(t, **kw):
    return tda.paged_decode_attention(
        *(t[k] for k in ARGS), 0, t["lens"], t["block_table"], **kw)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


@pytest.mark.cuda
def test_cuda_fused_merge_resets_its_counters():
    """The same call 3 times eagerly, then 10 times inside one CUDA graph
    replayed twice: every output equals the first (the merging block puts
    its counter back to 0, so no call sees a stale count), and each call
    is one launch."""
    _skip_without_card()
    t, _ = _cuda_inputs("repeat", (100, 363, 963, 1563))
    kw = dict(scale=0.125)
    before = tda.paged_decode_attention.launches
    first = _call(t, **kw)
    for _ in range(2):
        assert torch.equal(_call(t, **kw), first)
    assert tda.paged_decode_attention.launches == before + 3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _call(t, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_call(t, **kw) for _ in range(10)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o in outs:
            assert torch.equal(o, first)
    assert int(tda._COUNTERS[first.device].abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_every_split_count(monkeypatch):
    """Splits 1 .. 64 (the wrapper's bound) over rows of 0 to 2047 keys:
    the kernel against the twin each time (fp32: 1e-4)."""
    _skip_without_card()
    t, _ = _cuda_inputs("splits", (0, 31, 777, 2047))
    want = tda.paged_decode_attention_plain(
        *(t[k] for k in ARGS), 0, t["lens"], t["block_table"], scale=0.125)
    for n in range(1, 65):
        monkeypatch.setattr(tda, "num_splits", lambda *a, n=n: n)
        got = _call(t, scale=0.125)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-4, (n, err)


CUDA_CASES = {
    "zero_len_beside_long": dict(lens=(0, 2000)),
    "fp8_e4m3_kv_scale": dict(lens=(70, 1300), page_dtype="float8_e4m3fn",
                              kv_scale=0.5),
    "window100_sink": dict(lens=(50, 1500), window=100, sink=True),
    "d128_window_sink_softcap": dict(lens=(5, 999), d=128, window=300,
                                     sink=True, soft_cap=5.0),
    # Qwen3-30B-A3B heads (32 q over 4 kv: GQA group 8, D 128) at phase
    # 9's lens mid-run, fp32 and bf16 pages
    "qwen3_g8_fp32": dict(lens=(61, 324, 924, 1924, 147, 664, 1524, 88),
                          d=128, hkv=4),
    "qwen3_g8_bf16": dict(lens=(61, 324, 924, 1924, 147, 664, 1524, 88),
                          d=128, hkv=4, page_dtype="bfloat16",
                          act=torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_serving_shapes_match_plain_twin(name):
    """Llama-3.2-1B / 3.1-8B heads (32 q, 8 kv) and Qwen3-30B-A3B heads
    (32 q, 4 kv) over a 64-page table: the kernel against the twin on the
    card (fp32: 1e-4; bf16 out: one ulp, 1e-2)."""
    _skip_without_card()
    spec = dict(CUDA_CASES[name])
    page_dtype = spec.pop("page_dtype", None)
    t, rng = _cuda_inputs(name, spec.pop("lens"), d=spec.pop("d", 64),
                          hkv=spec.pop("hkv", 8),
                          page_dtype=(None if page_dtype is None
                                      else jnp.dtype(page_dtype)),
                          kv_scale=spec.get("kv_scale"),
                          act=spec.pop("act", None))
    d = t["q"].shape[-1]
    kw = dict(scale=d ** -0.5, window=spec.get("window", 0),
              soft_cap=spec.get("soft_cap"), kv_scale=spec.get("kv_scale"))
    if spec.get("sink"):
        kw["sink"] = torch.from_numpy(
            rng.standard_normal(32).astype(np.float32)).cuda()
    got = _call(t, **kw)
    torch.cuda.synchronize()
    want = tda.paged_decode_attention_plain(
        *(t[k] for k in ARGS), 0, t["lens"], t["block_table"], **kw)
    tol = 1e-4 if got.dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("window", [0, 40, 128])
def test_paged_sdpa_window_sink_yardstick(window):
    """The SDPA yardstick of the paged kernel with a window and a sink
    (chip_smoke): each row's keys inside its window pre-gathered from the
    pages, the active token last, and a zero key whose additive mask is the
    head's sink logit; SDPA over it equals the plain twin (fp32, CPU). The
    bound counts only the keys inside each row's window."""
    import torch.nn.functional as F

    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    rng = np.random.default_rng(31 + window)
    inp = _case(rng, hq=16, hkv=2, lens=(0, 37, 200), mb=8)
    x = {k: torch.from_numpy(v) for k, v in inp.items()}
    sink = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    q4, k, v, mask = cs.sdpa_window_inputs(x, 0, window, sink)
    n = min(window, 201) if window else 201
    assert k.shape == v.shape == (3, 2, n + 1, 64)
    assert mask.shape == (3, 16, 1, n + 1)
    got = F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                         scale=64 ** -0.5, enable_gqa=True)
    want = tda.paged_decode_attention_plain(
        x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
        x["lens"], x["block_table"], scale=64 ** -0.5, window=window,
        sink=sink)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    keys = sum(min(n_, window - 1) if window else n_ for n_ in (0, 37, 200))
    ms, by = cs.kernel_bounds(x, window, sink=True)
    assert by == "bytes"
    kv_bytes = 2 * keys * 2 * 64 * 4
    assert kv_bytes / cs.HBM_BYTES_PER_S * 1e3 < ms < (
        kv_bytes + 10 ** 5) / cs.HBM_BYTES_PER_S * 1e3


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "glm_air_g12_bf16", "glm_air_g12_fp8", "glm_air_g12_fp32",
    "granite_g3_d64_bf16", "olmoe_g1_bf16"])
def test_cuda_kernel_at_contrib_moe_groups_matches_twin(name):
    """On the card: the paged kernel at the contrib MoE families' heads
    (chip_smoke.CONTRIB_KERNEL_CASES: GLM-4.5-Air's 96 q over 8 KV heads,
    G 12 on the 16-wide instantiation, over bf16, scaled fp8 and fp32
    pages; granite's G 3 at head_dim 64 with the scale 1/64; OLMoE's G 1)
    against its plain twin: one bf16 ulp of the twin's largest output for
    a bf16 output, 1e-4 for fp32."""
    _skip_without_card()
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    dev = torch.device("cuda")
    x, kw = cs.contrib_kernel_inputs(
        name, dev, torch.Generator(device=dev).manual_seed(15), "paged")
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    before = tda.paged_decode_attention.launches
    got = tda.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = tda.paged_decode_attention_plain(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= cs.contrib_kernel_tol(want), err
    assert tda.paged_decode_attention.launches == before + 1



def test_supports_takes_any_gqa_group():
    """The kernels' gate has no group term, as the reference's
    (decode_attention.py:588-595): StarCoder's G 48 at head_dim 128,
    Falcon-7B's G 71 at 64 and a group of 16 all pass it and the paged
    branch's; ALiBi, MLA, chunked attention and other head dims stay
    refused; the wrapper's checks take Hq 71 over one KV head."""
    import dataclasses
    from neuronx_distributed_inference_tpu_torch.models import model_base
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    sc = cs.family_spec(cs.STARCODER, seq_len=4096)
    fa = cs.family_spec(cs.FALCON_7B, seq_len=2048)
    assert (sc.gqa.q_per_kv, sc.head_dim) == (48, 128)
    assert (fa.gqa.q_per_kv, fa.head_dim) == (71, 64)
    for spec in (sc, fa):
        assert tda.supports(spec, 1)
        assert model_base.use_decode_kernel(spec, 1, torch.bfloat16)
        assert not tda.supports(spec, 2)
        for over in (dict(alibi=True), dict(attn_chunk=64),
                     dict(head_dim=96)):
            assert not tda.supports(dataclasses.replace(spec, **over), 1)
    inp = _case(np.random.default_rng(5), hq=71, hkv=1, lens=(3, 40), mb=2)
    assert _port(inp, scale=0.125).shape == (2, 71, 64)


@pytest.mark.parametrize("g,chunks,want_paged,want_contig", [
    (1, 1, 63, 64), (16, 1, 63, 64), (17, 2, 33, 33), (48, 3, 22, 22),
    (71, 5, 13, 13)])
def test_num_splits_count_group_chunks(g, chunks, want_paged, want_contig):
    """A group over 16 takes ceil(G / 16) blocks per KV head and split;
    the split counts count those chunks as heads toward their targets (B
    8, one KV head, 63 blocks of 32 at D 128; B 4, S 2048); a group of at
    most 16 keeps its counts."""
    assert tda.group_chunks(g) == chunks
    assert tda.num_splits(8, 1, 63, 32, 128, g) == want_paged
    assert tda.contiguous_num_splits(4, 1, 2048, 128, g) == want_contig
    if g <= 16:
        assert tda.num_splits(8, 1, 63, 32, 128) == want_paged


def test_reserve_pins_a_counter_per_row_kv_head_and_chunk():
    """``StepGraphs.reserve`` pins max rows x ``counters_per_row``
    counters, one per (row, KV head, chunk) the kernels count on: at 512
    rows, 8 KV heads and G 48 that is 12288; a later call needing more
    raises
    instead of moving the buffer a captured graph holds. The speculative
    decoders' runner pins the most blocks a row of the target or the
    draft takes."""
    import types
    from neuronx_distributed_inference_tpu_torch.models import speculation
    from neuronx_distributed_inference_tpu_torch.models.cuda_graphs import \
        StepGraphs
    dev = torch.device("cpu")
    tda._COUNTERS.pop(dev, None)
    try:
        StepGraphs(dev).reserve(512, tda.counters_per_row(8, 48))
        assert tda._COUNTERS[dev].numel() == 512 * 8 * 3
        assert tda.merge_counters(dev, 512 * 8 * 3) is tda._COUNTERS[dev]
        with pytest.raises(RuntimeError, match="pin_merge_counters"):
            tda.merge_counters(dev, 512 * 8 * 3 + 1)
    finally:
        tda._COUNTERS.pop(dev, None)
        tda._PINNED.discard(dev)

    def spec(hq, hkv):
        return types.SimpleNamespace(gqa=types.SimpleNamespace(
            num_kv_heads=hkv, q_per_kv=hq // hkv))
    target = types.SimpleNamespace(
        tpu_config=types.SimpleNamespace(kv_cache_batch_size=None),
        device=dev, batch_buckets=[1, 4], spec=spec(32, 8))
    assert speculation._StepRunner(target)._counters == 8
    assert speculation._StepRunner(target, (), spec(71, 1))._counters == 8
    assert speculation._StepRunner(target, (),
                                   spec(48 * 4, 4))._counters == 12


def test_work_counts_the_whole_group():
    """The observatory's count of a call at G 48 (fake tensors): QK and PV
    of every query head over the live keys and the active token, the K/V
    bytes read once for the one KV head (the bound's formula), as at any
    group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, hq, hkv, d, bs, mb = 8, 48, 1, 128, 32, 64
    with FakeTensorMode():
        q = torch.empty(b, hq, d, dtype=torch.bfloat16)
        pages = torch.empty(1, b * mb + 1, bs, hkv, d, dtype=torch.bfloat16)
        nk = torch.empty(b, hkv, d, dtype=torch.bfloat16)
        lens = torch.empty(b, dtype=torch.int32)
        table = torch.empty(b, mb, dtype=torch.int32)
        heard = []
        with tda.kernel_work_listener(lambda *a: heard.append(a)):
            out = tda.paged_decode_attention(q, pages, pages, nk, nk, 0,
                                             lens, table, scale=d ** -0.5)
        assert out.shape == (b, hq, d)
    live = mb * bs
    assert heard == [("paged_decode_attention",
                      4 * (b * live + b) * hq * d,
                      2 * b * live * hkv * d * 2
                      + (2 * b * hq * d + 2 * b * hkv * d) * 2
                      + 4 * b + 4 * b * mb)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float8_e4m3fn"])
@pytest.mark.parametrize("group", ["g48_d128", "g71_d64"])
def test_cuda_kernel_at_wide_groups_matches_twin(group, dtype):
    """On the card: the paged kernel at G 48 / D 128 and G 71 / D 64 over
    one KV head (chip_smoke.wide_kernel_inputs: phase 27 (a)'s batch, B 8,
    lens 37-2000) over bf16 (the tensor cores), fp32 and scaled fp8 pages
    (the CUDA cores) against its twin, in one launch: one bf16 ulp of the
    twin's largest output for a bf16 output, 1e-4 for fp32; every merge
    counter (one per row and chunk) back at 0."""
    _skip_without_card()
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    dev = torch.device("cuda")
    x, kw = cs.wide_kernel_inputs(
        group, dtype, dev, torch.Generator(device=dev).manual_seed(27),
        "paged")
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    before = tda.paged_decode_attention.launches
    got = tda.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = tda.paged_decode_attention_plain(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= cs.contrib_kernel_tol(want), err
    assert tda.paged_decode_attention.launches == before + 1
    assert int(tda.merge_counters(tda._device_key(dev), 1).abs().sum()) == 0
