"""The dense families of the port on the paged app and the ragged engine,
against the JAX package's.

The tiny checkpoints of tests/test_torch_dense_families.py (norm weights
drawn per weight, soft-caps that bite) are loaded by both packages'
paged apps: fp32 logits of ``generate`` at atol=2e-3, rtol=1e-3, greedy
and seeded sampled streams equal, and the ragged engine's streams equal
the JAX engine's. A Gemma-2 variant at head_dim 64 takes the kernel
branches (the paged decode kernel, and the contiguous decode kernel on
the mixed cache's global layers) with the attention soft-cap: on the CPU
the port's wrappers run their plain twins and the JAX package its Pallas
kernels in interpret mode. The ``cuda``-marked test holds the paged and
the contiguous kernels with a soft-cap at GQA group 2 to their twins on
the card."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from test_torch_dense_families import (ATTN_CAP, LOGIT_TOL, NAMES,
                                       assert_logits_close, hf_model,
                                       ids_of, make_apps, save_checkpoint)
from test_torch_serving_engine import _serve

PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
SC = dict(do_sample=True, top_k=8, top_p=0.95, temperature=1.3,
          stream_seed=11)
RNG = np.random.default_rng(29)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (11, 23, 30)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {n: save_checkpoint(hf_model(n), tmp_path_factory.mktemp(n))
           for n in NAMES}
    # head_dim 64: both packages take their kernel branches
    out["gemma2_hd64"] = save_checkpoint(
        hf_model("gemma2", head_dim=64, query_pre_attn_scalar=64),
        tmp_path_factory.mktemp("gemma2_hd64"))
    return out


def _variant(name):
    return "gemma2" if name == "gemma2_hd64" else name


@pytest.mark.parametrize("name", NAMES + ["gemma2_hd64"])
def test_paged_logits_greedy_and_ragged_streams_match_jax(ckpts, name):
    """The paged app's ``generate`` (prefill and 8 decode steps past the
    window of 8): fp32 logits at LOGIT_TOL and greedy tokens equal to the
    JAX paged app's; then three requests through a batch of two on the
    ragged engine (prefill chunks of 16) give the JAX engine's streams."""
    japp, tapp = make_apps(ckpts[name], _variant(name), tcfg=PAGED,
                           paged=True)
    ids, mask = ids_of([20, 13], seed=3)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    jserved = _serve(japp, "jax", True, subs, chunk=16)
    served = _serve(tapp, "port", True, subs, chunk=16)
    assert served[:3] == jserved[:3]
    assert [len(t) for t in served[0]] == [6, 5, 4]


@pytest.mark.parametrize("name", ["gemma2", "gemma3", "granite"])
def test_seeded_sampled_streams_match_jax(ckpts, name):
    """Seeded sampled ``generate`` (the coupled draw, stream_seed 11) and
    the ragged engine's seeded streams equal the JAX package's token for
    token; the soft-capped, divided logits feed the draw, so a dropped
    cap or divisor would move it."""
    japp, tapp = make_apps(ckpts[name], name, tcfg=PAGED, paged=True,
                           sampling=SC)
    ids, mask = ids_of([20, 13], seed=5)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8)
    np.testing.assert_array_equal(np.asarray(got["generated"]),
                                  np.asarray(want["generated"]))
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    assert (_serve(tapp, "port", True, subs, chunk=16)[:3]
            == _serve(japp, "jax", True, subs, chunk=16)[:3])


def test_gemma2_hd64_takes_the_kernel_branches(ckpts, monkeypatch):
    """At head_dim 64 the Gemma-2 apps reach both decode kernels' wrappers
    with the layer's window and the attention soft-cap: the paged one on
    every layer of a T = 1 paged step (window 8 on local layers, 0 on
    global ones), the contiguous one on the mixed cache's global layers
    only; the contiguous app's logits equal JAX's at LOGIT_TOL."""
    calls = {"paged": set(), "contig": set()}
    for kind, name in (("paged", "paged_decode_attention"),
                       ("contig", "decode_attention_stacked")):
        orig = getattr(decode_attention, name)

        def spy(*a, _orig=orig, _kind=kind, **k):
            calls[_kind].add((int(a[5]), k["window"], k["soft_cap"]))
            return _orig(*a, **k)
        monkeypatch.setattr(decode_attention, name, spy)
    _, tapp = make_apps(ckpts["gemma2_hd64"], "gemma2", tcfg=PAGED,
                        paged=True)
    ids, mask = ids_of([20, 13], seed=3)
    tapp.generate(ids, attention_mask=mask, max_new_tokens=3)
    assert calls["paged"] == {(i, 8 if i % 2 == 0 else 0, ATTN_CAP)
                              for i in range(4)}
    japp, capp = make_apps(ckpts["gemma2_hd64"], "gemma2")
    assert capp.spec.mixed_kv
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                         return_logits=True)
    got = capp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], "gemma2_hd64")
    # global layers 1 and 3 are rows 0 and 1 of the global stack
    assert calls["contig"] == {(0, 0, ATTN_CAP), (1, 0, ATTN_CAP)}


@pytest.mark.cuda
def test_cuda_soft_capped_kernels_at_group_two_match_twins():
    """On the card: the paged kernel (Gemma-2-27B's heads, 32 q over 16
    kv of 128: G 2) with soft-cap 50 at window 4096 and 0, and the
    contiguous kernel over a global stack, each in bf16 against its plain
    twin; the kernel run without the cap parts from the capped twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, d, bs, mb = 4, 32, 16, 128, 32, 220
    lens = torch.tensor([300, 2100, 4500, 7000], dtype=torch.int32,
                        device=dev)

    def rand(*shape, s=1.0):
        return (s * torch.randn(shape, generator=gen, device=dev)).to(
            torch.bfloat16)
    # |scores| mostly above 50 at scale 144 ** -0.5
    q, nk, nv = rand(b, hq, d, s=9.0), rand(b, hkv, d, s=9.0), rand(b, hkv, d)
    kp, vp = rand(1, b * mb, bs, hkv, d, s=9.0), rand(1, b * mb, bs, hkv, d)
    table = torch.arange(b * mb, dtype=torch.int32, device=dev).reshape(b, mb)
    for window in (4096, 0):
        kw = dict(scale=144 ** -0.5, window=window, soft_cap=50.0)
        args = (q, kp, vp, nk, nv, 0, lens, table)
        got = decode_attention.paged_decode_attention(*args, **kw).float()
        want = decode_attention.paged_decode_attention_plain(
            *args, **kw).float()
        err = (got - want).abs().max().item()
        assert err < 2e-2, err
        nocap = decode_attention.paged_decode_attention(
            *args, **dict(kw, soft_cap=None)).float()
        assert (nocap - want).abs().max().item() > 10 * 2e-2
    s = 8192
    kc, vc = rand(2, b, hkv, d, s, s=9.0), rand(2, b, hkv, s, d)
    kw = dict(scale=144 ** -0.5, window=0, soft_cap=50.0)
    args = (q, kc, vc, nk, nv, 1, lens)
    got = decode_attention.decode_attention_stacked(*args, **kw).float()
    want = decode_attention.decode_attention_stacked_plain(
        *args, **kw).float()
    assert (got - want).abs().max().item() < 2e-2
    nocap = decode_attention.decode_attention_stacked(
        *args, **dict(kw, soft_cap=None)).float()
    assert (nocap - want).abs().max().item() > 10 * 2e-2


@pytest.mark.parametrize("window", [0, 40])
def test_chip_smoke_dense_helpers(window):
    """Phase 19's helpers (chip_smoke): without a sink the windowed SDPA
    yardstick has no extra column and equals the twin without a cap;
    ``masked_scores`` keeps exactly the live keys' scores; the Gemma
    layer types and cuts (Gemma-3's 4-layer cut ends at its first global
    layer)."""
    import torch.nn.functional as F

    from test_torch_decode_attention import _chip_smoke
    from test_torch_paged_decode_attention import _case
    cs = _chip_smoke()
    rng = np.random.default_rng(41 + window)
    lens = (0, 37, 200)
    x = {k: torch.from_numpy(v) for k, v in _case(
        rng, hq=4, hkv=2, lens=lens, mb=8).items()}
    q4, k, v, mask = cs.sdpa_window_inputs(x, 0, window, None)
    n = min(window, 201) if window else 201
    assert k.shape == v.shape == (3, 2, n, 64)
    assert mask.shape == (3, 4, 1, n)
    got = F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                         scale=64 ** -0.5, enable_gqa=True)
    want = decode_attention.paged_decode_attention_plain(
        x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
        x["lens"], x["block_table"], scale=64 ** -0.5, window=window)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    live = sum(min(m + 1, window) if window else m + 1 for m in lens)
    assert cs.masked_scores(q4, k, mask, 1.0).numel() == 4 * live
    types = cs.dense_layer_types(cs.GEMMA2_27B)
    assert types[:3] == ["sliding_attention", "full_attention",
                         "sliding_attention"] and len(types) == 46
    assert cs.dense_layer_types(cs.PHI_4) is None
    cut = cs.dense_cut(cs.GEMMA3_27B, 4)
    assert cut["layer_types"] == ["sliding_attention"] * 3 + [
        "full_attention"]
    assert cs.dense_cut(cs.GEMMA3_27B, 12)["layer_types"].count(
        "full_attention") == 2
