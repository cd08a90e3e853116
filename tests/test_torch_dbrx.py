"""The DBRX family of the port against the JAX package's: bias-free
LayerNorm in every norm, the fused ``Wqkv`` clamped to +-``clip_qkv``, and
an MoE in every layer (softmax top-k, renormalised) from fused experts.

The tiny config is the reference's (tests/test_deepseek_dbrx.py:94-108:
d_model 64, 4 q / 2 kv heads of 16, 3 layers, 4 experts of 48, top 2,
``clip_qkv`` 8). The HF ``DbrxForCausalLM`` is built from a torch seed,
then ``Wqkv`` is redrawn at N(0, 1.5) so that the clamp bites (the share
of clamped q/k/v values is measured and must reach 1%), the norm weights
at N(1, 0.1) and the routers at N(0, 0.2). A second config at head_dim 64
(6 q heads over 1 KV head: a group of 6, DBRX's) takes the kernel
branches: on the CPU the port's wrappers run their plain twins and the
JAX package its Pallas kernels in interpret mode. fp32 logits agree at
atol=2e-3, rtol=1e-3 (the suite's HF tolerance,
tests/test_llama_golden.py:63); greedy streams are equal on both apps and
the ragged engine. The ``cuda``-marked tests hold both decode kernels at
DBRX's heads (48 q over 8 KV heads of 128: G 6) to their plain twins on
the card, over bf16 and fp8 pages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.ops.normalization import \
    layer_norm as j_layer_norm
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.dbrx import (
    DbrxFamily, TpuDbrxForCausalLM)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from neuronx_distributed_inference_tpu_torch.ops.normalization import \
    layer_norm
from test_torch_decode_attention import _chip_smoke
from test_torch_dense_families import _transformers, ids_of
from test_torch_gpt_oss import _same_fields
from test_torch_serving_engine import _serve

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
CLIP = 8.0
QKV_STD = 1.5
# tests/test_deepseek_dbrx.py:94-108
TINY = dict(d_model=64, n_heads=4, n_layers=3, max_seq_len=128,
            vocab_size=256,
            attn_config={"kv_n_heads": 2, "clip_qkv": CLIP,
                         "rope_theta": 10000.0},
            ffn_config={"ffn_hidden_size": 48, "moe_num_experts": 4,
                        "moe_top_k": 2, "moe_normalize_expert_weights": 1},
            torch_dtype="float32")
# head_dim 64 at DBRX's group of 6: the kernel branches
G6 = dict(TINY, d_model=384, n_heads=6, n_layers=2,
          attn_config=dict(TINY["attn_config"], kv_n_heads=1))
VARIANTS = {"tiny": TINY, "g6_hd64": G6}
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
RNG = np.random.default_rng(37)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (11, 23, 30)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def hf_dbrx(kw, seed=0):
    """A tiny HF ``DbrxForCausalLM``: ``Wqkv`` at N(0, QKV_STD), norms at
    N(1, 0.1), routers at N(0, 0.2)."""
    tf = _transformers()
    DbrxConfig, DbrxForCausalLM = tf.DbrxConfig, tf.DbrxForCausalLM
    torch.manual_seed(seed)
    model = DbrxForCausalLM(DbrxConfig(**kw)).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.endswith("Wqkv.weight"):
                w.copy_(QKV_STD * torch.randn(w.shape, generator=gen))
            elif "norm" in name:
                w.copy_(1.0 + 0.1 * torch.randn(w.shape, generator=gen))
            elif name.endswith("router.layer.weight"):
                w.copy_(0.2 * torch.randn(w.shape, generator=gen))
    return model


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, kw in VARIANTS.items():
        d = tmp_path_factory.mktemp("dbrx_" + name)
        hf_dbrx(kw).save_pretrained(d, safe_serialization=True)
        out[name] = str(d)
    return out


def make_apps(ckpt, tcfg=CONTIG, paged=False):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``."""
    jfam, tfam = j_get_family("dbrx"), get_family("dbrx")
    japp = (JPagedApp if paged else JApp)(
        ckpt, jfam.config_cls(JTpuConfig(**tcfg),
                              load_config=j_load_config(ckpt)), jfam)
    cfg = tfam.config_cls(TpuConfig(**tcfg),
                          load_config=load_pretrained_config(ckpt))
    tapp = (PagedCausalLMApplication(ckpt, cfg, tfam, device="cpu")
            if paged else TpuDbrxForCausalLM(ckpt, cfg, device="cpu"))
    return japp.load_weights().init_cache(), tapp.load_weights().init_cache()


def assert_logits_close(got, want, what=""):
    assert len(got) == len(want) and len(got) > 0
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what} step {step}",
                                   **LOGIT_TOL)


def clipped_share(app, ids):
    """The share of layer 0's q/k/v values on the prompt tokens ``ids``
    beyond +-``qkv_clip`` (before the clamp)."""
    w = app.params["layers"]
    h = app.params["embed"][torch.as_tensor(ids).long()]
    h = layer_norm(h, w["input_norm"][0], None, app.spec.rms_eps)
    qkv = h @ w["qkv_proj"][0]
    return float((qkv.abs() > app.spec.qkv_clip).float().mean())


# ---------------------------------------------------------------------------
# layer_norm, the spec and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype, bias):
    """``layer_norm`` against JAX's, with and without a bias: fp32 to
    1e-6, bf16 within one bf16 ulp of the output (both compute in fp32
    and round once)."""
    rng = np.random.default_rng(11)
    x = (3.0 + 2.0 * rng.standard_normal((2, 7, 96))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    b = (0.1 * rng.standard_normal(96)).astype(np.float32) if bias else None
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = np.asarray(j_layer_norm(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt),
        None if b is None else jnp.asarray(b, jdt), 1e-5)).astype(np.float32)
    got = layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                     None if b is None else torch.from_numpy(b).to(tdt),
                     1e-5)
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * 4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_spec_and_converter_match_jax(ckpts, variant):
    """Every field of the port's spec equals the JAX family's (LayerNorm,
    ``qkv_clip`` 8, softmax top-2 renormalised over 4 experts); the
    converted tree (the split ``Wqkv``, the fused experts) equals the JAX
    tree leaf for leaf, in one ``"layers"`` stack."""
    jfam = j_get_family("dbrx")
    want = jfam.build_spec(jfam.config_cls(
        JTpuConfig(**CONTIG), load_config=j_load_config(ckpts[variant])),
        tp_degree=1)
    got = get_family("dbrx").build_spec(DbrxFamily.config_cls(
        TpuConfig(**CONTIG), load_config=load_pretrained_config(
            ckpts[variant])), tp_degree=1)
    _same_fields(got, want, "spec")
    assert got.norm_type == "layernorm" and got.qkv_clip == CLIP
    assert got.moe.normalize_topk and got.moe.router_act == "softmax"
    assert got.gqa.q_per_kv == (6 if variant == "g6_hd64" else 2)
    japp, tapp = make_apps(ckpts[variant])
    jtree = jax.tree.map(np.asarray, japp.params)
    ttree = jax.tree.map(lambda t: t.numpy(), tapp.params)
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    jax.tree.map(np.testing.assert_array_equal, ttree, jtree)
    assert set(ttree) == {"embed", "final_norm", "lm_head", "layers"}


# ---------------------------------------------------------------------------
# the apps and the ragged engine against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_contiguous_logits_greedy_and_clip_match_jax(ckpts, variant):
    """The contiguous app's ``generate``: fp32 logits at LOGIT_TOL and
    greedy tokens equal to JAX's. The clamp bites: at least 1% of layer
    0's q/k/v values lie beyond +-8, and the port without it
    (``qkv_clip=None``) parts from JAX beyond the tolerance; so does the
    port with RMSNorm in place of LayerNorm."""
    japp, tapp = make_apps(ckpts[variant])
    ids, mask = ids_of([20, 13], seed=3)
    share = clipped_share(tapp, ids[0, :20])
    assert share >= 0.01, share
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], variant)
    base = tapp.spec
    for knob in (dict(qkv_clip=None), dict(norm_type="rms")):
        tapp.spec = dataclasses.replace(base, **knob)
        tapp.init_cache()
        off = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                            return_logits=True)["logits"]
        assert not all(np.allclose(np.asarray(a), np.asarray(b),
                                   **LOGIT_TOL)
                       for a, b in zip(off, want["logits"])), knob
    tapp.spec = base


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_and_ragged_streams_match_jax(ckpts, variant, monkeypatch):
    """The paged app's ``generate`` gives JAX's logits and tokens; three
    requests through a batch of two on the ragged engine (prefill chunks
    of 16) give the JAX engine's streams. At head_dim 64 every layer's
    T = 1 step reaches the paged kernel's wrapper at G 6."""
    calls = set()
    orig = decode_attention.paged_decode_attention

    def spy(*a, **k):
        calls.add((int(a[5]), a[0].shape[1] // a[3].shape[1]))
        return orig(*a, **k)
    monkeypatch.setattr(decode_attention, "paged_decode_attention", spy)
    japp, tapp = make_apps(ckpts[variant], PAGED, paged=True)
    ids, mask = ids_of([20, 13], seed=5)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], variant)
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    jserved = _serve(japp, "jax", True, subs, chunk=16)
    served = _serve(tapp, "port", True, subs, chunk=16)
    assert served[:3] == jserved[:3]
    assert [len(t) for t in served[0]] == [6, 5, 4]
    assert calls == ({(0, 6), (1, 6)} if variant == "g6_hd64" else set())


# ---------------------------------------------------------------------------
# on the card: both decode kernels at G 6
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bfloat16", "float8_e4m3fn"])
def test_cuda_paged_kernel_at_group_six_matches_twin(pages):
    """On the card: the paged kernel at DBRX's heads (48 q over 8 KV
    heads of 128: G 6, rows 6-7 of the 8-wide instantiation dead), bf16
    activations over bf16 or scaled fp8 pages, against its plain twin
    within one bf16 ulp of the twin's largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    scale = 0.5 if pages != "bfloat16" else None
    x = cs.paged_inputs(gen, dev, b=4, hq=48, hkv=8, d=128, bs=32, mb=96,
                        lens=[0, 37, 1500, 3000], act_dtype=torch.bfloat16,
                        page_dtype=getattr(torch, pages), kv_scale=scale)
    kw = dict(scale=128 ** -0.5)
    if scale is not None:
        kw["kv_scale"] = scale
    tol = cs.tol_decode_bf16(decode_attention.paged_decode_attention_plain(
        x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
        x["lens"], x["block_table"], **kw))
    assert cs.check_kernel_against_twin(x, kw) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "float8_e4m3fn"])
def test_cuda_contiguous_kernel_at_group_six_matches_twin(cache):
    """On the card: the contiguous decode kernel at DBRX's heads (G 6)
    over S 4096, bf16 activations over a bf16 or scaled fp8 cache,
    against its plain twin within one bf16 ulp of the twin's largest
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    scale = 0.5 if cache != "bfloat16" else None
    c = cs.contiguous_inputs(gen, dev, b=4, hq=48, hkv=8, d=128, s=4096,
                             lens=[0, 517, 2048, 4095], layers=2,
                             act_dtype=torch.bfloat16,
                             cache_dtype=getattr(torch, cache),
                             kv_scale=scale)
    kw = dict(scale=128 ** -0.5, layer=1)
    if scale is not None:
        kw["kv_scale"] = scale
    dargs, dkw = cs.decode_args(c, kw)
    tol = cs.tol_decode_bf16(
        decode_attention.decode_attention_stacked_plain(*dargs, **dkw))
    assert cs.check_decode_against_twin(c, kw) <= tol


def test_chip_smoke_moe_families_helpers(capsys):
    """Phase 20's helpers (chip_smoke), none defined twice in the
    script: the full-width Scout and DBRX
    specs pass ``check_moe_family_specs`` (NoPE at every fourth layer,
    all MoE, chunk 8192; LayerNorm, clip 8, G 6 admitted by the decode gate);
    ``moe_families_cut`` cuts DBRX's ``n_layers`` with
    ``num_hidden_layers``; ``generate_logits_rel_rms`` reads the prompt's
    last token and every decode step."""
    import ast
    cs = _chip_smoke()
    names = [n.name for n in ast.parse(open(cs.__file__).read()).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert len(names) == len(set(names)), "a helper defined twice"
    cs.check_moe_family_specs()
    assert '"moe_families_specs"' in capsys.readouterr().out
    cut = cs.moe_families_cut(cs.DBRX_INSTRUCT, 2)
    assert cut["n_layers"] == cut["num_hidden_layers"] == 2
    assert cs.DBRX_INSTRUCT["n_layers"] == 40
    spec = cs.family_spec(cut)
    assert spec.num_layers == 2 and spec.hidden_size == 6144
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((2, 5, 7)), rng.standard_normal((2, 1, 7)),
            rng.standard_normal((2, 1, 7))]
    got = [w.copy() for w in want]
    assert cs.generate_logits_rel_rms(got, want, [3, 5]) == 0.0
    got[0][1, 4] += 1.0           # row 1's last prompt token
    got[0][0, 4] += 100.0         # past row 0's prompt: not read
    assert 0.0 < cs.generate_logits_rel_rms(got, want, [3, 5]) < 1.0
