"""The Llama4 text family of the port against the JAX package's: chunked
attention on the RoPE layers, NoPE global layers, the weightless q/k norm,
the attention temperature and the interleaved dense / MoE stack.

The tiny config is the reference's (tests/test_llama4.py:27-50): 4 layers,
attention chunk 4, MoE every second layer (layers 1 and 3), layer 3 NoPE,
``floor_scale`` 4 so the temperature moves within a short prompt. Its
all-MoE variant sets ``interleave_moe_layer_step`` 1 (no dense stack).
HF ``Llama4ForCausalLM`` checkpoints are built from a torch seed (router
weights redrawn at N(0, 0.2) so the top-1 choice is decisive) and loaded
by both packages with ``load_weights``. fp32 logits agree at atol=2e-3,
rtol=1e-3 (the suite's HF tolerance, tests/test_llama_golden.py:63) and
greedy streams are equal, on prompts that cross attention chunks; the
ragged engine, with prefill chunks of 3 straddling attention chunks of 4,
serves the JAX engine's streams. No kernel takes a chunked layer."""

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
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.ops.normalization import \
    rms_norm as j_rms_norm
from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.models.llama4 import (
    Llama4Family, TpuLlama4ForCausalLM)
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.ops import (decode_attention,
                                                         flash_attention)
from test_torch_decode_attention import _chip_smoke
from test_torch_dense_families import _transformers, ids_of
from test_torch_gpt_oss import _same_fields
from test_torch_serving_engine import _serve

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
# tests/test_llama4.py:27-50
TINY = dict(
    vocab_size=512, hidden_size=64, intermediate_size=32,
    intermediate_size_mlp=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, num_experts_per_tok=1,
    num_local_experts=4, interleave_moe_layer_step=2,
    no_rope_layer_interval=4, attention_chunk_size=4,
    attn_temperature_tuning=True, floor_scale=4.0, attn_scale=0.1,
    use_qk_norm=True, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=256, tie_word_embeddings=False,
    torch_dtype="float32")
VARIANTS = {"interleaved": {}, "all_moe": dict(interleave_moe_layer_step=1)}
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
INT8 = dict(quantized=True, quantization_dtype="int8",
            quantization_type="per_channel_symmetric")
RNG = np.random.default_rng(31)
PROMPTS = [RNG.integers(1, 512, size=n).tolist() for n in (11, 6, 14)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def hf_llama4(seed=0, **over):
    """A tiny HF ``Llama4ForCausalLM`` (``TINY`` with ``over``), routers
    redrawn at N(0, 0.2)."""
    tf = _transformers()
    Llama4ForCausalLM, Llama4TextConfig = (tf.Llama4ForCausalLM,
                                           tf.Llama4TextConfig)
    torch.manual_seed(seed)
    model = Llama4ForCausalLM(Llama4TextConfig(**{**TINY, **over})).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, w in model.named_parameters():
            if name.endswith("router.weight"):
                w.copy_(0.2 * torch.randn(w.shape, generator=gen))
    return model


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, over in VARIANTS.items():
        d = tmp_path_factory.mktemp("llama4_" + name)
        hf_llama4(**over).save_pretrained(d, safe_serialization=True)
        out[name] = str(d)
    return out


def make_apps(ckpt, tcfg=CONTIG, paged=False, **over):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``."""
    jfam, tfam = j_get_family("llama4_text"), get_family("llama4_text")
    kw = dict(tcfg, **over)
    japp = (JPagedApp if paged else JApp)(
        ckpt, jfam.config_cls(JTpuConfig(**kw),
                              load_config=j_load_config(ckpt)), jfam)
    tcfg_obj = tfam.config_cls(TpuConfig(**kw),
                               load_config=load_pretrained_config(ckpt))
    tapp = (PagedCausalLMApplication(ckpt, tcfg_obj, tfam, device="cpu")
            if paged else TpuLlama4ForCausalLM(ckpt, tcfg_obj, device="cpu"))
    return japp.load_weights().init_cache(), tapp.load_weights().init_cache()


def assert_logits_close(got, want, what=""):
    assert len(got) == len(want) and len(got) > 0
    for step, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what} step {step}",
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the spec, the converter and the layer stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_spec_matches_jax(ckpts, variant):
    """Every field of the port's spec (RopeConfig and MoESpec included)
    equals the JAX family's: layer 3 NoPE, chunk 4, the temperature at
    (4, 0.1), the q/k norm, the interleaved pairing; the MoE pattern of
    the variant."""
    cfg = j_load_config(ckpts[variant])
    jfam = j_get_family("llama4_text")
    want = jfam.build_spec(jfam.config_cls(JTpuConfig(**CONTIG),
                                           load_config=cfg), tp_degree=1)
    tcfg = Llama4Family.config_cls(
        TpuConfig(**CONTIG), load_config=load_pretrained_config(
            ckpts[variant]))
    got = get_family("llama4").build_spec(tcfg, tp_degree=1)
    _same_fields(got, want, "spec")
    assert got.layer_pattern == (True, True, True, False)
    assert got.attn_chunk == 4 and got.nope_global and got.qk_l2_norm
    assert got.attn_temp == (4.0, 0.1) and got.rope_interleaved
    assert got.moe.input_scaled and got.moe.router_act == "sigmoid"
    assert got.moe.shared_intermediate == 32 and got.intermediate_size == 64
    assert got.moe_pattern == ((False, True, False, True)
                               if variant == "interleaved" else (True,) * 4)
    assert not (got.rolling_window or got.mixed_kv)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_converter_matches_jax(ckpts, variant):
    """The port's converted tree equals the JAX tree leaf for leaf (the
    fused ``gate_up_proj`` split at I, ``down_proj`` as stored, the
    shared expert, the fp32 router); the stacks hold the pattern's layers
    in order (the all-MoE variant has no ``"layers"``), and
    ``decoder_param_specs`` gives every leaf's shape."""
    japp, tapp = make_apps(ckpts[variant])
    want = jax.tree.map(np.asarray, japp.params)
    got = jax.tree.map(lambda t: t.numpy(), tapp.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    stacks = ({"layers": 2, "moe_layers": 2} if variant == "interleaved"
              else {"moe_layers": 4})
    assert {k: got[k]["input_norm"].shape[0] for k in stacks} == stacks
    assert set(got) - {"embed", "final_norm", "lm_head"} == set(stacks)
    shapes = jax.tree.map(
        lambda p: tuple(p.shape),
        model_base.decoder_param_specs(tapp.spec),
        is_leaf=lambda n: not isinstance(n, dict))
    assert shapes == jax.tree.map(lambda a: a.shape, want)


def test_layer_stacks_walk_the_pattern():
    """``layer_plan`` gives every layer's stack and index in it, each
    stack's layers in order of appearance; ``iter_layers`` walks it, the
    absolute layer index running through both stacks."""
    spec = Llama4Family.build_spec(Llama4Family.config_cls(
        TpuConfig(**CONTIG), **dict(TINY, model_type="llama4_text",
                                    num_hidden_layers=6,
                                    moe_layers=[1, 2, 5])))
    assert spec.moe_pattern == (False, True, True, False, False, True)
    assert model_base.layer_plan(spec) == [
        ("layers", 0, 0, "dense"), ("moe_layers", 1, 0, "moe"),
        ("moe_layers", 2, 1, "moe"), ("layers", 3, 1, "dense"),
        ("layers", 4, 2, "dense"), ("moe_layers", 5, 2, "moe")]
    params = {"layers": {"w": torch.tensor([0, 3, 4])},
              "moe_layers": {"w": torch.tensor([1, 2, 5])}}
    walked = [(i, int(w["w"]), kind)
              for i, w, kind in model_base.iter_layers(spec, params)]
    assert walked == [(i, i, "moe" if spec.moe_pattern[i] else "dense")
                      for i in range(6)]


# ---------------------------------------------------------------------------
# the masks, the q/k norm and the temperature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,chunk", [(0, 4), (0, 3), (5, 4), (0, 0)])
def test_chunk_masks_match_jax(window, chunk):
    """``causal_mask`` / ``prefill_causal_mask`` / ``decode_mask`` with a
    chunk (and a window beside it) equal JAX's, over padded and shifted
    positions."""
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8],
                    [5, 6, 7, 8, 9, 10, 11, 0, 0]], np.int32)
    kv = np.array([np.arange(9), np.arange(3, 12)], np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tattn.causal_mask(t(pos), t(kv), window, chunk).numpy(),
        np.asarray(jattn.causal_mask(pos, kv, None, window, chunk)))
    np.testing.assert_array_equal(
        tattn.prefill_causal_mask(t(pos), window, chunk).numpy(),
        np.asarray(jattn.prefill_causal_mask(9, pos, window, chunk)))
    dpos = pos[:, -3:]
    np.testing.assert_array_equal(
        tattn.decode_mask(t(dpos), 16, window, chunk).numpy(),
        np.asarray(jattn.decode_mask(dpos, 16, window, chunk)))
    if chunk == 4 and window == 0:
        # position 9 attends 8 and 9 only (its chunk starts at 8)
        row = tattn.decode_mask(t(np.array([[9]], np.int32)), 16, 0, 4)
        assert row[0, 0].nonzero().flatten().tolist() == [8, 9]


def test_qk_l2_norm_is_a_weightless_rms():
    """``qk_l2_norm`` equals JAX's ``rms_norm`` with a unit weight (the
    reference's ``_l2``, model_base.py:1036-1040) in fp32 and bf16, and
    is not ``F.normalize``: the two differ by sqrt(D)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    got = model_base.qk_l2_norm(torch.from_numpy(x), 1e-5)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.ones(16), 1e-5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    gotb = model_base.qk_l2_norm(xb, 1e-5)
    wantb = np.asarray(j_rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.ones(16, jnp.bfloat16), 1e-5)
                       ).astype(np.float32)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), wantb, rtol=1e-2,
                               atol=1e-2)
    unit = torch.nn.functional.normalize(torch.from_numpy(x), dim=-1)
    np.testing.assert_allclose(got.numpy(), unit.numpy() * 4.0, rtol=1e-4,
                               atol=1e-5)


def test_attn_temp_scale_matches_jax_on_both_sides_of_floor_scale():
    """The temperature from the positions tensor equals the reference's
    expression (model_base.py:1050-1053) in jnp, at positions below,
    at and past ``floor_scale`` (the scale is 1 below it and grows in
    steps after); a new positions tensor gives new scales (nothing is
    frozen at a captured step)."""
    floor_scale, a_scale = 8192.0, 0.1
    pos = np.array([[0, 8190, 8191, 8192], [16382, 16383, 100000, 3]],
                   np.int32)
    got = model_base.attn_temp_scale((floor_scale, a_scale),
                                     torch.from_numpy(pos))
    pf = jnp.asarray(pos).astype(jnp.float32)
    want = np.asarray(jnp.log1p(jnp.floor((pf + 1.0) / floor_scale))
                      * a_scale + 1.0)
    assert got.shape == (2, 4, 1, 1)
    np.testing.assert_allclose(got[..., 0, 0].numpy(), want, rtol=1e-7,
                               atol=0)
    assert got[0, :2].eq(1.0).all() and got[0, 2:].gt(1.0).all()
    other = model_base.attn_temp_scale((floor_scale, a_scale),
                                       torch.from_numpy(pos + 8192))
    assert not torch.equal(other, got)


# ---------------------------------------------------------------------------
# the contiguous app and the ragged engine against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_contiguous_logits_and_greedy_match_jax(ckpts, variant):
    """``generate`` on the contiguous app: prompts of 12 and 7 tokens
    (three and two attention chunks) and 10 decode steps that cross two
    more chunk boundaries; fp32 logits at LOGIT_TOL and greedy tokens
    equal to JAX's. Controls: the port without the q/k norm, rotating its
    NoPE layer, without the chunk, or at twenty times the temperature's
    ``attn_scale`` (at this size the temperature alone moves the logits
    by less than the tolerance) parts from JAX beyond LOGIT_TOL."""
    japp, tapp = make_apps(ckpts[variant])
    ids, mask = ids_of([12, 7], seed=5, vocab=512)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=10,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=10,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], variant)
    if variant != "interleaved":
        return
    base = tapp.spec
    for knob in (dict(attn_temp=(4.0, 2.0)), dict(qk_l2_norm=False),
                 dict(nope_global=False), dict(attn_chunk=0)):
        tapp.spec = dataclasses.replace(base, **knob)
        tapp.init_cache()
        off = tapp.generate(ids, attention_mask=mask, max_new_tokens=10,
                            return_logits=True)["logits"]
        assert not all(np.allclose(np.asarray(a), np.asarray(b),
                                   **LOGIT_TOL)
                       for a, b in zip(off, want["logits"])), knob
    tapp.spec = base


def test_ragged_engine_streams_match_jax(ckpts):
    """The paged app's ``generate`` matches JAX's; then three requests
    through a batch of two on the ragged engine, prefill chunks of 3
    straddling attention chunks of 4, give the JAX engine's streams."""
    japp, tapp = make_apps(ckpts["interleaved"], PAGED, paged=True)
    ids, mask = ids_of([13, 9], seed=7, vocab=512)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], "paged")
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (7, 5, 6))]
    jserved = _serve(japp, "jax", True, subs, chunk=3)
    served = _serve(tapp, "port", True, subs, chunk=3)
    assert served[:3] == jserved[:3]
    assert [len(t) for t in served[0]] == [7, 5, 6]


def test_chip_smoke_served_routes_read_the_served_experts(ckpts):
    """chip_smoke's ``ServedRoutes`` gives, for a served token, the top-1
    expert of each MoE layer that ``router_check_at``'s single-row
    ``generate`` takes there (fp32: no flip), at the first and the last
    step of three requests served through a batch of two with prefill
    chunks of 3; a flip the served pass did not make, forced into that
    ``generate``, moves a token's deficit."""
    cs = _chip_smoke()
    fam = get_family("llama4_text")
    ckpt = ckpts["interleaved"]
    app = PagedCausalLMApplication(
        ckpt, fam.config_cls(TpuConfig(**PAGED),
                             load_config=load_pretrained_config(ckpt)),
        fam, device="cpu").load_weights().init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (7, 5, 6))]
    with cs.ServedRoutes() as routes:
        served = _serve(app, "port", True, subs, chunk=3)[0]
    assert len(routes.dispatches) > 0
    app.init_cache()
    checked = 0
    for (prompt, n, _), toks in zip(subs, served):
        for j in (0, n - 1):
            got = routes.experts(prompt, len(prompt) + j - 1, 2)
            assert got is not None and len(got) == 2
            chk = cs.router_check_at(app, prompt, np.asarray(toks), j, 32,
                                     got)
            assert chk["reference_experts"] == got, (j, chk)
            assert chk["forced_deficit"] is None
            checked += 1
    assert checked == 6
    # the served token here the reference's runner-up: a deficit > 0 that
    # the forced flip moves
    lg = app.generate(np.asarray([prompt]), max_new_tokens=n,
                      return_logits=True,
                      teacher_tokens=np.asarray([toks[:n - 1]]))["logits"]
    app.release()
    fake = np.asarray(toks).copy()
    fake[n - 1] = int(np.argsort(np.asarray(lg[n - 1][0, 0]))[-2])
    flipped = [[(e[0] + 1) % 4] for e in got]
    chk = cs.router_check_at(app, prompt, fake, n - 1, 32, flipped)
    assert chk["served_experts"] == flipped and chk["deficit"] > 0
    assert chk["forced_deficit"] is not None
    assert abs(chk["forced_deficit"] - chk["deficit"]) > 1e-3


def test_int8_weights_over_both_stacks_match_jax(ckpts, tmp_path):
    """int8 per-channel weights: the port's quantized tree equals JAX's
    bit for bit in both stacks (experts, shared expert and dense MLP
    quantized), and ``generate`` gives JAX's logits and tokens; the
    port's ``save_quantized_state_dict`` of both stacks loads in the JAX
    app's ``load_quantized_state_dict`` to the same tree."""
    japp, tapp = make_apps(ckpts["interleaved"], **INT8)
    path = str(tmp_path / "q")
    tapp.save_quantized_state_dict(path)
    jfam = j_get_family("llama4_text")
    loaded = JApp(None, jfam.config_cls(
        JTpuConfig(**dict(CONTIG, **INT8)),
        load_config=j_load_config(ckpts["interleaved"])),
        jfam).load_quantized_state_dict(path)
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, loaded.params),
                 jax.tree.map(np.asarray, japp.params))
    want = jax.tree.map(np.asarray, japp.params)
    got = jax.tree.map(lambda t: t.numpy(), tapp.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    for stack, leaf in (("moe_layers", "expert_gate"),
                        ("moe_layers", "shared_down"),
                        ("layers", "gate_proj")):
        assert set(got[stack][leaf]) == {"qweight", "scale"}
    ids, mask = ids_of([12, 7], seed=9, vocab=512)
    w = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                      return_logits=True)
    g = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                      return_logits=True)
    np.testing.assert_array_equal(g["generated"], w["generated"])
    assert_logits_close(g["logits"], w["logits"], "int8")


# ---------------------------------------------------------------------------
# the kernel gates (latent fault 1)
# ---------------------------------------------------------------------------

WIDE = dict(TINY, model_type="llama4_text", hidden_size=256,
            num_attention_heads=2, num_key_value_heads=1, head_dim=128,
            intermediate_size=64, intermediate_size_mlp=128, vocab_size=256)


def test_kernel_gates_refuse_chunked_attention_at_a_kernel_width():
    """Latent fault 1, the chunk half: at head_dim 128 (a width every
    kernel takes) with ``attn_kernel_enabled=True``, both decode gates
    (``decode_attention.supports``, which the contiguous and the paged
    admissions call) and ``use_flash_prefill`` refuse a chunked spec, and
    each admits the same spec without its chunk."""
    cfg = Llama4Family.config_cls(TpuConfig(
        batch_size=2, seq_len=128, dtype="float32", attn_kernel_enabled=True,
        attn_block_tkg_kernel_enabled=True), **WIDE)
    spec = Llama4Family.build_spec(cfg)
    assert spec.head_dim == 128 and spec.attn_chunk == 4
    uniform = dataclasses.replace(spec, layer_pattern=None)
    assert spec.flash_prefill and flash_attention.supports(128, 128, False, 0)
    for s in (spec, uniform):
        assert not decode_attention.supports(s, 1)
        assert not model_base.use_decode_kernel(s, 1, torch.float32)
        assert not model_base.use_flash_prefill(s, 128)
    plain = dataclasses.replace(uniform, attn_chunk=0)
    assert decode_attention.supports(plain, 1)
    assert model_base.use_decode_kernel(plain, 1, torch.float32)
    assert model_base.use_flash_prefill(plain, 128)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_generate_with_decode_kernel_on_launches_no_kernel(monkeypatch,
                                                           paged):
    """A Llama4 ``generate`` at head_dim 128 with
    ``attn_block_tkg_kernel_enabled=True`` and ``attn_kernel_enabled=True``
    calls none of the three kernel entry points, on the contiguous app
    and on the paged app."""
    calls = []
    for owner, name in ((decode_attention, "decode_attention_stacked"),
                        (decode_attention, "paged_decode_attention"),
                        (flash_attention, "flash_attention")):
        fn = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    kw = dict(batch_size=2, seq_len=128, dtype="float32",
              attn_kernel_enabled=True, attn_block_tkg_kernel_enabled=True,
              enable_bucketing=False)
    if paged:
        kw.update(is_block_kv_layout=True, pa_block_size=16,
                  enable_bucketing=True)
    cfg = Llama4Family.config_cls(TpuConfig(**kw), **WIDE)
    app = (PagedCausalLMApplication(None, cfg, Llama4Family, device="cpu")
           if paged else TpuLlama4ForCausalLM(None, cfg, device="cpu"))
    assert app.spec.decode_kernel is True
    app.init_random_weights(3).init_cache()
    ids = np.random.default_rng(2).integers(1, 250, size=(2, 20))
    out = app.generate(ids, max_new_tokens=4)
    assert np.asarray(out["generated"]).shape == (2, 4) and calls == []
