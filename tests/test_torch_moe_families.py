"""The Qwen3, Qwen3-MoE and Mixtral families of the port against the JAX
package's, end to end.

Tiny HF ``Qwen3ForCausalLM`` / ``Qwen3MoeForCausalLM`` /
``MixtralForCausalLM`` checkpoints with the geometry of
tests/test_moe.py:90-100 (hidden 64, 3 layers, 4 q / 2 kv heads, vocab
256; 4 experts, top 2) are saved locally. Both packages load them with
``load_weights``: fp32 logits agree at atol=2e-3, rtol=1e-3 (the suite's
HF tolerance, tests/test_llama_golden.py:63) and greedy tokens are equal,
in the contiguous app and in the paged app. The ``ServingEngine`` streams
of the ragged and two-phase paged paths equal the JAX engine's, the port
holding the JAX app's tree carried by ``params_from_numpy``; the ragged
path runs with prefill chunks that put B·T of the MoE block below and
above ``dense_max_tokens`` (64)."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    MoEConfig as JMoEConfig, TpuConfig as JTpuConfig,
    load_pretrained_config as j_load_pretrained_config)
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.mixtral import \
    MixtralFamily as JMixtralFamily
from neuronx_distributed_inference_tpu.models.qwen3 import \
    Qwen3Family as JQwen3Family
from neuronx_distributed_inference_tpu.models.qwen3_moe import \
    Qwen3MoeFamily as JQwen3MoeFamily
from neuronx_distributed_inference_tpu_torch.config import (
    MoEConfig, TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.models.mixtral import \
    TpuMixtralForCausalLM
from neuronx_distributed_inference_tpu_torch.models.qwen3_moe import \
    TpuQwen3MoeForCausalLM
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.warmup import (
    memory_ledger, precompile)
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_serving_engine import _serve
from test_torch_spec_serving import guard_dispatch_reads

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
JAX_FAMILIES = {"qwen3": JQwen3Family, "qwen3_moe": JQwen3MoeFamily,
                "mixtral": JMixtralFamily}
FAMILIES = sorted(JAX_FAMILIES)
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
PAGED = dict(batch_size=2, seq_len=128, dtype="float32",
             is_block_kv_layout=True, pa_block_size=16,
             is_prefix_caching=True, context_encoding_buckets=[32, 64])
RNG = np.random.default_rng(17)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (40, 23, 57)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _hf_model(model_type):
    import os
    saved = {k: os.environ.get(k) for k in ("USE_TF", "USE_FLAX")}
    # the torch model needs neither TensorFlow nor Flax
    os.environ.update(USE_TF="0", USE_FLAX="0")
    try:
        import transformers
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    common = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=256, rms_norm_eps=1e-5,
                  max_position_embeddings=128, torch_dtype="float32",
                  tie_word_embeddings=False)
    if model_type == "mixtral":
        return transformers.MixtralForCausalLM(transformers.MixtralConfig(
            intermediate_size=96, num_local_experts=4, num_experts_per_tok=2,
            sliding_window=None, **common))
    if model_type == "qwen3_moe":
        return transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            intermediate_size=96, moe_intermediate_size=48, head_dim=16,
            num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
            decoder_sparse_step=1, mlp_only_layers=[], **common))
    return transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        intermediate_size=96, head_dim=16, **common))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """model_type -> directory of a saved tiny HF checkpoint."""
    out = {}
    for mt in FAMILIES:
        torch.manual_seed(0)
        model = _hf_model(mt).eval()
        d = tmp_path_factory.mktemp(mt)
        model.save_pretrained(d, safe_serialization=True)
        out[mt] = str(d)
    return out


def _apps(ckpt, mt, tcfg, paged, **tcfg_over):
    """(JAX app, port app), both from ``load_weights`` of ``ckpt``."""
    kw = dict(tcfg, **tcfg_over)
    jfam, tfam = JAX_FAMILIES[mt], get_family(mt)
    japp = (JPagedApp if paged else JApp)(
        ckpt, jfam.config_cls(JTpuConfig(**kw), load_config=(
            j_load_pretrained_config(ckpt))), jfam)
    tapp = (PagedCausalLMApplication if paged else CausalLMApplication)(
        ckpt, tfam.config_cls(TpuConfig(**kw), load_config=(
            load_pretrained_config(ckpt))), tfam, device="cpu")
    return japp.load_weights().init_cache(), tapp.load_weights().init_cache()


def _ids(lens, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, 256, size=max(lens))
                     for _ in lens]).astype(np.int32)


@pytest.mark.parametrize("mt", FAMILIES)
def test_contiguous_load_weights_logits_and_tokens_match_jax(ckpts, mt):
    """The contiguous app: a 48-token prefill (B·T = 96, the MoE block's
    ragged path) and 6 decode steps (B·T = 2, dense): every step's fp32
    logits at LOGIT_TOL and the greedy tokens equal."""
    japp, tapp = _apps(ckpts[mt], mt, CONTIG, paged=False)
    ids = _ids([10, 10], seed=1)
    want = japp.generate(ids, max_new_tokens=6, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=6, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert len(got["logits"]) == len(want["logits"]) == 6
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"step {step}",
                                   **LOGIT_TOL)


@pytest.mark.parametrize("mt", FAMILIES)
def test_paged_generate_equals_contiguous_and_jax(ckpts, mt):
    """Greedy ``generate`` of the paged app equals the contiguous app's
    and the JAX paged app's, token for token; the paged logits agree with
    JAX's at LOGIT_TOL."""
    japp, tapp = _apps(ckpts[mt], mt, PAGED, paged=True, output_logits=True)
    _, capp = _apps(ckpts[mt], mt, CONTIG, paged=False)
    ids = _ids([20, 20], seed=2)
    want = japp.generate(ids, max_new_tokens=6, return_logits=True)
    got = tapp.generate(ids, max_new_tokens=6, return_logits=True)
    contig = capp.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    np.testing.assert_array_equal(contig["generated"], got["generated"])
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL)


@pytest.fixture(scope="module")
def served(ckpts):
    """model_type -> (JAX paged app from the checkpoint, port paged app
    holding the JAX app's tree through ``params_from_numpy``)."""
    out = {}
    for mt in FAMILIES:
        jfam, tfam = JAX_FAMILIES[mt], get_family(mt)
        japp = JPagedApp(ckpts[mt], jfam.config_cls(
            JTpuConfig(**PAGED),
            load_config=j_load_pretrained_config(ckpts[mt])), jfam)
        japp.load_weights().init_cache()
        tapp = PagedCausalLMApplication(None, tfam.config_cls(
            TpuConfig(**PAGED),
            load_config=load_pretrained_config(ckpts[mt])), tfam,
            device="cpu")
        tapp.params = params_from_numpy(
            jax.tree.map(np.asarray, japp.params), device="cpu")
        out[mt] = (japp, tapp.init_cache())
    return out


def _count_expert_paths(monkeypatch):
    seen = {"experts_dense": 0, "experts_ragged": 0}
    for name in seen:
        orig = getattr(tmoe, name)

        def counted(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tmoe, name, counted)
    return seen


@pytest.mark.parametrize("mt", FAMILIES)
@pytest.mark.parametrize("path,chunk", [("ragged", 16), ("ragged", 48),
                                        ("two_phase", 16)])
def test_served_streams_match_jax(served, monkeypatch, mt, path, chunk):
    """Three requests through a batch of two on the port's ServingEngine
    equal the JAX engine's streams, finish reasons and counters. A
    16-token chunk keeps the MoE block on its dense path (B·T <= 32, and
    the two-phase path's one-row prefills at most 64); on the ragged path
    a 48-token chunk puts the mixed passes on the ragged one (a 64-column
    grid, B·T = 128) while the all-decode passes stay dense."""
    japp, tapp = served[mt]
    japp.init_cache()                  # cold prefix caches: full prefills
    tapp.init_cache()
    seen = _count_expert_paths(monkeypatch)
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    ragged = path == "ragged"
    want = _serve(japp, "jax", ragged, subs, chunk=chunk)
    got = _serve(tapp, "port", ragged, subs, chunk=chunk)
    assert got[:3] == want[:3]
    assert all(len(t) == n for t, (_, n, _) in zip(got[0], subs))
    if mt == "qwen3":
        assert seen == {"experts_dense": 0, "experts_ragged": 0}
    else:
        assert seen["experts_dense"] > 0
        assert (seen["experts_ragged"] > 0) == (ragged and chunk == 48)


@pytest.mark.parametrize("mt", ["qwen3_moe", "mixtral"])
def test_moe_app_dispatch_reads_no_device_value(served, monkeypatch, mt):
    """The MoE app under the no-device-read guard of the dispatch regions
    (tests/test_torch_spec_serving.py): the ragged path over both expert
    paths, then the two-phase path, equal the unguarded streams."""
    _, tapp = served[mt]
    subs = [(p, 4, "default") for p in PROMPTS]

    def serve_cold():
        out = []
        for ragged in (True, False):
            tapp.init_cache()
            out.append(_serve(tapp, "port", ragged, subs, chunk=48)[0])
        return out
    want = serve_cold()
    guard_dispatch_reads(monkeypatch)
    seen = _count_expert_paths(monkeypatch)
    assert serve_cold() == want
    assert seen["experts_dense"] > 0 and seen["experts_ragged"] > 0


def test_precompile_and_ledger_of_an_moe_app(served):
    """``precompile`` walks the MoE app's T = 1 signatures (eager on the
    CPU; the dense expert path has static shapes and is captured on the
    card), and ``memory_ledger`` counts its weights to the byte: the
    fp32 router at 4 bytes, the rest at the model dtype."""
    _, tapp = served["qwen3_moe"]
    rep = precompile(tapp, declare_steady=False)
    assert rep["n_graphs"] > 0 and rep["n_compiles"] == 0
    specs = model_base.decoder_param_specs(tapp.spec)

    def spec_bytes(node):
        if isinstance(node, dict):
            return sum(spec_bytes(v) for v in node.values())
        return int(np.prod(node.shape)) * torch.empty(
            (), dtype=node.dtype).element_size()
    ledger = memory_ledger(PagedEngineAdapter(tapp, ragged=True))
    assert ledger["model_bytes"] == spec_bytes(specs)
    assert tapp.params["layers"]["router"].dtype == torch.float32


def test_jax_moe_tree_carries_over_bit_for_bit():
    """A bf16 JAX MoE tree (fp32 router, bf16 experts and q/k norms)
    through ``params_from_numpy``: every leaf keeps its dtype and bits."""
    hf = dict(model_type="qwen3_moe", hidden_size=64, intermediate_size=96,
              moe_intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              vocab_size=256, num_experts=4, num_experts_per_tok=2,
              norm_topk_prob=True, rms_norm_eps=1e-6, hidden_act="silu")
    jfam = JQwen3MoeFamily
    japp = JApp(None, jfam.config_cls(JTpuConfig(batch_size=1, seq_len=32),
                                      **hf), jfam).init_random_weights(5)
    host = jax.tree.map(np.asarray, japp.params)
    got = params_from_numpy(host, device="cpu")
    layers = got["layers"]
    assert layers["router"].dtype == torch.float32
    assert layers["expert_gate"].dtype == torch.bfloat16
    assert set(layers) >= {"q_norm", "k_norm", "expert_up", "expert_down"}

    def check(node, want):
        if isinstance(node, dict):
            for k in want:
                check(node[k], want[k])
            return
        a = np.ascontiguousarray(want)
        raw = (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
        t = (node.view(torch.uint16) if node.dtype == torch.bfloat16
             else node)
        np.testing.assert_array_equal(t.numpy(), raw)
    check(got, host)
    tapp = CausalLMApplication(None, get_family("qwen3_moe").config_cls(
        TpuConfig(batch_size=1, seq_len=32), **hf), device="cpu")
    shapes = jax.tree.map(lambda p: tuple(p.shape),
                          model_base.decoder_param_specs(tapp.spec),
                          is_leaf=lambda n: not isinstance(n, dict))
    assert shapes == jax.tree.map(lambda a: a.shape, host)


QWEN3_MOE = dict(model_type="qwen3_moe", hidden_size=64,
                 intermediate_size=96, moe_intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16, vocab_size=256,
                 num_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-6)
REFUSALS = {
    "mlp_only_layers": (dict(mlp_only_layers=[1]), {}),
    "decoder_sparse_step": (dict(decoder_sparse_step=2), {}),
    "moe_tkg_ep_degree": ({}, dict(moe_config=dict(moe_tkg_ep_degree=2))),
    "moe_cte_tp_degree": ({}, dict(moe_config=dict(moe_cte_tp_degree=1))),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_reference_refusals_hold(case):
    """What the reference refuses for Qwen3-MoE the port refuses too
    (ConfigurationError here, NotImplementedError there)."""
    hf_over, tcfg_over = REFUSALS[case]
    hf = dict(QWEN3_MOE, **hf_over)

    def tcfg(cls, moe_cls):
        kw = dict(batch_size=1, seq_len=32)
        if "moe_config" in tcfg_over:
            kw["moe_config"] = moe_cls(**tcfg_over["moe_config"])
        return cls(**kw)
    with pytest.raises(NotImplementedError):
        JApp(None, JQwen3MoeFamily.config_cls(
            tcfg(JTpuConfig, JMoEConfig), **hf), JQwen3MoeFamily)
    with pytest.raises(ConfigurationError):
        TpuQwen3MoeForCausalLM(None, get_family("qwen3_moe").config_cls(
            tcfg(TpuConfig, MoEConfig), **hf), device="cpu")


def test_port_only_refusals_and_accepted_moe_configs():
    """The port runs an MoEConfig whose degrees are all None or 1 (the
    reference's ``MoETpuConfig`` at tp = 1) and ``moe_tkg_ep_degree=1``
    (``tkg_experts_local``: the hybrid decode layout, the stored one on
    one card); a degree the mesh does not have (the reference ignores
    ``moe_ep_degree``; the port holds it to the mesh's ep) raises
    ConfigurationError naming the mesh's extent; a mixed stack
    of leading dense layers (``first_dense``) builds, and so does an
    interleaved dense / MoE stack (``moe_pattern``), whose layer stacks
    follow the pattern's runs. Mixtral's window below ``seq_len`` takes
    the rolling cache and matches JAX."""
    cls = get_family("qwen3_moe").config_cls
    ok = TpuQwen3MoeForCausalLM(None, cls(TpuConfig(
        batch_size=1, seq_len=32, moe_config=MoEConfig(moe_tp_degree=1)),
        **QWEN3_MOE), device="cpu")
    assert ok.spec.moe.num_experts == 4 and ok.spec.qk_norm
    assert ok.spec.intermediate_size == 48 and ok.spec.q_size == 64
    hybrid = TpuQwen3MoeForCausalLM(None, cls(TpuConfig(
        batch_size=1, seq_len=32, moe_config=MoEConfig(
            moe_tkg_ep_degree=1)), **QWEN3_MOE), device="cpu")
    assert hybrid.spec.moe.tkg_experts_local
    for mc in (MoEConfig(moe_ep_degree=2),):
        with pytest.raises(ConfigurationError, match="on a mesh of ep 1"):
            TpuQwen3MoeForCausalLM(None, cls(TpuConfig(
                batch_size=1, seq_len=32, moe_config=mc), **QWEN3_MOE),
                device="cpu")
    cfg = cls(TpuConfig(batch_size=1, seq_len=32), **QWEN3_MOE)
    moe = tmoe.MoESpec(num_experts=4, top_k=2, intermediate_size=48)
    # Llama4's interleaved stack: the dense layer from "layers", the MoE
    # layer from "moe_layers"
    inter = model_base.spec_from_config(cfg, moe=moe,
                                        moe_pattern=(True, False))
    assert model_base.layer_plan(inter) == [("moe_layers", 0, 0, "moe"),
                                            ("layers", 1, 0, "dense")]
    # DeepSeek's leading dense layers run (a dense stack, then the MoE one)
    mixed = model_base.spec_from_config(cfg, moe=moe, first_dense=1)
    assert model_base.layer_plan(mixed) == [("layers", 0, 0, "dense"),
                                            ("moe_layers", 1, 0, "moe")]
    # Mixtral's window goes through the rolling-cache rule: a window of 16
    # below seq_len 32 takes the rolling cache (16 slots a row) as in JAX,
    # and a prompt longer than the window decodes past it with JAX's
    # logits and tokens
    mix = dict(QWEN3_MOE, model_type="mixtral", num_local_experts=4,
               sliding_window=16)
    mcls = get_family("mixtral").config_cls
    kw = dict(batch_size=1, seq_len=32, dtype="float32", output_logits=True,
              enable_bucketing=False)
    japp = JApp(None, JMixtralFamily.config_cls(JTpuConfig(**kw), **mix),
                JMixtralFamily).init_random_weights(0).init_cache()
    app = TpuMixtralForCausalLM(None, mcls(TpuConfig(**kw), **mix),
                                device="cpu")
    assert app.spec.rolling_window and japp.spec.rolling_window
    app.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                   device="cpu")
    app.init_cache()
    assert app.cache["v"].shape[3] == japp.cache["v"].shape[3] == 16
    ids = _ids([20], seed=9)
    want = japp.generate(ids, max_new_tokens=8, return_logits=True)
    got = app.generate(ids, max_new_tokens=8, return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, np.asarray(b), **LOGIT_TOL)
    app = TpuMixtralForCausalLM(None, mcls(TpuConfig(
        batch_size=1, seq_len=32, rolling_kv_cache=False), **mix),
        device="cpu")
    assert app.spec.sliding_window == 16 and app.spec.moe.top_k == 2
    assert not app.spec.rolling_window


@pytest.mark.cuda
def test_cuda_init_params_makes_no_fp32_copy_of_a_leaf():
    """On the card: ``init_params`` of an expert stack (L 2, E 128, H 2048,
    I 768, bf16: 1.2 GB a projection) raises peak memory by the stack's
    own bytes and no fp32 temporary of a leaf (which would add 2x a
    leaf's bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    cls = get_family("qwen3_moe").config_cls
    hf = dict(QWEN3_MOE, hidden_size=2048, moe_intermediate_size=768,
              num_experts=128, num_experts_per_tok=8, head_dim=128,
              num_attention_heads=32, num_key_value_heads=4)
    spec = cls(TpuConfig(batch_size=1, seq_len=32), **hf)
    spec = get_family("qwen3_moe").build_spec(spec, tp_degree=1)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model_base.init_params(spec, 0, dev)
    torch.cuda.synchronize()
    total = sum(t.numel() * t.element_size() for t in jax.tree.leaves(
        params, is_leaf=lambda n: isinstance(n, torch.Tensor)))
    leaf = params["layers"]["expert_gate"]
    peak = torch.cuda.max_memory_allocated() - base
    assert leaf.dtype == torch.bfloat16
    assert peak < total + leaf.numel() * 2 // 4, (peak, total)
    assert 0.015 < leaf[0, 0].float().std().item() < 0.025
