"""Tensor parallelism of the port on the CPU: tiny Llama's contiguous
``generate`` at tp 2, 4 and 8, each rank a process spawned over gloo
(``parallel.mesh.spawn_world``; one world of 8 ranks, the tp-2 and tp-4
meshes over its first ranks), against the JAX package's
``CausalLMApplication`` at the same tp on its 8 virtual CPU devices, as
the reference's tests/test_parallelism.py:38-70 builds it: the same HF
checkpoint, identical tokens, fp32 logits within atol 2e-3 / rtol 1e-3.
At tp 4 the two KV heads are replicated, at tp 8 the four query heads are
padded to 8 (tests/test_gqa_sharding.py:25-37), so a wrong cut of the
fused q/k/v or of the padded heads parts the streams. Port tp N also
equals port tp 1 token for token. The refusals of the slice (ROADMAP
A13d) raise ``ConfigurationError`` without a world."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.parallel.mesh import \
    mesh_from_config as j_mesh_from_config
from neuronx_distributed_inference_tpu_torch.config import (
    CollectiveConfig, LoraServingConfig, MoEConfig, SpeculationConfig,
    TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import \
    LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, build_mesh, mesh_from_config, spawn_world)
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    ConfigurationError

import torch_tp_ranks
from conftest import tiny_llama_hf_config
from test_torch_dense_families import _transformers

TOL = dict(atol=2e-3, rtol=1e-3)
TCFG = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True,
            enable_bucketing=False)
TPS = (8, 4, 2)
N_NEW = 6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tf = _transformers()
    import torch
    torch.manual_seed(0)
    model = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        num_hidden_layers=2))).eval()
    d = tmp_path_factory.mktemp("tiny_llama_tp")
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(3).integers(1, 500, size=(2, 12)).astype(
        np.int32)


@pytest.fixture(scope="module")
def port_tp(ckpt, prompts, tmp_path_factory):
    """{tp: (tokens, logits, dispatch records)} of the port's ranks."""
    return spawn_world(torch_tp_ranks.generate_at, 8, "gloo", "cpu",
                       str(tmp_path_factory.mktemp("tp_world")), 150.0,
                       (ckpt, "llama", TCFG, prompts, N_NEW, TPS))[0]


def _jax_generate(ckpt, prompts, tp):
    tcfg = JTpuConfig(**TCFG, tp_degree=tp)
    app = JApp(ckpt, JLlamaConfig(tcfg, load_config=j_load_config(ckpt)),
               JLlamaFamily, mesh=j_mesh_from_config(tcfg))
    app.load_weights().init_cache()
    out = app.generate(prompts, max_new_tokens=N_NEW, return_logits=True)
    return out["generated"], [np.asarray(x) for x in out["logits"]]


@pytest.mark.parametrize("tp", TPS)
def test_generate_matches_jax_at_the_same_tp(ckpt, prompts, port_tp, tp):
    """Identical tokens and fp32 logits within tolerance against the JAX
    package at the same tp; one dispatch record a step (the prefill and
    N_NEW - 1 decode steps)."""
    toks, logits, records = port_tp[tp]
    jtoks, jlogits = _jax_generate(ckpt, prompts, tp)
    np.testing.assert_array_equal(toks, jtoks)
    assert len(logits) == len(jlogits) == N_NEW
    for a, b in zip(logits, jlogits):
        np.testing.assert_allclose(a, b, **TOL)
    assert records == N_NEW


@pytest.mark.parametrize("tp", TPS)
def test_generate_equals_port_tp1(ckpt, prompts, port_tp, tp):
    """Port tp N equals the port's single-card app token for token."""
    app = torch_tp_ranks.build_app(ckpt, "llama", TCFG)
    want = app.generate(prompts, max_new_tokens=N_NEW)["generated"]
    np.testing.assert_array_equal(port_tp[tp][0], want)


def _tiny_config(**tcfg):
    return LlamaInferenceConfig(TpuConfig(**dict(TCFG, **tcfg)),
                                **tiny_llama_hf_config(num_hidden_layers=2))


@pytest.mark.parametrize("case", [
    "cp", "attention_dp", "ep", "sequence_parallel", "flash_decoding",
    "moe_degree", "lora", "speculation", "bad_wire"])
def test_a13b_refusals_raise(case):
    """The cp / dp degrees, sequence parallelism and flash decoding run
    since ROADMAP A13c: their spec builds with its field set, and
    ``mesh_from_config`` divides tp_degree by cp·dp·ep as the reference
    does. An MoE degree the mesh does not have, multi-LoRA and
    speculation at tp > 1 (ROADMAP A13d) raise ConfigurationError; a
    wire dtype outside int8 / fp8 is refused at any tp. The ep degree
    runs: an ep that does not divide tp_degree is refused."""
    if case == "ep":
        model_base.spec_from_config(_tiny_config(ep_degree=2), tp_degree=2)
        with pytest.raises(ConfigurationError, match="not divisible"):
            mesh_from_config(TpuConfig(**dict(TCFG, tp_degree=2,
                                              ep_degree=3)))
        return
    over = {"cp": dict(cp_degree=2), "attention_dp":
            dict(attention_dp_degree=2),
            "sequence_parallel": dict(sequence_parallel_enabled=True),
            "flash_decoding": dict(flash_decoding_enabled=True),
            "moe_degree": dict(moe_config=MoEConfig(moe_tp_degree=2)),
            "lora": dict(lora_config=LoraServingConfig(max_loras=2)),
            "speculation": dict(speculation_config=SpeculationConfig(
                speculation_length=3)),
            "bad_wire": dict(collective_config=CollectiveConfig(
                dtype="int4"))}[case]
    runs = {"cp": "cp_prefill", "attention_dp": None,
            "sequence_parallel": "seq_parallel",
            "flash_decoding": "flash_decoding"}
    if case in runs:
        spec = model_base.spec_from_config(
            _tiny_config(tp_degree=4, **over), tp_degree=2)
        if runs[case]:
            assert getattr(spec, runs[case])
        if case in ("cp", "attention_dp"):
            with pytest.raises(ConfigurationError, match="not divisible"):
                mesh_from_config(TpuConfig(**dict(TCFG, tp_degree=4,
                                                  ep_degree=4, **over)))
        return
    with pytest.raises(ConfigurationError,
                       match="A13d" if case in ("lora", "speculation")
                       else None):
        model_base.spec_from_config(_tiny_config(**over), tp_degree=2)


def test_app_refusals_raise():
    """tp_degree > 1 without a mesh and a spec laid out for another degree
    are refused; a rank's own spec holds its heads and MLP columns."""
    with pytest.raises(ConfigurationError, match="mesh="):
        CausalLMApplication(None, _tiny_config(tp_degree=2), device="cpu")
    full = model_base.spec_from_config(_tiny_config(tp_degree=2),
                                       tp_degree=2)
    with pytest.raises(ConfigurationError, match="laid out for tp=2"):
        model_base.local_spec(full, Mesh(None, "gloo", "cpu", 0, 4))
    local = model_base.local_spec(full, Mesh(None, "gloo", "cpu", 1, 2))
    assert (local.gqa.num_q_heads, local.gqa.num_kv_heads,
            local.intermediate_size) == (2, 1, 64)
    assert local.mesh is not None and full.mesh is None


def test_param_specs_cut_the_fused_qkv_by_heads():
    """The fused q/k/v leaf is cut part by part: rank r's slice of the
    global [q | k | v] is [q_r | k_r | v_r], each part the rank's heads,
    not a contiguous chunk of the fused axis."""
    import torch
    from neuronx_distributed_inference_tpu_torch.parallel.layers import \
        shard_tensor
    full = model_base.spec_from_config(_tiny_config(tp_degree=2),
                                       tp_degree=2)
    ps = model_base.decoder_param_specs(full)["layers"]["qkv_proj"]
    q, kv = full.q_size, full.kv_size
    assert (ps.split, ps.parts) == (-1, (q, kv, kv))
    w = torch.arange(q + 2 * kv, dtype=torch.float32)[None, None, :]
    r1 = shard_tensor(w, ps.split, ps.parts, 2, 1)[0, 0].long().tolist()
    want = (list(range(q // 2, q)) + list(range(q + kv // 2, q + kv))
            + list(range(q + kv + kv // 2, q + 2 * kv)))
    assert r1 == want
    assert shard_tensor(w, -1, None, 2, 1)[0, 0].long().tolist() != want


def test_observatory_census_over_a_mesh():
    """``analyze_app`` over a tp-2 rank (a rank's view: building and
    counting need no process group) records each collective of a step:
    the prefill's plain all-reduces (the embedding, then o_proj and
    down_proj a layer) and the logits' all-gathers (two: ``output_logits``
    gathers every column's, the sampler the last one's); the decode step's
    row-parallel sums on the int8 ring, 2 (g - 1) hops of s8 codes and
    f32 scales each, priced at a quarter of fp32 on the wire. Without a
    mesh the census stays None (tests/test_torch_observatory.py)."""
    from neuronx_distributed_inference_tpu_torch.telemetry import \
        observatory
    mesh = Mesh(None, "gloo", "cpu", 0, 2)
    app = CausalLMApplication(None, _tiny_config(
        tp_degree=2, collective_config=CollectiveConfig(dtype="int8")),
        device="cpu", mesh=mesh)
    app.init_random_weights(0).init_cache()
    rep = observatory.analyze_app(app)
    assert rep["mesh"] == {"devices": 2, "axes": {"tp": 2}}
    graphs = {g["kind"]: g for g in rep["graphs"]}
    layers = app.spec.num_layers
    pre = graphs["prefill"]["collectives"]
    assert pre["all_reduce@tp@f32"]["count"] == 1 + 2 * layers
    assert pre["all_gather@tp@f32"]["count"] == 2
    dec = graphs["decode"]["collectives"]
    assert dec["all_reduce@tp@f32"]["count"] == 1
    assert dec["all_gather@tp@f32"]["count"] == 2
    assert dec["collective_permute@tp@s8"]["count"] == 2 * layers * 2
    assert dec["collective_permute@tp@f32"]["count"] == 2 * layers * 2
    roof = graphs["decode"]["roofline"]
    assert roof is None or roof["comm_bytes_saved"] > 0
    assert rep["totals"]["collectives"] == sum(
        g["collective_count"] for g in rep["graphs"])
