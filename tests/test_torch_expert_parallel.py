"""Expert parallelism in the port without a world: every leaf a rank
keeps against the JAX package's shard on the same device, the refusals
that wait for ROADMAP A13d, and the quantized hybrid layout's warning.

Layout: for every MoE family of the port, at tp_degree 2, at tp_degree 4
with ep_degree 2, and at tp_degree 4 with ep_degree 2 and
``moe_tkg_ep_degree=1``, the JAX app's tree (``init_random_weights`` over
its mesh of the 8 virtual CPU devices, quantized where the case says) is
carried to the port whole, cut by ``model_base.shard_params`` for each
rank r (a rank's view: ``Mesh(None, "gloo", "cpu", r, tp, ep=ep)``), and
each leaf of rank r must equal the JAX array's shard on device r (the
JAX mesh reshapes ``jax.devices()`` to (dp, cp, ep, tp), so device r is
the port's rank r). The hybrid decode copy (``expert_*_tkg``) is held to
the JAX decode layout's constraint (moe.py:326-333: every expert, the
intermediate over ("tp", "ep")). The fused q/k/v (and its bias) is cut
by heads in the port and by contiguous columns in the JAX package: it is
held to the JAX shards of its q, k and v parts, each placed with the
fused leaf's own sharding. The untied head's bias (Phi-3.5-MoE) stays
whole on every rank of the port, added after the logits are gathered:
it is held to the whole JAX leaf. The JAX package keeps a blockwise
(MXFP4) scale's contraction axis whole on every device and lets GSPMD
slice it where the product needs it; a rank of the port keeps the blocks
its codes cover, so that scale is held to those rows of the JAX shard.
"""

import logging

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.parallel.mesh import \
    mesh_from_config as j_mesh_from_config
from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, MoEConfig, MoETpuConfig, SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, build_mesh, mesh_from_config)
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.serving.adapter import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.telemetry import metrics
from neuronx_distributed_inference_tpu_torch.telemetry.registry import \
    MetricsRegistry
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

from test_torch_contrib_moe import VARIANTS as CONTRIB
from test_torch_dbrx import TINY as DBRX
from test_torch_deepseek import CONFIGS as DEEPSEEK
from test_torch_gpt_oss import HF_CONFIG as GPT_OSS
from test_torch_llama4 import TINY as LLAMA4
from test_torch_moe_families import QWEN3_MOE

MIXTRAL = dict(model_type="mixtral", hidden_size=64, intermediate_size=32,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=256, num_local_experts=4,
               num_experts_per_tok=2, rms_norm_eps=1e-5,
               sliding_window=None)
# every MoE family of the port at tiny widths (4 or 8 experts, expert
# intermediates that split over tp 2)
FAMILIES = {
    "qwen3_moe": QWEN3_MOE,
    "mixtral": MIXTRAL,
    "gpt_oss": dict(GPT_OSS, intermediate_size=64, head_dim=16),
    "deepseek_v3": dict(DEEPSEEK["qlora_mixed"][1],
                        model_type="deepseek_v3"),
    "llama4_text": dict(LLAMA4, model_type="llama4_text"),
    "dbrx": dict(DBRX, model_type="dbrx"),
    **{name: dict(CONTRIB[name][2], model_type=CONTRIB[name][1])
       for name in ("granitemoe", "olmoe", "glm4_moe", "dots1", "phimoe")},
}
# MXFP4 at ep 2 x tp 2: o_proj's 128 rows cut on a 32-channel block edge
QUANT_HF = dict(FAMILIES, gpt_oss_d32=dict(FAMILIES["gpt_oss"], head_dim=32))
# (tp_degree, ep_degree, moe_tkg_ep_degree)
MESHES = {"tp2": (2, 1, None), "ep2_tp2": (4, 2, None),
          "ep2_tp2_hybrid": (4, 2, 1)}
QUANT = {"int8": ("qwen3_moe", dict(quantization_dtype="int8")),
         "fp8": ("mixtral", dict(quantization_dtype="f8e4m3")),
         "mxfp4": ("gpt_oss_d32", dict(quantization_dtype="mxfp4"))}
TCFG = dict(batch_size=2, seq_len=64, dtype="float32",
            enable_bucketing=False)
# the JAX decode layout of the hybrid copy (moe.py:326-333)
HYBRID = {"expert_gate": P(None, None, None, ("tp", "ep")),
          "expert_up": P(None, None, None, ("tp", "ep")),
          "expert_down": P(None, None, ("tp", "ep"), None),
          "expert_gate_bias": P(None, None, ("tp", "ep")),
          "expert_up_bias": P(None, None, ("tp", "ep")),
          "expert_down_bias": P()}


def _tcfg(cls, tp, ep, tkg, **over):
    mc = MoEConfig(moe_tkg_ep_degree=tkg) if tkg is not None else None
    return cls(**dict(TCFG, tp_degree=tp, ep_degree=ep, moe_config=mc,
                      **over))


def _jax_tree(hf, tp, ep, tkg, **over):
    tcfg = _tcfg(JTpuConfig, tp, ep, tkg, **over)
    jfam = j_get_family(hf["model_type"])
    app = JApp(None, jfam.config_cls(tcfg, **hf), jfam,
               mesh=j_mesh_from_config(tcfg))
    return app.init_random_weights(0).params, app.mesh


def _port_spec(hf, tp, ep, tkg, **over):
    fam = get_family(hf["model_type"])
    return fam.build_spec(fam.config_cls(_tcfg(TpuConfig, tp, ep, tkg,
                                               **over), **hf), tp_degree=tp)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _shard_on(arr, dev):
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


def _check_layout(hf, tp, ep, tkg, **over):
    jtree, jmesh = _jax_tree(hf, tp, ep, tkg, **over)
    full = jax.tree.map(np.asarray, jtree)
    spec = _port_spec(hf, tp, ep, tkg, **over)
    devices = list(jmesh.devices.flat)
    ttree = params_from_numpy(full, device="cpu")
    jflat = dict(_flat(jtree))
    pspecs = model_base.decoder_param_specs(spec)
    n_tkg = 0
    for r, dev in enumerate(devices):
        mesh = Mesh(None, "gloo", "cpu", r, tp // ep, ep=ep)
        got = dict(_flat(model_base.shard_params(spec, ttree, mesh)))
        for name, leaf in got.items():
            base = name[:-len(tmoe.TKG)] if name.endswith(tmoe.TKG) \
                else name
            if base != name:
                n_tkg += 1
                leaf_name = base.rsplit(".", 1)[1]
                want = _shard_on(jax.device_put(
                    jflat[base], NamedSharding(jmesh, HYBRID[leaf_name])),
                    dev)
            elif name.rsplit(".", 1)[-1] in ("qkv_proj", "qkv_bias"):
                arr = jflat[name]
                cuts = np.cumsum([spec.q_size, spec.kv_size])
                want = np.concatenate([_shard_on(jax.device_put(
                    part, arr.sharding), dev) for part in np.split(
                        np.asarray(arr), cuts, axis=-1)], axis=-1)
            elif name == "lm_head_b":
                want = np.asarray(jflat[name])
            else:
                want = _shard_on(jflat[name], dev)
            got_np = leaf.float().numpy() if leaf.dtype.is_floating_point \
                and leaf.dtype != leaf.float().dtype else leaf.numpy()
            if want.dtype.name in ("bfloat16", "float8_e4m3fn"):
                want = want.astype(np.float32)
                got_np = leaf.float().numpy()
            if name.endswith("scale") and got_np.shape != want.shape:
                # a blockwise scale: the rows the rank's codes cover, at
                # the rank's index on the weight's contraction cut
                group, leaf_name = name.split(".")[:2]
                ps = pspecs[group][leaf_name]
                axis_name = next(a for ax, a in ps.cuts if ax == -2)
                i = mesh.cut(axis_name)[1]
                rows = got_np.shape[-2]
                want = want[..., i * rows:(i + 1) * rows, :]
            assert got_np.shape == want.shape, (name, r, got_np.shape,
                                                want.shape)
            np.testing.assert_array_equal(got_np, want, err_msg=f"{name} "
                                          f"on rank {r}")
    return n_tkg


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rank_leaves_equal_the_jax_shards(family, mesh):
    """Every leaf of every rank equals the JAX package's shard on the
    same device; the hybrid layout's copies equal the JAX decode
    layout's, one copy a rank for each expert leaf of each MoE stack."""
    tp, ep, tkg = MESHES[mesh]
    n_tkg = _check_layout(FAMILIES[family], tp, ep, tkg)
    assert (n_tkg > 0) == (tkg is not None)


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_quantized_rank_leaves_equal_the_jax_shards(quant):
    """int8 and fp8 codes with their (L, E, 1, ·) scales and gpt-oss's
    MXFP4 blocks, cut over ep 2 x tp 2: each rank's codes equal the JAX
    shard; a per-channel scale keeps its contraction slot whole (extent
    1), a block scale is cut on a block edge. The quantized hybrid
    layout makes no copy (the stored layout is kept)."""
    family, over = QUANT[quant]
    assert _check_layout(QUANT_HF[family], 4, 2, 1, quantized=True,
                         **over) == 0


def _rank_app(tp, ep, **over):
    tcfg = TpuConfig(**dict(TCFG, tp_degree=tp * ep, ep_degree=ep,
                            is_block_kv_layout=True, pa_block_size=16,
                            **over))
    fam = get_family("qwen3_moe")
    return PagedCausalLMApplication(None, fam.config_cls(tcfg, **QWEN3_MOE),
                                    fam, device="cpu",
                                    mesh=Mesh(None, "gloo", "cpu", 1, tp,
                                              ep=ep))


def test_rank_spec_and_mesh_axes():
    """A rank's view at ep 2 x tp 2 (rank 1: ep index 0, tp index 1):
    heads and the vocabulary cut over all four ranks, experts 0-1 of 4
    with half the intermediate, the hybrid copy's index tp_rank·ep +
    ep_rank (2 for rank 1, not the rank); ``mesh_from_config`` divides
    tp_degree by ep_degree."""
    app = _rank_app(2, 2, moe_config=MoEConfig(moe_tkg_ep_degree=1))
    app.init_random_weights(0)
    m = app.mesh
    assert (m.mp, m.ep_rank, m.tp_rank, m.cut("tp_ep")) == (4, 0, 1, (4, 2))
    lw = app.params["layers"]
    assert tuple(lw["expert_gate"].shape) == (2, 2, 64, 24)
    assert tuple(lw["expert_gate_tkg"].shape) == (2, 4, 64, 12)
    assert tuple(lw["expert_down_tkg"].shape) == (2, 4, 12, 64)
    assert app.spec.gqa.num_q_heads == 1 and app.spec.moe.tkg_experts_local
    assert tuple(app.params["embed"].shape) == (128, 64)
    with pytest.raises(ConfigurationError, match="not divisible"):
        mesh_from_config(TpuConfig(tp_degree=4, ep_degree=3))


@pytest.mark.parametrize("case", [
    "cp", "attention_dp", "sequence_parallel", "flash_decoding",
    "sample_dp", "moe_ep_mismatch", "moe_cte_degree", "lora",
    "speculation", "pipeline", "spill_tier", "save_quantized"])
def test_a13c_refusals_raise(case):
    """The cp and attention-dp degrees (and with them ``sample_dp``),
    sequence parallelism and flash decoding run since ROADMAP A13c: an
    ep 2 x tp 2 rank's app builds with its spec's field set. What waits
    for ROADMAP A13d raises ConfigurationError naming it: multi-LoRA,
    speculation, the pipelined adapter, the spill tier and saving a
    rank's quantized tree; an MoE degree the mesh does not have is
    refused as such, a CTE / TKG expert degree in the reference's own
    words."""
    cfg = {"cp": dict(cp_degree=2), "attention_dp":
           dict(attention_dp_degree=2),
           "sample_dp": dict(attention_dp_degree=2),
           "sequence_parallel": dict(sequence_parallel_enabled=True),
           "flash_decoding": dict(flash_decoding_enabled=True),
           "moe_ep_mismatch": dict(moe_config=MoEConfig(moe_ep_degree=4)),
           "moe_cte_degree": dict(moe_config=MoEConfig(moe_cte_ep_degree=2)),
           "lora": dict(lora_config=LoraServingConfig(max_loras=2)),
           "speculation": dict(speculation_config=SpeculationConfig(
               speculation_length=3))}.get(case)
    runs = {"cp": "cp_prefill", "attention_dp": None, "sample_dp": None,
            "sequence_parallel": "seq_parallel",
            "flash_decoding": "flash_decoding"}
    if case in runs:
        app = _rank_app(2, 2, **cfg)
        if runs[case]:
            assert getattr(app.spec, runs[case])
        return
    if cfg is not None:
        match = {"moe_cte_degree": "mesh fixes",
                 "moe_ep_mismatch": "on a mesh of"}.get(case, "A13d")
        with pytest.raises(ConfigurationError, match=match):
            _rank_app(2, 2, **cfg)
        return
    app = _rank_app(2, 2, **({"quantized": True}
                             if case == "save_quantized" else {}))
    app.init_random_weights(0).init_cache()
    with pytest.raises(ConfigurationError, match="A13d"):
        if case == "pipeline":
            PagedEngineAdapter(app, pipeline_depth=1)
        elif case == "spill_tier":
            PagedEngineAdapter(app, kv_spill_tier=object())
        else:
            app.save_quantized_state_dict("/nonexistent")


def test_quantized_hybrid_warns_and_counts(caplog):
    """``moe_tkg_ep_degree=1`` over quantized experts keeps the stored
    layout: the reference's warning, and with telemetry on the degraded
    counter (tests/test_moe.py:217-260); fp experts neither warn nor
    count. ``MoETpuConfig`` always carries an MoEConfig."""
    from neuronx_distributed_inference_tpu_torch import telemetry
    assert MoETpuConfig(batch_size=1).moe_config == MoEConfig()
    reg = MetricsRegistry()
    telemetry.set_registry(reg)
    try:
        with caplog.at_level(logging.WARNING, logger="nxdi_torch"):
            _port_spec(MIXTRAL, 2, 1, 1)
            assert not [r for r in caplog.records
                        if "tkg_experts_local" in r.getMessage()]
            spec = _port_spec(MIXTRAL, 2, 1, 1, quantized=True)
    finally:
        telemetry.disable()
    assert spec.moe.tkg_experts_local
    assert any("quantized" in r.getMessage().lower()
               and "tkg_experts_local" in r.getMessage()
               for r in caplog.records)
    assert reg.get(metrics.MOE_TKG_LOCAL_QUANT_DEGRADED_TOTAL).get() == 1


def test_observatory_census_over_an_ep_mesh():
    """``analyze_app`` over rank 1 of an ep 2 x tp 2 mesh (a rank's view,
    no process group): the axes are ep and tp, every collective rides
    the whole group ("ep+tp"), and a step of the all-MoE Qwen3-MoE makes
    the embedding's all-reduce, then o_proj's and the MoE block's a
    layer, plain fp32 (the MoE sum never takes the quantized ring), and
    the logits' gathers. The prefill grid (2 x 32) stays on the dense
    expert path: the fake ``_grouped_mm`` takes bf16 only."""
    from neuronx_distributed_inference_tpu_torch.config import \
        CollectiveConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.telemetry import \
        observatory
    mesh = Mesh(None, "gloo", "cpu", 1, 2, ep=2)
    assert observatory.mesh_comm_labels(mesh) == {
        frozenset({frozenset({0, 1}), frozenset({2, 3})}): "tp",
        frozenset({frozenset({0, 2}), frozenset({1, 3})}): "ep",
        frozenset({frozenset({0, 1, 2, 3})}): "ep+tp"}
    fam = get_family("qwen3_moe")
    app = CausalLMApplication(None, fam.config_cls(TpuConfig(
        **dict(TCFG, seq_len=32, output_logits=True, tp_degree=4,
               ep_degree=2,
               collective_config=CollectiveConfig(dtype="int8"))),
        **QWEN3_MOE), fam, device="cpu", mesh=mesh)
    app.init_random_weights(0).init_cache()
    rep = observatory.analyze_app(app)
    assert rep["mesh"] == {"devices": 4, "axes": {"ep": 2, "tp": 2}}
    graphs = {g["kind"]: g for g in rep["graphs"]}
    layers = app.spec.num_layers
    pre = graphs["prefill"]["collectives"]
    assert pre["all_reduce@ep+tp@f32"]["count"] == 1 + 2 * layers
    assert pre["all_gather@ep+tp@f32"]["count"] == 2
    dec = graphs["decode"]["collectives"]
    # the embedding's and each layer's MoE sum plain; o_proj on the ring
    assert dec["all_reduce@ep+tp@f32"]["count"] == 1 + layers
    assert dec["collective_permute@ep+tp@s8"]["count"] == 2 * layers * 3
