"""The dp and cp mesh axes in the port without a world: the rank order
and every rank's leaves against the JAX package's mesh and shards,
``sample_dp`` against the JAX package's, the flash-decoding partials,
the census labels, the config checks and the refusals that wait for
ROADMAP A13d.

Rank order: the JAX mesh reshapes ``jax.devices()`` to (dp, cp, ep, tp),
so device r sits at ``np.unravel_index(r, (dp, cp, ep, tp))``; the port's
rank r of the same mesh takes those coordinates
(``parallel.mesh.rank_coords``, which ``build_mesh`` reads). Leaves: the
JAX app's tree (``init_random_weights`` over its mesh of the 8 virtual
CPU devices) is carried to the port whole, cut by
``model_base.shard_params`` for each rank's view (``Mesh(None, "gloo",
"cpu", mp index, tp, ep=, dp=, cp=, dp_rank=, cp_rank=)``), and each leaf
equals the JAX array's shard on device r: weights are cut over the mp
group (ep x tp) and replicated over dp and cp in both packages. The fused
q/k/v is held to the JAX shards of its q, k and v parts, as
tests/test_torch_expert_parallel.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    OnDeviceSamplingConfig as JSamplingConfig, TpuConfig as JTpuConfig)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.ops import sampling as jsampling
from neuronx_distributed_inference_tpu.parallel.mesh import (
    MeshConfig as JMeshConfig, build_mesh as j_build_mesh,
    mesh_from_config as j_mesh_from_config)
from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, OnDeviceSamplingConfig, SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import attention as attn
from neuronx_distributed_inference_tpu_torch.ops import sampling
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, rank_coords)
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.engine import \
    ServingEngine
from neuronx_distributed_inference_tpu_torch.serving.engine.frontend \
    import ServingFrontend
from neuronx_distributed_inference_tpu_torch.serving.fleet.handoff import \
    capture_handoff
from neuronx_distributed_inference_tpu_torch.telemetry import observatory
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

from conftest import tiny_llama_hf_config

TCFG = dict(batch_size=2, seq_len=64, dtype="float32",
            enable_bucketing=False)
# (dp, cp, ep, tp)
MESHES = [(2, 1, 1, 2), (1, 2, 1, 2), (2, 2, 1, 2), (2, 1, 2, 1)]
HF = tiny_llama_hf_config(num_hidden_layers=2)


def _degrees(dp, cp, ep, tp):
    return dict(tp_degree=dp * cp * ep * tp, cp_degree=cp,
                attention_dp_degree=dp, ep_degree=ep)


def _view(cfg: MeshConfig, index: int) -> Mesh:
    """Rank ``index``'s view of the mesh, no process group."""
    dp_i, cp_i, ep_i, tp_i = rank_coords(cfg, index)
    return Mesh(None, "gloo", "cpu", ep_i * cfg.tp + tp_i, cfg.tp,
                ep=cfg.ep, dp=cfg.dp, cp=cfg.cp, dp_rank=dp_i,
                cp_rank=cp_i)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _shard_on(arr, dev):
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_rank_order_and_leaves_equal_the_jax_mesh(shape):
    """Rank r's (dp, cp, ep, tp) coordinates are those of the JAX mesh's
    device r, its view's ``index`` is r, and each of its leaves of tiny
    Llama equals the JAX shard on device r."""
    dp, cp, ep, tp = shape
    cfg = MeshConfig(dp=dp, cp=cp, ep=ep, tp=tp)
    jmesh = j_build_mesh(JMeshConfig(dp=dp, cp=cp, ep=ep, tp=tp))
    devs = jmesh.devices
    for r, dev in enumerate(jax.devices()[:cfg.world_size]):
        want = tuple(int(i) for i in np.argwhere(devs == dev)[0])
        assert rank_coords(cfg, r) == want
        assert _view(cfg, r).index == r

    tcfg = JTpuConfig(**TCFG, **_degrees(*shape))
    japp = JApp(None, JLlamaConfig(tcfg, **HF), JLlamaFamily,
                mesh=j_mesh_from_config(tcfg))
    assert tuple(japp.mesh.devices.shape) == shape
    jtree = japp.init_random_weights(0).params
    full = params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    jflat = dict(_flat(jtree))
    pcfg = LlamaInferenceConfig(TpuConfig(**TCFG, **_degrees(*shape)), **HF)
    spec = LlamaFamily.build_spec(pcfg, tp_degree=ep * tp)
    for r, dev in enumerate(japp.mesh.devices.flat):
        mesh = _view(cfg, r)
        got = dict(_flat(model_base.shard_params(spec, full, mesh)))
        assert set(got) == set(jflat)
        for name, leaf in got.items():
            arr = jflat[name]
            if name.rsplit(".", 1)[-1] == "qkv_proj":
                cuts = np.cumsum([spec.q_size, spec.kv_size])
                want = np.concatenate([_shard_on(jax.device_put(
                    part, arr.sharding), dev) for part in np.split(
                        np.asarray(arr), cuts, axis=-1)], axis=-1)
            else:
                want = _shard_on(arr, dev)
            np.testing.assert_array_equal(leaf.numpy(), want,
                                          err_msg=f"{name} on rank {r}")


SAMPLING = {
    "greedy": (dict(do_sample=False), None),
    "config": (dict(do_sample=True, top_k=8, top_p=0.9, temperature=1.3),
               None),
    "per_row": (dict(do_sample=True, top_k=16),
                np.array([[4, 0.8, 0.7], [8, 1.0, 1.0], [1, 1.0, 1.0],
                          [32, 0.5, 2.0]], np.float32)),
    "deterministic": (dict(do_sample=True, top_k=4, deterministic=True),
                      None),
}


@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_sample_dp_matches_jax(case):
    """Keyed ``sample_dp`` at dp 2: each replica samples its rows with
    the key folded with its index; the replicas' tokens, in order, equal
    the JAX ``sample_dp`` on the same logits and key (mesh dp 2 x tp 4),
    and with one replica the keyed draw equals the JAX ``sample``: greedy,
    the config's params, per-row params and the deterministic argmax."""
    knobs, sp = SAMPLING[case]
    lg = (np.random.default_rng(0).normal(size=(4, 96)) * 3).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jmesh = j_build_mesh(JMeshConfig(dp=2, tp=4))
    jsp = None if sp is None else jnp.asarray(sp)
    want = np.asarray(jsampling.sample_dp(jnp.asarray(lg),
                                          JSamplingConfig(**knobs), jsp,
                                          key, mesh=jmesh))
    cfg = OnDeviceSamplingConfig(**knobs)
    tsp = None if sp is None else torch.from_numpy(sp)
    got = np.concatenate([sampling.sample_replica(
        torch.from_numpy(lg[2 * i:2 * i + 2]), cfg,
        None if tsp is None else tsp[2 * i:2 * i + 2], np.asarray(key), i)
        .numpy() for i in range(2)])
    np.testing.assert_array_equal(got, want)
    one = sampling.sample_dp(torch.from_numpy(lg), cfg, tsp,
                             np.asarray(key), mesh=None)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jsampling.sample(
        jnp.asarray(lg), JSamplingConfig(**knobs), jsp, key)))


def test_replica_generators_draw_their_own_noise():
    """Unseeded draws come from each replica's ``torch.Generator``
    (a deliberate difference from the JAX keys): replica 0 keeps the
    config's seed, replica 1 draws other noise."""
    assert sampling.sampling_seed(7, 0) == 7
    assert sampling.sampling_seed(7, 1) != 7
    draws = [torch.rand(8, generator=torch.Generator().manual_seed(
        sampling.sampling_seed(7, i))) for i in range(2)]
    assert not torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("case", ["sink", "window_softcap",
                                  "dead_shard"])
def test_flash_decoding_partials_merge_to_the_whole(case):
    """Each cp shard's partial softmax (``attention.mha_hl_partial`` over
    its slots) merged by log-sum-exp, the sink added once, equals
    ``mha_hl`` over every slot; a shard with no live key (a short row
    whose slots all sit on the first shard) adds nothing and no NaN."""
    g = torch.Generator().manual_seed(1)
    b, t, hq, hkv, d, s, cp = 2, 1, 4, 2, 16, 24, 3
    q = torch.randn((b, t, hq, d), generator=g)
    k = torch.randn((b, hkv, d, s), generator=g)
    v = torch.randn((b, hkv, s, d), generator=g)
    pos = torch.tensor([[20], [5]])
    window, cap, sink = 0, None, None
    if case == "sink":
        sink = torch.randn((hq,), generator=g)
    elif case == "window_softcap":
        window, cap = 6, 4.0
    else:
        pos = torch.tensor([[3], [5]])
    want = attn.mha_hl(q, k, v, attn.decode_mask(pos, s, window), 0.25,
                       logits_soft_cap=cap, sink=sink)
    n = s // cp
    parts = [attn.mha_hl_partial(
        q, k[..., i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], attn.
        decode_mask(pos, n, window, offset=i * n), 0.25,
        logits_soft_cap=cap) for i in range(cp)]
    big = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    if sink is not None:
        big = torch.maximum(big, sink)
    o = sum(p[0] * torch.exp(p[1] - big)[..., None] for p in parts)
    den = sum(p[2] * torch.exp(p[1] - big) for p in parts)
    if sink is not None:
        den = den + torch.exp(sink - big)
    got = o / den[..., None]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_census_labels_the_dp_and_cp_axes():
    """The observatory's labels over the four axes (rank r = ((dp_rank·cp
    + cp_rank)·ep + ep_rank)·tp + tp_rank) and the census's axis of each
    heard collective: the replica's mp group, dp or cp."""
    m = _view(MeshConfig(dp=2, cp=2, tp=2), 0)
    labels = observatory.mesh_comm_labels(m)
    sig = lambda *rows: frozenset(frozenset(r) for r in rows)  # noqa: E731
    assert labels[sig({0, 1}, {2, 3}, {4, 5}, {6, 7})] == "tp"
    assert labels[sig({0, 4}, {1, 5}, {2, 6}, {3, 7})] == "dp"
    assert labels[sig({0, 2}, {1, 3}, {4, 6}, {5, 7})] == "cp"
    heard = [{"kind": "all_gather", "group_size": 2, "elems": 8,
              "elem_bytes": 4, "dtype": "float32", "axis": axis}
             for axis in ("mp", "dp", "cp")]
    assert [e["comm"] for e in observatory.census_collectives(heard, m)] \
        == ["tp", "dp", "cp"]


def test_config_checks_match_the_reference():
    """JAX config.py:410-431: cp and dp divide tp_degree, dp divides
    tkg_batch_size, mlp_cp_degree needs SP at cp_degree; both packages
    raise ValueError alike. The cp and dp knobs build a spec now:
    ``cp_prefill`` at cp > 1, ``seq_parallel`` and ``flash_decoding``
    from their switches."""
    bad = [dict(tp_degree=4, attention_dp_degree=2, batch_size=3),
           dict(tp_degree=4, cp_degree=3), dict(tp_degree=6,
                                                attention_dp_degree=4),
           dict(tp_degree=4, cp_degree=2, mlp_cp_degree=2),
           dict(tp_degree=4, cp_degree=2, mlp_cp_degree=4,
                sequence_parallel_enabled=True)]
    for over in bad:
        kw = dict(dict(TCFG, **over))
        with pytest.raises(ValueError):
            JTpuConfig(**kw)
        with pytest.raises(ValueError):
            TpuConfig(**kw)
    tcfg = TpuConfig(**TCFG, tp_degree=8, cp_degree=2, attention_dp_degree=2,
                     sequence_parallel_enabled=True, mlp_cp_degree=2,
                     flash_decoding_enabled=True)
    spec = model_base.spec_from_config(LlamaInferenceConfig(tcfg, **HF),
                                       tp_degree=2)
    assert spec.cp_prefill and spec.seq_parallel and spec.flash_decoding


def _dp_app(cls=PagedCausalLMApplication, **over):
    """A rank's view of dp 2 x tp 1 (two ranks: a mesh of more than one
    rank, whose model-parallel group has one)."""
    tcfg = TpuConfig(**dict(dict(TCFG, batch_size=4, tp_degree=2,
                                 attention_dp_degree=2,
                                 is_block_kv_layout=cls is not
                                 CausalLMApplication, pa_block_size=16),
                            **over))
    mesh = Mesh(None, "gloo", "cpu", 0, 1, dp=2, dp_rank=1)
    return cls(None, LlamaInferenceConfig(tcfg, **HF), device="cpu",
               mesh=mesh)


@pytest.mark.parametrize("case", ["lora", "speculation", "pipeline",
                                  "spill_tier", "frontend", "handoff",
                                  "save_quantized"])
def test_a13d_refusals_raise(case):
    """What the port does not serve over a mesh of more than one rank
    raises ConfigurationError naming ROADMAP A13d, at dp 2 x tp 1 as at
    tp > 1: multi-LoRA, speculation, the pipelined adapter, the spill
    tier, the HTTP front door, the handoff and saving a rank's quantized
    tree."""
    spec_cases = {"lora": dict(lora_config=LoraServingConfig(max_loras=2)),
                  "speculation": dict(speculation_config=SpeculationConfig(
                      speculation_length=3))}
    if case in spec_cases:
        with pytest.raises(ConfigurationError, match="A13d"):
            _dp_app(**spec_cases[case])
        return
    app = _dp_app(**({"quantized": True} if case == "save_quantized"
                     else {}))
    app.init_random_weights(0).init_cache()
    assert app.mesh.size == 2 and app.mesh.mp == 1
    with pytest.raises(ConfigurationError, match="A13d"):
        if case == "pipeline":
            PagedEngineAdapter(app, pipeline_depth=1)
        elif case == "spill_tier":
            PagedEngineAdapter(app, kv_spill_tier=object())
        elif case == "frontend":
            ServingFrontend(ServingEngine(PagedEngineAdapter(app)))
        elif case == "handoff":
            capture_handoff(PagedEngineAdapter(app), 0)
        else:
            app.save_quantized_state_dict("/nonexistent")


def test_rank_cache_holds_its_rows_and_slots():
    """The contiguous cache of a rank holds B/dp rows (``P(dp)`` on the
    batch) and, under flash decoding over cp, S/cp slots; the paged cache
    is the same on every replica (the block cache has no dp axis)."""
    app = _dp_app(CausalLMApplication).init_random_weights(0).init_cache()
    assert tuple(app.cache["k"].shape[:2]) == (2, 2)
    assert app.cache["k"].shape[4] == TCFG["seq_len"]
    tcfg = TpuConfig(**dict(TCFG, tp_degree=4, cp_degree=2,
                            flash_decoding_enabled=True))
    mesh = Mesh(None, "gloo", "cpu", 1, 2, cp=2, cp_rank=1)
    fd = CausalLMApplication(None, LlamaInferenceConfig(tcfg, **HF),
                             device="cpu", mesh=mesh)
    fd.init_random_weights(0).init_cache()
    assert fd.cache["v"].shape[3] == TCFG["seq_len"] // 2
    assert fd.cache["k"].shape[1] == TCFG["batch_size"]
    paged = _dp_app().init_random_weights(0).init_cache()
    assert paged.cache["k"].shape[1] == paged.tpu_config.pa_num_blocks + 1
    assert "dp=2" in repr(app.mesh) and app.mesh.dp_rank == 1
