"""The dp and cp mesh axes of the port on the CPU: ranks spawned over
gloo (``parallel.mesh.spawn_world``; one world of 8 and one of 4, each
torn down by ``spawn_world`` whatever happens), each model held to the
JAX package at the same mesh on its 8 virtual CPU devices, from the same
HF checkpoint, and to the port at tp 1:

* world 8, the reference's four meshes (tests/test_parallelism.py:67-101):
  tp 8; tp 8 with cp 2 and SP; tp 8 with cp 2 and flash decoding; tp 8
  with cp 2, dp 2, SP and flash decoding. Tiny Llama's (2 layers)
  contiguous ``generate`` of prompts (2, 12) for 6 tokens: tokens
  identical to the JAX package and to the port at tp 1, fp32 logits
  within atol 2e-3 / rtol 1e-3.
* world 8, the kernels' gates: at head_dim 64 with ``attn_kernel_enabled``
  the flash and contiguous-decode kernels' plain twins (their CPU route)
  run on each dp replica's B/2 rows at ``tp_degree=4,
  attention_dp_degree=2``; under cp prefill, SP and flash decoding none
  runs (the reference's gates). Tokens equal tp 1.
* world 8, MoE at dp: tiny Qwen3-MoE at ``tp_degree=4,
  attention_dp_degree=2, ep_degree=2`` (tp 1) gives the JAX package's
  tokens at that mesh.
* world 8, continuous batching at dp 2 x tp 1: a row runs on the replica
  that holds its cache row, so steps run on one replica, on both, or
  unevenly; the streams equal the port's at tp 1.
* world 4, serving at ``tp_degree=4, attention_dp_degree=2``: the paged
  adapter's scenario of tests/test_serving_mesh.py:40-78 in both of its
  modes, and the ragged ``ServingEngine`` over two waves: the second
  wave's four rows, two on each replica, hit the prefix blocks that wave
  1's first row wrote on replica 0 (a copy whose replicas write only
  their own rows' K/V parts these streams): streams identical to the JAX
  package's at the same mesh and to tp 1.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import (
    CausalLMApplication as JApp, PagedCausalLMApplication as JPagedApp)
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.parallel.mesh import \
    mesh_from_config as j_mesh_from_config
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu.serving.engine import \
    ServingEngine as JServingEngine
from neuronx_distributed_inference_tpu_torch.parallel.mesh import \
    spawn_world

import torch_dcp_ranks
from conftest import tiny_llama_hf_config
from test_torch_dense_families import _transformers

TOL = dict(atol=2e-3, rtol=1e-3)
N_NEW = 6
BASE = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True,
            enable_bucketing=False)
# the reference's four meshes (tests/test_parallelism.py:67-101)
MESHES = {
    "tp8": dict(tp_degree=8),
    "tp8_cp2_sp": dict(tp_degree=8, cp_degree=2,
                       sequence_parallel_enabled=True),
    "tp8_cp2_flash_decoding": dict(tp_degree=8, cp_degree=2,
                                   flash_decoding_enabled=True),
    "tp8_cp2_dp2_sp_fd": dict(tp_degree=8, cp_degree=2,
                              attention_dp_degree=2,
                              sequence_parallel_enabled=True,
                              flash_decoding_enabled=True),
}
KERNELS = dict(BASE, seq_len=128, attn_kernel_enabled=True)
GATES = {"tp1": dict(tp_degree=1), "dp2": dict(tp_degree=4,
                                               attention_dp_degree=2),
         "cp_dp_sp_fd": MESHES["tp8_cp2_dp2_sp_fd"]}
MOE = dict(BASE, tp_degree=4, attention_dp_degree=2, ep_degree=2,
           model_type="qwen3_moe")
CB = dict(batch_size=4, seq_len=128, dtype="float32",
          context_encoding_buckets=[16, 32], is_continuous_batching=True)
PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             enable_bucketing=True, context_encoding_buckets=[16],
             is_block_kv_layout=True, pa_block_size=8,
             is_prefix_caching=True)
ENGINE = dict(batch_size=4, seq_len=128, dtype="float32",
              is_block_kv_layout=True, pa_block_size=8,
              is_prefix_caching=True, is_chunked_prefill=True)
DP2 = dict(tp_degree=4, attention_dp_degree=2)
# the world-8 cases in order: tp 1, the four meshes, the gates, MoE
GATES_AT = 1 + len(MESHES)
MOE_AT = GATES_AT + len(GATES)


def _save(tmp_path_factory, name, model):
    d = tmp_path_factory.mktemp(name)
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tf = _transformers()
    torch.manual_seed(0)
    llama = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        num_hidden_layers=2)))
    torch.manual_seed(0)
    hd64 = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        hidden_size=256, intermediate_size=512, num_hidden_layers=2)))
    torch.manual_seed(0)
    # drawn at 0.25: at HF's 0.02 a tiny model's greedy tokens barely
    # read the context, and pages a replica never wrote would go unseen
    serve = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        num_hidden_layers=2, initializer_range=0.25)))
    torch.manual_seed(0)
    qwen = tf.Qwen3MoeForCausalLM(tf.Qwen3MoeConfig(
        hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, vocab_size=256, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=True, rms_norm_eps=1e-5, decoder_sparse_step=1,
        mlp_only_layers=[], max_position_embeddings=128,
        torch_dtype="float32", tie_word_embeddings=False))
    return {name: _save(tmp_path_factory, name, m.eval()) for name, m in (
        ("llama", llama), ("hd64", hd64), ("serve", serve),
        ("qwen3_moe", qwen))}


def _prompts(seed=3, high=500):
    return np.random.default_rng(seed).integers(
        1, high, size=(2, 12)).astype(np.int32)


def _cb_prompts():
    rng = np.random.default_rng(0)
    return (rng.integers(1, 500, size=9).tolist(),
            rng.integers(1, 500, size=12).tolist())


@pytest.fixture(scope="module")
def world8(ckpts, tmp_path_factory):
    """[0]: per rank (the contiguous results on rank 0, every rank's twin
    calls); [1]: the continuous-batching streams (rank 0)."""
    ck = ckpts
    cases = ([(ck["llama"], dict(BASE, tp_degree=1))]
             + [(ck["llama"], dict(BASE, **m)) for m in MESHES.values()]
             + [(ck["hd64"], dict(KERNELS, **g)) for g in GATES.values()]
             + [(ck["qwen3_moe"], MOE)])
    res = spawn_world(
        torch_dcp_ranks.world8_cases, 8, "gloo", "cpu",
        str(tmp_path_factory.mktemp("dcp_world8")), 150.0,
        (cases, _prompts(), _prompts(5, 250), N_NEW, ck["llama"],
         [dict(CB, tp_degree=1), dict(CB, tp_degree=2,
                                      attention_dp_degree=2)],
         _cb_prompts()))
    return res


def _jax_generate(ckpt, model_type, over, prompts):
    tcfg = JTpuConfig(**{k: v for k, v in over.items()
                         if k != "model_type"})
    fam = j_get_family(model_type)
    app = JApp(ckpt, fam.config_cls(tcfg, load_config=j_load_config(ckpt)),
               fam, mesh=j_mesh_from_config(tcfg))
    r = app.load_weights().init_cache().generate(
        prompts, max_new_tokens=N_NEW, return_logits=True)
    return np.asarray(r["generated"]), [np.asarray(x) for x in r["logits"]]


def _same(got, want, logits=True):
    np.testing.assert_array_equal(got[0], want[0])
    if logits:
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_reference_meshes_match_jax_and_tp1(ckpts, world8, mesh):
    """The contiguous app at the reference's four meshes: tokens equal
    the JAX package's at the same mesh and the port's at tp 1, logits
    within the suite's tolerance of both."""
    outs = world8[0][0]
    i = 1 + list(MESHES).index(mesh)
    got = outs[i]
    _same(got, outs[0])
    _same(got, _jax_generate(ckpts["llama"], "llama",
                             dict(BASE, **MESHES[mesh]), _prompts()))


def _calls(world8, case):
    return [r[1].get(case) for r in world8 if r[1].get(case) is not None]


def test_kernel_gates_at_dp_and_cp(world8):
    """At head_dim 64 with ``attn_kernel_enabled``: at dp 2 x tp 2 every
    rank runs the flash prefill and the contiguous decode kernel (their
    plain twins on the CPU) on its replica's B/2 = 1 row, each layer of
    each step; under cp prefill, SP and flash decoding neither runs (the
    reference's gates, model_base.py:1113-1116, :1186). Tokens and logits
    equal tp 1."""
    first = GATES_AT
    outs = world8[0][0]
    tp1, dp2, cp = (outs[first + i] for i in range(3))
    _same(dp2, tp1)
    _same(cp, tp1)
    base = _calls(world8, first)[0][3]
    assert {t for t, _ in base} == {"flash", "decode"}
    assert {n for _, n in base} == {2}
    ranks = _calls(world8, first + 1)
    assert sorted((d, r) for d, _, r, _ in ranks) == [(0, 0), (0, 1),
                                                      (1, 0), (1, 1)]
    for *_, calls in ranks:
        assert sorted(calls) == sorted((t, 1) for t, _ in base)
    ranks = _calls(world8, first + 2)
    assert len(ranks) == 8 and all(not c for *_, c in ranks)


def test_moe_at_dp_matches_jax(ckpts, world8):
    """Tiny Qwen3-MoE at ``tp_degree=4, attention_dp_degree=2,
    ep_degree=2``: each replica's rows through its experts (ep 2 x tp 1
    inside the replica); tokens equal the JAX package's at that mesh,
    logits within the suite's tolerance."""
    got = world8[0][0][MOE_AT]
    _same(got, _jax_generate(ckpts["qwen3_moe"], "qwen3_moe", MOE,
                             _prompts(5, 250)))


def test_continuous_batching_at_dp(world8):
    """``ContinuousBatchingAdapter`` at dp 2 x tp 1 over 4 cache rows:
    row 2 alone (replica 1 runs, replica 0 idles), rows 0 and 2 (one
    each), row 0 alone, then a fused ``step_many`` on row 2: the streams
    equal tp 1's."""
    base, dp = world8[0][2]
    assert dp == base and all(base)


@pytest.fixture(scope="module")
def world4(ckpts, tmp_path_factory):
    rng = np.random.default_rng(7)
    adapter = {0: rng.integers(1, 500, size=5).tolist(),
               1: rng.integers(1, 500, size=9).tolist(),
               2: rng.integers(1, 500, size=7).tolist()}
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 500, size=24).tolist()
    waves = [[shared + rng.integers(1, 500, size=5).tolist(),
              rng.integers(1, 500, size=9).tolist()],
             [shared + rng.integers(1, 500, size=n).tolist()
              for n in (3, 6, 2, 9)]]
    res = spawn_world(
        torch_dcp_ranks.world4_cases, 4, "gloo", "cpu",
        str(tmp_path_factory.mktemp("dcp_world4")), 150.0,
        (ckpts["serve"], [(dict(PAGED, **over), dict(ENGINE, **over))
                          for over in (dict(tp_degree=1), DP2)],
         adapter, waves, N_NEW - 1))
    return res[0], adapter, waves


_JAX_PAGED = {}


def _jax_paged(ckpt, base):
    """The JAX paged app at dp 2 x tp 2, built once a config and handed
    back with a fresh cache (a cold prefix cache, as each port run has)."""
    key = repr(sorted(base.items()))
    if key not in _JAX_PAGED:
        tcfg = JTpuConfig(**dict(base, **DP2))
        fam = j_get_family("llama")
        _JAX_PAGED[key] = JPagedApp(
            ckpt, fam.config_cls(tcfg, load_config=j_load_config(ckpt)),
            fam, mesh=j_mesh_from_config(tcfg)).load_weights()
    return _JAX_PAGED[key].init_cache()


def test_paged_adapter_both_modes_at_dp2_tp2(ckpts, world4):
    """The reference's serving-mesh scenario (admit, decode, release,
    admit into the freed row) at ``tp_degree=4, attention_dp_degree=2``,
    through ``PagedEngineAdapter`` two-phase and ragged: streams equal
    the JAX adapter's at the same mesh and the port's at tp 1."""
    (tp1, dp2), prompts, _ = world4
    for mode, make in ((0, JPagedEngineAdapter),
                       (1, lambda a: JPagedEngineAdapter(
                           a, ragged=True, prefill_chunk_tokens=8))):
        want = torch_dcp_ranks.adapter_scenario(
            _jax_paged(ckpts["serve"], PAGED), prompts, make)
        assert dp2[mode] == want == tp1[mode]
        assert all(len(v) >= 2 for v in want.values())


def test_ragged_engine_prefix_across_replicas(ckpts, world4):
    """The ragged ``ServingEngine`` at dp 2 x tp 2 over two waves: each of
    the second wave's four requests (two rows on each replica) hits the
    24 prefix tokens that wave 1's first request wrote on replica 0; every
    replica wrote every row's K/V, so the streams equal the JAX engine's
    at the same mesh and tp 1's."""
    (tp1, dp2), _, waves = world4
    streams, hits = dp2[2]
    assert [n for _, n in hits] == [24] * 4
    assert (streams, hits) == tp1[2]
    japp = _jax_paged(ckpts["serve"], ENGINE)
    eng = JServingEngine(JPagedEngineAdapter(japp, ragged=True,
                                             prefill_chunk_tokens=16))
    want = []
    for wave in waves:
        handles = [eng.submit(p, N_NEW - 1) for p in wave]
        while eng.has_work:
            eng.run_pass()
        want += [list(h.drain()) for h in handles]
    assert streams == want
    assert all(len(s) == N_NEW - 1 for s in want)
