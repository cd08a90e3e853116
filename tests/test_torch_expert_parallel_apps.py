"""Expert parallelism and MoE / MLA at tp > 1 in the port on the CPU:
ranks spawned over gloo (``parallel.mesh.spawn_world``; one world of 4
and one of 2, each torn down by ``spawn_world`` whatever happens), each
model held to the JAX package at the same mesh on its 8 virtual CPU
devices, from the same HF checkpoint:

* world 4, ep 2 x tp 2 (``tp_degree=4, ep_degree=2``): Mixtral as the
  reference pins it (tests/test_moe.py:130-183): prefill logits against
  the JAX package and HF at atol 5e-3 / rtol 1e-3; the hybrid decode
  layout (``moe_tkg_ep_degree=1``) gives the uniform layout's tokens with
  logits within atol 2e-4 / rtol 1e-4, and the JAX hybrid run's tokens.
  DeepSeek-V3 (MLA with q-LoRA, shared experts, group-limited routing,
  two dense layers then MoE): the JAX package's tokens, logits within the
  suite's atol 2e-3 / rtol 1e-3.
* world 2: DeepSeek-V3 at tp 2; gpt-oss (sinks, expert biases added once
  over tp, the checkpoint's experts in bf16 and in MXFP4) and OLMoE (the
  full-width q/k norm in MoE layers) at tp 2; tiny Qwen3-MoE at
  ``tp_degree=2, ep_degree=2`` on the ragged ``ServingEngine``, stream for
  stream against the JAX package's ragged paged adapter at that mesh.
"""

import os

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import (
    MoEConfig as JMoEConfig, TpuConfig as JTpuConfig,
    load_pretrained_config as j_load_config)
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

import torch_ep_ranks
import test_torch_contrib_moe as contrib_moe
import test_torch_deepseek as deepseek
import test_torch_gpt_oss as gpt_oss
from test_torch_dense_families import _transformers

TOL = dict(atol=2e-3, rtol=1e-3)
HF_TOL = dict(atol=5e-3, rtol=1e-3)            # tests/test_moe.py:148
HYBRID_TOL = dict(atol=2e-4, rtol=1e-4)        # tests/test_moe.py:182
TCFG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
            enable_bucketing=False)
ENGINE = dict(batch_size=4, seq_len=128, dtype="float32",
              is_block_kv_layout=True, pa_block_size=8,
              is_prefix_caching=True, is_chunked_prefill=True)
EP4 = dict(tp_degree=4, ep_degree=2)
N_NEW = 3


def _save_hf(d, model):
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """name -> (checkpoint directory, HF model or None)."""
    tf = _transformers()
    mk = tmp_path_factory.mktemp
    torch.manual_seed(0)
    # the reference's tiny Mixtral and Qwen3-MoE (tests/test_moe.py:78-101)
    mixtral = tf.MixtralForCausalLM(tf.MixtralConfig(
        hidden_size=64, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        num_local_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
        max_position_embeddings=128, torch_dtype="float32",
        tie_word_embeddings=False, sliding_window=None)).eval()
    torch.manual_seed(0)
    qwen = tf.Qwen3MoeForCausalLM(tf.Qwen3MoeConfig(
        hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, vocab_size=256, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=True, rms_norm_eps=1e-5, decoder_sparse_step=1,
        mlp_only_layers=[], max_position_embeddings=128,
        torch_dtype="float32", tie_word_embeddings=False)).eval()
    oss = gpt_oss._save_checkpoint(mk("gpt_oss_ep"), 16)
    from safetensors.numpy import save_file
    from neuronx_distributed_inference_tpu_torch.utils.checkpoint import \
        load_state_dict
    oss_mx = str(mk("gpt_oss_mxfp4_ep"))
    save_file(gpt_oss._mxfp4_layout(load_state_dict(oss),
                                    np.random.default_rng(4)),
              os.path.join(oss_mx, "model.safetensors"))
    with open(os.path.join(oss, "config.json")) as f, \
            open(os.path.join(oss_mx, "config.json"), "w") as g:
        g.write(f.read())
    return {
        "mixtral": (_save_hf(mk("mixtral_ep"), mixtral), mixtral),
        "qwen3_moe": (_save_hf(mk("qwen3_moe_ep"), qwen), None),
        "deepseek_v3": (_save_hf(mk("deepseek_ep"),
                                 deepseek._hf_model("qlora_mixed")), None),
        "olmoe": (_save_hf(mk("olmoe_ep"), contrib_moe.hf_model("olmoe")),
                  None),
        "gpt_oss": (oss, None), "gpt_oss_mxfp4": (oss_mx, None),
    }


def _prompts(seed, width=10):
    return np.random.default_rng(seed).integers(
        1, 250, size=(2, width)).astype(np.int32)


def _engine_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 250, size=int(n)).tolist()
            for n in (5, 21, 40, 9, 33)]


def _model_type(name):
    return "gpt_oss" if name.startswith("gpt_oss") else name


# world 4: (name, TpuConfig kwargs, prompts seed)
WORLD4 = (("mixtral", EP4, 0), ("mixtral", dict(EP4, moe_tkg_ep_degree=1), 0),
          ("deepseek_v3", EP4, 1))
# world 2
WORLD2 = (("deepseek_v3", dict(tp_degree=2), 1),
          ("gpt_oss", dict(tp_degree=2), 2),
          ("gpt_oss_mxfp4", dict(tp_degree=2), 2),
          ("olmoe", dict(tp_degree=2), 3))
SERVE = ("qwen3_moe", dict(tp_degree=2, ep_degree=2))


def _cases(ckpts, table):
    return [(ckpts[name][0], _model_type(name), dict(TCFG, **over),
             _prompts(seed), "generate") for name, over, seed in table]


@pytest.fixture(scope="module")
def world4(ckpts, tmp_path_factory):
    return spawn_world(torch_ep_ranks.run_cases, 4, "gloo", "cpu",
                       str(tmp_path_factory.mktemp("ep_world4")), 150.0,
                       (_cases(ckpts, WORLD4), N_NEW))[0]


@pytest.fixture(scope="module")
def world2(ckpts, tmp_path_factory):
    name, over = SERVE
    serve = (ckpts[name][0], name, dict(ENGINE, **over), _engine_prompts(),
             "engine")
    return spawn_world(torch_ep_ranks.run_cases, 2, "gloo", "cpu",
                       str(tmp_path_factory.mktemp("ep_world2")), 150.0,
                       (_cases(ckpts, WORLD2) + [serve], N_NEW))[0]


def _jax_config(over, base=TCFG):
    over = dict(over)
    tkg = over.pop("moe_tkg_ep_degree", None)
    if tkg is not None:
        over["moe_config"] = JMoEConfig(moe_tkg_ep_degree=tkg)
    return JTpuConfig(**dict(base, **over))


_JAX_APPS = {}


def _jax_generate(ckpt, model_type, over, prompts):
    """The JAX app at the same mesh; one app a model type and mesh, its
    compiled steps reused over checkpoints of the same geometry."""
    key = (model_type, tuple(sorted(over.items())))
    if key not in _JAX_APPS:
        tcfg = _jax_config(over)
        fam = j_get_family(model_type)
        _JAX_APPS[key] = JApp(ckpt, fam.config_cls(
            tcfg, load_config=j_load_config(ckpt)), fam,
            mesh=j_mesh_from_config(tcfg))
    app = _JAX_APPS[key]
    r = app.load_weights(ckpt).init_cache().generate(
        prompts, max_new_tokens=N_NEW, return_logits=True)
    return np.asarray(r["generated"]), [np.asarray(x) for x in r["logits"]]


def _assert_matches_jax(got, ckpts, name, over, seed):
    want = _jax_generate(ckpts[name][0], _model_type(name), over,
                         _prompts(seed))
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL)
    return want


def test_mixtral_ep2_tp2_matches_jax_and_hf(ckpts, world4):
    """Prefill logits at ep 2 x tp 2 against the JAX package at the same
    mesh and against HF (tests/test_moe.py:130-149)."""
    got = world4[0]
    _assert_matches_jax(got, ckpts, *WORLD4[0])
    ids = _prompts(WORLD4[0][2])
    with torch.no_grad():
        golden = ckpts["mixtral"][1](torch.tensor(ids.astype(np.int64))
                                     ).logits.numpy()
    np.testing.assert_allclose(got[1][0][:, :ids.shape[1]], golden,
                               **HF_TOL)


def test_mixtral_hybrid_decode_layout(ckpts, world4):
    """``moe_tkg_ep_degree=1``: the decode steps read the every-expert
    copy; tokens equal the uniform layout's, logits within atol 2e-4 /
    rtol 1e-4 (tests/test_moe.py:151-183), and equal the JAX package's
    hybrid run's tokens."""
    base, hyb = world4[0], world4[1]
    np.testing.assert_array_equal(hyb[0], base[0])
    for a, b in zip(hyb[1], base[1]):
        np.testing.assert_allclose(a, b, **HYBRID_TOL)
    _assert_matches_jax(hyb, ckpts, *WORLD4[1])


@pytest.mark.parametrize("case", ["ep2_tp2", "tp2"])
def test_deepseek_mla_and_moe_match_jax(ckpts, world4, world2, case):
    """DeepSeek-V3 ``qlora_mixed`` (MLA by heads, the latent replicated;
    shared experts cut over every rank; group-limited routing on the
    replicated router) at tp_degree 4 with ep 2 and at tp_degree 2:
    identical tokens to the JAX package at the same mesh."""
    got, row = ((world4[2], WORLD4[2]) if case == "ep2_tp2"
                else (world2[0], WORLD2[0]))
    _assert_matches_jax(got, ckpts, *row)


@pytest.mark.parametrize("name", ["gpt_oss", "gpt_oss_mxfp4", "olmoe"])
def test_families_at_tp2_match_jax(ckpts, world2, name):
    """gpt-oss (sinks cut by heads, the expert down bias added on tp
    index 0 only, its experts stored in bf16 or MXFP4) and OLMoE (the
    full-width q/k norm's sum of squares over the group) at tp 2."""
    i = [row[0] for row in WORLD2].index(name)
    _assert_matches_jax(world2[i], ckpts, *WORLD2[i])


def test_ragged_engine_ep2_matches_jax_paged_adapter(ckpts, world2):
    """Tiny Qwen3-MoE at tp_degree 2 with ep 2 (one expert pair a rank)
    on the ragged ``ServingEngine``: the JAX package's ragged paged
    adapter at the same mesh gives the same streams."""
    name, over = SERVE
    tcfg = _jax_config(over, ENGINE)
    fam = j_get_family(name)
    japp = JPagedApp(ckpts[name][0], fam.config_cls(
        tcfg, load_config=j_load_config(ckpts[name][0])), fam,
        mesh=j_mesh_from_config(tcfg))
    japp.load_weights().init_cache()
    eng = JServingEngine(JPagedEngineAdapter(japp, ragged=True,
                                             prefill_chunk_tokens=16))
    streams = [eng.submit(p, N_NEW) for p in _engine_prompts()]
    while eng.has_work:
        eng.run_pass()
    want = [list(s.drain()) for s in streams]
    got, passes = world2[-1]
    assert got == want and passes > 0
    assert all(len(s) == N_NEW for s in want)
