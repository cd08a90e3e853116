"""Tensor-parallel serving of the port on the CPU (ranks spawned over
gloo, one world of 4): the paged adapter's continuous-batching scenario of
the reference's tests/test_serving_mesh.py:40-78 (two ragged prompts,
decode, release, admit into the freed slot) at tp 4 against the JAX
package at tp 4, dp 1, stream for stream; ``ServingEngine.run_pass`` on
the ragged engine at tp 2 (the world's first two ranks) against the
port's tp 1, stream for stream. Rank 0 plans every dispatch (scheduler,
planner, block allocator, prefix cache) and the other ranks follow its
records. What this slice does not serve at tp > 1 raises
``ConfigurationError`` naming ROADMAP A13d."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.config import (
    TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import \
    PagedCausalLMApplication as JPagedApp
from neuronx_distributed_inference_tpu.models.llama import (
    LlamaFamily as JLlamaFamily, LlamaInferenceConfig as JLlamaConfig)
from neuronx_distributed_inference_tpu.parallel.mesh import \
    mesh_from_config as j_mesh_from_config
from neuronx_distributed_inference_tpu.serving import \
    PagedEngineAdapter as JPagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import \
    LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    Mesh, spawn_world)
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

import torch_tp_ranks
from conftest import tiny_llama_hf_config
from test_torch_dense_families import _transformers

ADAPTER = dict(batch_size=2, seq_len=64, dtype="float32",
               enable_bucketing=True, context_encoding_buckets=[16],
               is_block_kv_layout=True, pa_block_size=8,
               is_prefix_caching=True)
ENGINE = dict(batch_size=4, seq_len=128, dtype="float32",
              is_block_kv_layout=True, pa_block_size=8,
              is_prefix_caching=True, is_chunked_prefill=True)
N_NEW = 5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tf = _transformers()
    import torch
    torch.manual_seed(0)
    model = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        num_hidden_layers=2))).eval()
    d = tmp_path_factory.mktemp("tiny_llama_tp_serving")
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


def _adapter_prompts():
    rng = np.random.default_rng(7)
    return {0: rng.integers(1, 500, size=5).tolist(),
            1: rng.integers(1, 500, size=9).tolist(),
            2: rng.integers(1, 500, size=7).tolist()}


def _engine_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 500, size=int(n)).tolist()
            for n in (5, 21, 40, 9, 33)]


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):
    return spawn_world(
        torch_tp_ranks.serving_at, 4, "gloo", "cpu",
        str(tmp_path_factory.mktemp("tp_serving_world")), 150.0,
        (ckpt, ADAPTER, _adapter_prompts(), ENGINE, _engine_prompts(),
         N_NEW))[0]


def test_paged_adapter_at_tp4_matches_jax_tp4(ckpt, served):
    tcfg = JTpuConfig(**ADAPTER, tp_degree=4)
    japp = JPagedApp(ckpt, JLlamaConfig(tcfg, load_config=j_load_config(
        ckpt)), JLlamaFamily, mesh=j_mesh_from_config(tcfg))
    japp.load_weights().init_cache()
    want = torch_tp_ranks.adapter_scenario(japp, _adapter_prompts(),
                                           JPagedEngineAdapter)
    assert served[0] == want
    assert all(len(t) >= 3 for t in want.values())


def test_ragged_engine_at_tp2_equals_tp1(ckpt, served):
    app = torch_tp_ranks.build_app(ckpt, "llama", ENGINE, paged=True)
    want, passes = torch_tp_ranks.engine_streams(app, _engine_prompts(),
                                                 N_NEW)
    got, got_passes = served[1]
    assert got == want and got_passes == passes
    assert all(len(s) == N_NEW for s in want)


@pytest.mark.parametrize("case", ["pipeline", "speculation", "spill_tier",
                                  "frontend", "handoff"])
def test_serving_refusals_at_tp_over_1(case):
    """At tp > 1 the pipelined dispatch, served speculation, the KV spill
    tier, the HTTP front door and the handoff raise ConfigurationError
    (ROADMAP A13d). An app over a mesh needs no collective to be built,
    so a rank's view without a process group stands in."""
    mesh = Mesh(None, "gloo", "cpu", rank=0, tp=2)
    app = PagedCausalLMApplication(None, LlamaInferenceConfig(
        TpuConfig(**ENGINE, tp_degree=2), **tiny_llama_hf_config(
            num_hidden_layers=2)), device="cpu", mesh=mesh)
    app.init_random_weights(0).init_cache()
    assert app.cache["k"].shape[3] == 1           # one KV head a rank
    with pytest.raises(ConfigurationError, match="A13d"):
        if case == "pipeline":
            PagedEngineAdapter(app, pipeline_depth=1)
        elif case == "speculation":
            PagedEngineAdapter(app, speculation=object())
        elif case == "spill_tier":
            PagedEngineAdapter(app, kv_spill_tier=object())
        elif case == "frontend":
            ServingFrontend(ServingEngine(PagedEngineAdapter(app)))
        else:
            capture_handoff(PagedEngineAdapter(app), 0)
