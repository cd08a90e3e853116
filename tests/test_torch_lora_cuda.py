"""An adapter swap under a captured CUDA graph, on the card.

``write_lora_slot`` writes a slot of the stacked LoRA factors in place, so
the T = 1 decode graph captured under the old factors serves the new ones
at its next replay: its tokens must equal an eager app's (no graphs, the
same weight tensors) under the new factors, and differ from the tokens
under the old ones. The pool's rollback snapshot must be a copy (another
storage, equal values) and a failed swap must leave every slot's factors
equal to before. Needs a CUDA card: ``python -m pytest -m cuda
tests/test_torch_lora_cuda.py`` (skips here). This file imports no JAX: the
reference is the eager step.

Geometry: a 2-layer bf16 Llama (hidden 256, 4 q / 2 kv heads of head_dim
64, so the paged kernel runs), batch 2, block 16, every module targeted at
rank 8, ``max_loras`` 3, random weights and adapters from seeds."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.resilience import (
    FAULTS, StepFailure)
from neuronx_distributed_inference_tpu_torch.serving import LoraAdapterPool

HF = dict(model_type="llama", hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=64, vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
          hidden_act="silu", tie_word_embeddings=False)
ALL7 = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj"]


def _app(graphs):
    tcfg = TpuConfig(batch_size=2, seq_len=128, dtype="bfloat16",
                     enable_bucketing=True, context_encoding_buckets=[64],
                     is_block_kv_layout=True, pa_block_size=16,
                     pa_num_blocks=32, is_prefix_caching=False,
                     lora_config=LoraServingConfig(
                         max_loras=3, max_lora_rank=8,
                         target_modules=ALL7))
    return PagedCausalLMApplication(
        None, LlamaInferenceConfig(tcfg, **HF), LlamaFamily, device="cuda",
        cuda_graphs=graphs)


def _adapter(app, seed):
    rng = np.random.default_rng(seed)
    lw = app.params["layers"]
    out = {}
    for mod in ALL7:
        a, b = lw[f"lora_A_{mod}"], lw[f"lora_B_{mod}"]
        out[mod] = ((0.5 * rng.standard_normal(
            (a.shape[0], a.shape[2], a.shape[3]))).astype(np.float32),
            (0.5 * rng.standard_normal(
                (b.shape[0], b.shape[2], b.shape[3]))).astype(np.float32))
    return out


@pytest.mark.cuda
def test_swap_under_captured_graph_serves_new_factors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    app = _app(graphs=True).init_random_weights(0).init_cache()
    eager = _app(graphs=False)
    eager.params = app.params           # the same tensors: one set of slots
    eager.init_cache()
    ids = np.random.default_rng(1).integers(1, 500, size=(2, 40)).astype(
        np.int32)
    aids = np.ones((2,), np.int32)
    app.write_lora_slot(1, _adapter(app, 11))
    old = app.generate(ids, max_new_tokens=12, adapter_ids=aids)
    sigs = app.graphs.signatures()
    assert any(sig[2][-1] for sig in sigs), sigs   # a LoRA graph
    leaf = app.params["layers"]["lora_B_down_proj"]
    ptr = leaf.data_ptr()
    app.write_lora_slot(1, _adapter(app, 12))
    assert app.params["layers"]["lora_B_down_proj"].data_ptr() == ptr
    app.graphs.reset_counts()
    new = app.generate(ids, max_new_tokens=12, adapter_ids=aids)
    assert app.graphs.signatures() == sigs         # nothing captured anew
    assert sum(app.graphs.replays.values()) == 11
    want = eager.generate(ids, max_new_tokens=12, adapter_ids=aids)
    np.testing.assert_array_equal(new["generated"], want["generated"])
    assert not np.array_equal(new["generated"], old["generated"])

    # the pool's rollback snapshot is a copy, and a failed swap restores
    pool = LoraAdapterPool(app)
    pool.register_arrays("a", _adapter(app, 13))
    snap = pool._snapshot(2, ALL7)
    assert len(snap) == 2 * len(ALL7)
    for leaf, saved in snap:
        assert saved.data_ptr() != leaf[:, 2].data_ptr()
        assert torch.equal(saved, leaf[:, 2])
    lw = app.params["layers"]
    before = {k: v.clone() for k, v in lw.items() if k.startswith("lora_")}
    with FAULTS.inject("adapter_swap", nth=1, times=1):
        with pytest.raises(StepFailure):
            pool.acquire("a")
    # a write that fails half-way is rolled back from the clones too
    write = app.write_lora_slot

    def half(slot, arrays):
        write(slot, dict(list(arrays.items())[:3]))
        raise RuntimeError("the device write failed half-way")
    app.write_lora_slot = half
    try:
        with pytest.raises(StepFailure):
            pool.acquire("a")
    finally:
        del app.write_lora_slot
    for k, v in before.items():
        assert torch.equal(lw[k], v), k
