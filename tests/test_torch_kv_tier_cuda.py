"""A restore of spilled KV under the captured CUDA graphs, on the card.

The paged adapter writes restored blocks into the cache IN PLACE, so the
T = 1 decode graphs captured before the restore read the restored pages
at their next replays. A prompt is served, its blocks are evicted into the
host tier, and the prompt is served again through the restore: the
replayed stream must equal an eager app's (no graphs, the same weights)
that followed the same path, with no new capture, the cache tensors at
their addresses, and replays made; zeroing the spilled payloads must part
the stream (the control). Needs a CUDA card: ``python -m pytest -m cuda
tests/test_torch_kv_tier_cuda.py`` (skips here). This file imports no JAX.

Geometry: a 2-layer bf16 Llama (hidden 256, 4 q / 2 kv heads of head_dim
64, so the paged kernel runs), batch 2, block 16, random weights."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    PagedCausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.serving import \
    PagedEngineAdapter
from neuronx_distributed_inference_tpu_torch.serving.fleet import \
    HostKVSpillTier
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    precompile

HF = dict(model_type="llama", hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=64, vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
          hidden_act="silu", tie_word_embeddings=False)
NEW = 16


def _app(graphs):
    tcfg = TpuConfig(batch_size=2, seq_len=128, dtype="bfloat16",
                     enable_bucketing=True, context_encoding_buckets=[64],
                     is_block_kv_layout=True, pa_block_size=16,
                     pa_num_blocks=24, is_prefix_caching=True)
    return PagedCausalLMApplication(
        None, LlamaInferenceConfig(tcfg, **HF), LlamaFamily, device="cuda",
        cuda_graphs=graphs)


def _serve(ad, sid, prompt):
    ad.add_requests([sid], [prompt])
    toks = []
    while len(toks) < NEW:
        for s, t in ad.step().items():
            toks.extend(t)
    ad.release([sid])
    return toks[:NEW]


def _spill_restore(app, prompt, zero=False):
    """Serve ``prompt``, evict its blocks into a tier, serve it again
    through the restore (the cache is never replaced: that would drop
    the graphs). Returns (second stream, restored blocks)."""
    tier = HostKVSpillTier(max_blocks=8)
    ad = PagedEngineAdapter(app, ragged=True, kv_spill_tier=tier,
                            prefill_chunk_tokens=64)
    _serve(ad, 0, prompt)
    mgr = app.kv_mgr
    cold = list(range(600, 600 + (mgr.spec.num_blocks - 1) * 16))
    mgr.begin_sequence(9, cold)
    mgr.abort_sequence(9)
    if zero:
        for p in tier._pool.values():
            p["k"].zero_()
            p["v"].zero_()
    ptrs = [t.data_ptr() for t in app.cache.values()]
    toks = _serve(ad, 1, prompt)
    assert [t.data_ptr() for t in app.cache.values()] == ptrs
    return toks, tier.stats["restored"]


@pytest.mark.cuda
def test_graph_replays_read_restored_pages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    app = _app(graphs=True).init_random_weights(0).init_cache()
    eager = _app(graphs=False)
    eager.params = app.params
    eager.init_cache()
    precompile(app)
    n_graphs = len(app.graphs)
    prompt = np.random.default_rng(1).integers(1, 500, size=40).tolist()
    app.graphs.reset_counts()
    got, restored = _spill_restore(app, prompt)
    assert restored == 2                      # 32 of 40 tokens restored
    assert sum(app.graphs.replays.values()) > 0
    assert len(app.graphs) == n_graphs        # no capture after precompile
    want, _ = _spill_restore(eager, prompt)
    assert got == want
    ctl, _ = _spill_restore(app, prompt, zero=True)
    assert ctl != got
