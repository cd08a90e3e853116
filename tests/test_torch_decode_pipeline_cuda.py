"""The depth-1 decode pipeline on the card, through the captured CUDA
graphs: on both adapters the pipelined streams equal the eager streams,
and no pipelined dispatch synchronises the host with the card
(``torch.cuda.set_sync_debug_mode("error")`` around every
``_dispatch_decode``; the staging buffers' waits counted by the graph
cache stay at 0). Needs a CUDA card: ``python -m pytest -m cuda
tests/test_torch_decode_pipeline_cuda.py`` (skips here). This file
imports no JAX.

Geometry: a 2-layer bf16 Llama (hidden 256, 4 q / 2 kv heads of head_dim
64, so the paged kernel and, at a full continuous batch, the contiguous
decode kernel run), batch 2, random weights."""


import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.serving import (
    ContinuousBatchingAdapter, PagedEngineAdapter)
from neuronx_distributed_inference_tpu_torch.serving.warmup import \
    precompile

HF = dict(model_type="llama", hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=64, vocab_size=512, rms_norm_eps=1e-5, rope_theta=10000.0,
          hidden_act="silu", tie_word_embeddings=False)
STEPS = 12


def _app(kind):
    common = dict(batch_size=2, seq_len=128, dtype="bfloat16",
                  enable_bucketing=True, context_encoding_buckets=[64])
    if kind == "paged":
        tcfg = TpuConfig(is_block_kv_layout=True, pa_block_size=16,
                         pa_num_blocks=24, **common)
        cls = PagedCausalLMApplication
    else:
        tcfg = TpuConfig(is_continuous_batching=True, **common)
        cls = CausalLMApplication
    app = cls(None, LlamaInferenceConfig(tcfg, **HF), LlamaFamily,
              device="cuda").init_random_weights(0).init_cache()
    precompile(app)
    return app


def _no_sync_dispatch(ad):
    """Wrap ``ad._dispatch_decode`` in the sync debug mode "error"."""
    inner = ad._dispatch_decode

    def guarded(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    ad._dispatch_decode = guarded


def _serve(app, cls, depth, prompts):
    ad = cls(app, pipeline_depth=depth)
    if depth:
        _no_sync_dispatch(ad)
    got = {s: [t] for s, t in ad.add_requests([0, 1], prompts).items()}
    for _ in range(STEPS):
        for s, t in ad.step().items():
            got[s].append(t)
    for s, t in ad.flush().items():
        got[s].append(t)
    ad.release([0, 1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paged", "cb"])
def test_pipelined_streams_equal_eager_without_dispatch_syncs(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    app = _app(kind)
    cls = PagedEngineAdapter if kind == "paged" else ContinuousBatchingAdapter
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n).tolist() for n in (40, 57)]
    want = _serve(app, cls, 0, prompts)
    n_graphs = len(app.graphs)
    app.graphs.reset_counts()
    got = _serve(app, cls, 1, prompts)
    assert {s: t[:STEPS + 1] for s, t in got.items()} == want
    assert len(app.graphs) == n_graphs            # replays only
    assert sum(app.graphs.replays.values()) >= STEPS
    assert app.graphs.staging_waits == 0
    name = ("paged_decode_attention" if kind == "paged"
            else "decode_attention_stacked")
    assert app.graphs.replayed_launches(name) >= STEPS * 2
