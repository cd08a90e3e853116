"""The fused speculation step on the card (``models/speculation.py``): one
CUDA graph per (batch, k) holds the k draft steps, the verify and the
acceptance. Replayed, it must give what the same step gives run eagerly,
bit for bit (tokens, counts, both caches), and the contiguous decode
kernel's counters must show the draft steps inside the graph. Needs a
CUDA card: ``python -m pytest -m cuda tests/test_torch_speculation_cuda.py``
(skips here). This file imports no JAX: the reference is the eager step.

Geometry: a 2-layer bf16 target (hidden 256, 4 q / 2 kv heads of
head_dim 64) and a 2-layer draft (hidden 128, 2 / 1 heads of 64), batch
2, seq_len 256, k 4, random weights from seeds 0 and 1."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu_torch.config import (
    SpeculationConfig, TpuConfig)
from neuronx_distributed_inference_tpu_torch.models import speculation
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.llama import (
    LlamaFamily, LlamaInferenceConfig)
from neuronx_distributed_inference_tpu_torch.ops import decode_attention

K = 4
HF = dict(model_type="llama", vocab_size=512, rms_norm_eps=1e-5,
          rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False,
          max_position_embeddings=1024)


def _app(hidden, heads, kv_heads, k, seed):
    spec = SpeculationConfig(speculation_length=k) if k else None
    cfg = LlamaInferenceConfig(
        TpuConfig(batch_size=2, seq_len=256, dtype="bfloat16",
                  enable_bucketing=False, speculation_config=spec),
        **HF, hidden_size=hidden, intermediate_size=2 * hidden,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=kv_heads, head_dim=64)
    app = CausalLMApplication(None, cfg, LlamaFamily, device="cuda")
    return app.init_random_weights(seed).init_cache()


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.cuda
def test_fused_step_graph_replay_equals_eager_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    target = _app(256, 4, 2, K, 0)
    draft = _app(128, 2, 1, 0, 1)
    ids = np.random.default_rng(0).integers(1, 500, size=(2, 37)).astype(
        np.int32)
    lens = np.full((2,), 37, np.int32)
    first = speculation._prefill(target, ids, lens)["tokens"]
    speculation._prefill(draft, ids, lens)
    dec = speculation.SpeculativeDecoder(target, draft)
    wrapper = decode_attention.decode_attention_stacked
    wrapper.launches = wrapper.captured = 0
    last = first.cpu().numpy().astype(np.int32)
    pos = lens.copy()
    sid = np.arange(2, dtype=np.int32)
    for step in range(3):
        t_cache, d_cache = _clone(target.cache), _clone(draft.cache)
        eager = speculation.fused_speculation_step(
            draft.spec, target.spec, target.tpu_config, draft.params,
            target.params, d_cache, t_cache,
            torch.as_tensor(last, device="cuda"),
            torch.as_tensor(pos, device="cuda"),
            torch.as_tensor(sid, device="cuda"), draft._inv_freq,
            target._inv_freq)
        toks, n = dec._step(last, pos, sid)
        np.testing.assert_array_equal(toks, eager["tokens"].cpu().numpy())
        np.testing.assert_array_equal(n, eager["num_accepted"].cpu().numpy())
        for got, want in ((target.cache, t_cache), (draft.cache, d_cache)):
            for name in ("k", "v"):
                assert torch.equal(got[name], want[name]), (step, name)
        last = toks[np.arange(2), n - 1].astype(np.int32)
        pos = pos + n
    # every draft step took the kernel: k per layer in the graph, replayed
    # once per step; the eager twins and the capture's warm-up runs count
    # as launches
    layers = draft.spec.num_layers
    assert len(dec.graphs) == 1
    assert wrapper.captured == layers * K
    assert dec.graphs.replayed_launches("decode_attention_stacked") \
        == layers * K * 3
    assert wrapper.launches == layers * K * (3 + 2)
