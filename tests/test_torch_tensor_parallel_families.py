"""Tensor parallelism of the port's dense-family knobs on the CPU (one
world of 2 ranks spawned over gloo), each against the JAX package at tp 2
on its virtual CPU devices from the same HF checkpoint: OLMo-2, whose
q/k RMSNorm spans the whole projection (the rank's sum of squares is
summed over the group), and GPT-NeoX, a biased parallel block (its
attention and MLP outputs are each summed over the group where they are
made, their row-parallel biases added once after the sum). Then tiny
Llama with int8 weights (quantized whole, codes cut with their scales),
with a low-rank MLP (U cut on a row weight, V on a column one), with a
replicated embedding, and with the int8 quantized ring on the decode
phase's row-parallel sums. Identical tokens; fp32 logits within atol
2e-3 / rtol 1e-3, except where the quantized ring stands between them:
there the two packages are held together at that tolerance once every
rank holds the same copy of each ring sum (both rings patched alike), and
the real rings' streams within the gap measured between them."""

import numpy as np
import pytest

from neuronx_distributed_inference_tpu.config import (
    CollectiveConfig as JCollectiveConfig, TpuConfig as JTpuConfig,
    load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.parallel import \
    collectives as jcollectives
from neuronx_distributed_inference_tpu.parallel.mesh import \
    mesh_from_config as j_mesh_from_config
from neuronx_distributed_inference_tpu_torch.config import CollectiveConfig
from neuronx_distributed_inference_tpu_torch.parallel.mesh import \
    spawn_world

import torch_tp_ranks
import test_torch_contrib_dense as contrib_dense
import test_torch_dense_families as dense_families
from conftest import tiny_llama_hf_config

TOL = dict(atol=2e-3, rtol=1e-3)
TCFG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
            enable_bucketing=False)
N_NEW = 5
# the reference's pin of its int8-ring decode logits against the fp32
# collective stream (tests/test_quantized_collectives.py:160-163: 3% of the
# largest logit)
APP_TOL_INT8 = 0.03
# the port's int8-ring decode logits against the JAX package's, as a share
# of the largest logit: 1.01e-2 at most over the four decode steps here
# (0.57e-2, 0.67e-2, 1.01e-2, 0.40e-2), with every rank's copy of a ring
# sum equal 2.9e-7 at most. The real rings keep each rank's own chunk at
# full precision, and the JAX graph computes the fused q/k/v columns as a
# contiguous cut (rank 0 every q head, rank 1 k and v) before moving heads
# between devices, so its heads read another rank's copy; the port cuts
# the leaf by heads and each rank reads its own.
RING_JAX_TOL = 0.015

CASES = ("olmo2", "gpt_neox", "llama", "llama_int8", "llama_ring_int8",
         "llama_low_rank", "llama_vocab_replicated", "llama_ring_int8_equal")


def _prompts(vocab):
    return np.random.default_rng(5).integers(1, vocab, size=(2, 10)).astype(
        np.int32)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    dense_families._transformers()
    olmo = dense_families.hf_model("olmo2")
    d_olmo = tmp_path_factory.mktemp("olmo2_tp")
    olmo.save_pretrained(d_olmo, safe_serialization=True)
    d_neox = contrib_dense.save_ckpt(tmp_path_factory.mktemp("neox_tp"),
                                     "gpt_neox")
    tf = dense_families._transformers()
    import torch
    torch.manual_seed(1)
    # weights at std 0.25 (HF's 0.02 leaves the tiny model's logits so flat
    # that a ring's rounding flips greedy near-ties)
    llama = tf.LlamaForCausalLM(tf.LlamaConfig(**tiny_llama_hf_config(
        num_hidden_layers=2, initializer_range=0.25))).eval()
    d_llama = tmp_path_factory.mktemp("llama_tp_knobs")
    llama.save_pretrained(d_llama, safe_serialization=True)
    return {"olmo2": (str(d_olmo), "olmo2", {}),
            "gpt_neox": (d_neox, "gpt_neox", {}),
            "llama": (str(d_llama), "llama", {}),
            "llama_int8": (str(d_llama), "llama", dict(
                quantized=True, quantization_dtype="int8")),
            "llama_ring_int8": (str(d_llama), "llama", dict(
                collective_config=CollectiveConfig(dtype="int8"))),
            "llama_low_rank": (str(d_llama), "llama", dict(
                mlp_low_rank=16)),
            "llama_vocab_replicated": (str(d_llama), "llama", dict(
                vocab_parallel=False)),
            "llama_ring_int8_equal": (str(d_llama), "llama", dict(
                collective_config=CollectiveConfig(dtype="int8")))}


@pytest.fixture(scope="module")
def served(ckpts, tmp_path_factory):
    cases = [(ckpts[c][0], ckpts[c][1], dict(TCFG, **ckpts[c][2]),
              _prompts(256), c == "llama_ring_int8_equal") for c in CASES]
    got = spawn_world(torch_tp_ranks.generate_cases, 2, "gloo", "cpu",
                      str(tmp_path_factory.mktemp("tp_families_world")),
                      150.0, (cases, N_NEW))[0]
    return dict(zip(CASES, got))


def _jax_generate(ckpt, model_type, over, tp=2):
    over = dict(over)
    if "collective_config" in over:
        over["collective_config"] = JCollectiveConfig(
            dtype=over["collective_config"].dtype)
    tcfg = JTpuConfig(**TCFG, **over, tp_degree=tp)
    fam = j_get_family(model_type)
    app = JApp(ckpt, fam.config_cls(tcfg, load_config=j_load_config(ckpt)),
               fam, mesh=j_mesh_from_config(tcfg))
    app.load_weights().init_cache()
    out = app.generate(_prompts(256), max_new_tokens=N_NEW,
                       return_logits=True)
    return out["generated"], [np.asarray(x) for x in out["logits"]]


def _jax_equal_copies_ring(x, axis_name, group_size, *, dtype="int8",
                           block=jcollectives.DEFAULT_BLOCK):
    """The JAX ring (parallel/collectives.py:98-140) with the owner's chunk
    dequantized from the codes it sends, so that every device holds the
    same sum (the rank functions' ``equal_ring_copies``)."""
    import jax
    import jax.numpy as jnp
    g = int(group_size)
    n = x.shape[-1]
    blk = jcollectives._resolve_block(n // g, block)
    fwd = [(i, (i + 1) % g) for i in range(g)]
    r = jax.lax.axis_index(axis_name)
    blocks = jnp.stack(jnp.split(x, g, axis=-1), axis=0)
    cur = jnp.take(blocks, (r - 1) % g, axis=0)
    for step in range(g - 1):
        q, scale = jcollectives._quantize_wire(cur, dtype, blk)
        q = jax.lax.ppermute(q, axis_name, fwd)
        scale = jax.lax.ppermute(scale, axis_name, fwd)
        cur = (jcollectives._dequantize_wire(q, scale, blk, x.dtype)
               + jnp.take(blocks, (r - step - 2) % g, axis=0))
    q, scale = jcollectives._quantize_wire(cur, dtype, blk)
    out = jnp.zeros_like(blocks).at[r].set(
        jcollectives._dequantize_wire(q, scale, blk, x.dtype))
    for step in range(g - 1):
        q = jax.lax.ppermute(q, axis_name, fwd)
        scale = jax.lax.ppermute(scale, axis_name, fwd)
        out = out.at[(r - step - 1) % g].set(
            jcollectives._dequantize_wire(q, scale, blk, x.dtype))
    return jnp.moveaxis(out, 0, -2).reshape(*x.shape[:-1], n)


@pytest.mark.parametrize("case", ["olmo2", "gpt_neox", "llama_int8",
                                  "llama_low_rank",
                                  "llama_vocab_replicated"])
def test_tp2_matches_jax_tp2(ckpts, served, case):
    ckpt, mt, over = ckpts[case]
    toks, logits = served[case]
    jtoks, jlogits = _jax_generate(ckpt, mt, over)
    np.testing.assert_array_equal(toks, jtoks)
    for a, b in zip(logits, jlogits):
        np.testing.assert_allclose(a, b, **TOL)


def test_int8_ring_holds_to_the_fp32_collectives(ckpts, served):
    """The decode steps' row-parallel sums ride the int8 ring: the same
    greedy tokens as the port's fp32-collective stream at tp 2 and as the
    JAX package's int8-ring stream; decode logits within the reference's
    pin of the fp32 stream and within ``RING_JAX_TOL`` of the JAX int8
    stream, the prefill (the plain all-reduce) within the suite's
    tolerance of both; and the ring acted (the streams' logits part)."""
    ckpt, mt, over = ckpts["llama_ring_int8"]
    toks, logits = served["llama_ring_int8"]
    ftoks, flogits = served["llama"]
    jtoks, jlogits = _jax_generate(ckpt, mt, over)
    np.testing.assert_array_equal(toks, ftoks)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_allclose(logits[0], flogits[0], **TOL)
    np.testing.assert_allclose(logits[0], jlogits[0], **TOL)
    rel = [(np.abs(a - b).max() / np.abs(b).max(),
            np.abs(a - j).max() / np.abs(j).max())
           for a, b, j in zip(logits[1:], flogits[1:], jlogits[1:])]
    print("int8 ring decode logits vs fp32, vs JAX (of the top logit):",
          rel)
    for to_fp32, to_jax in rel:
        assert to_fp32 < APP_TOL_INT8
        assert to_jax < RING_JAX_TOL
    assert not all(np.allclose(a, b, **TOL)
                   for a, b in zip(logits[1:], flogits[1:]))


def test_int8_ring_with_equal_copies_matches_jax(ckpts, served,
                                                 monkeypatch):
    """With every rank holding the same copy of each ring sum (both
    packages' rings patched alike), the port's int8-ring stream equals the
    JAX package's within the suite's tolerance: the ring sits on the same
    sums (o_proj and down_proj, decode steps only), cuts the same chunks
    and rounds the same codes. A ring in the prefill, or one missing from
    a projection, parts them by the ring's own error (about 1% of the
    largest logit), far outside the tolerance."""
    monkeypatch.setattr(jcollectives, "quantized_all_reduce",
                        _jax_equal_copies_ring)
    ckpt, mt, over = ckpts["llama_ring_int8_equal"]
    toks, logits = served["llama_ring_int8_equal"]
    jtoks, jlogits = _jax_generate(ckpt, mt, over)
    np.testing.assert_array_equal(toks, jtoks)
    print("equal copies, logits vs JAX (of the top logit):",
          [np.abs(a - b).max() / np.abs(b).max()
           for a, b in zip(logits, jlogits)])
    for a, b in zip(logits, jlogits):
        np.testing.assert_allclose(a, b, **TOL)
    _, flogits = served["llama"]
    assert not all(np.allclose(a, b, **TOL)
                   for a, b in zip(logits[1:], flogits[1:]))


@pytest.mark.parametrize("case", ["llama_low_rank",
                                  "llama_vocab_replicated"])
def test_tp2_equals_port_tp1(ckpts, served, case):
    """A low-rank MLP (its rank-r intermediate summed over the group) and
    a replicated embedding (``vocab_parallel=False``: every rank looks up
    every id, no sum; the untied head still cut and gathered) at tp 2
    against the port's single-card app."""
    ckpt, mt, over = ckpts[case]
    app = torch_tp_ranks.build_app(ckpt, mt, dict(TCFG, **over))
    want = app.generate(_prompts(256), max_new_tokens=N_NEW,
                        return_logits=True)
    toks, logits = served[case]
    np.testing.assert_array_equal(toks, want["generated"])
    for a, b in zip(logits, want["logits"]):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
