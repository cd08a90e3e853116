"""The contrib hub's second-wave dense families of the port (GPT-J,
CodeGen, GPT-Neo, GPT-BigCode, OPT, BioGPT, XGLM, Helium, ERNIE 4.5,
Seed-OSS, Arcee, Nemotron, SmolLM3, Cohere2, EXAONE 4.0) against the JAX
package's, through the checks of test_torch_contrib_dense.py: specs field
for field, converted trees leaf for leaf, fp32 logits at atol=2e-3,
rtol=1e-3 and greedy tokens identical on the contiguous app, with a
control per knob the family leans on (the knob removed from the port's
spec parts from JAX).

The tiny HF configs are the reference's own (tests/test_contrib_hub2.py:
12-185 and 322-330: hidden 64, 4 heads, vocab 256), every weight redrawn
as test_torch_contrib_dense.hf_model does. Then the combinations this
wave adds on the paged app and the ragged engine (GPT-Neo's windowed
local layers with learned positions, Cohere2's windowed + NoPE layers),
the multi-query families at a group over 16 (Falcon and GPT-BigCode at 17
query heads of 64 over one KV head) reaching the decode kernels'
wrappers, and speculation refused over the learned-position families."""

import dataclasses

import numpy as np
import pytest

from neuronx_distributed_inference_tpu_torch.ops import decode_attention
from test_torch_contrib_dense import (CONTIG, EXPECT, ROTARY,  # noqa: F401
                                      VARIANTS, _no_tf32, assert_logits_close,
                                      check_contiguous, check_spec_and_tree,
                                      CONTROLS, make_apps, save_ckpts)
from test_torch_dense_families import ids_of
from test_torch_serving_engine import _serve

NO_DROP = dict(attention_dropout=0.0, torch_dtype="float32")
GPT_DROP = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                torch_dtype="float32")
LLAMA_SHAPE = dict(NO_DROP, hidden_size=64, num_attention_heads=4,
                   num_key_value_heads=2, num_hidden_layers=3,
                   intermediate_size=128, vocab_size=256)
WAVE2_VARIANTS = {
    "gptj": ("GPTJForCausalLM", "GPTJConfig", "gptj", dict(
        GPT_DROP, n_embd=64, n_head=4, n_layer=3, n_positions=128,
        rotary_dim=8, vocab_size=256)),
    "codegen": ("CodeGenForCausalLM", "CodeGenConfig", "codegen", dict(
        GPT_DROP, n_embd=64, n_head=4, n_layer=3, n_positions=128,
        rotary_dim=8, vocab_size=256)),
    "gpt_neo": ("GPTNeoForCausalLM", "GPTNeoConfig", "gpt_neo", dict(
        hidden_size=64, num_heads=4, num_layers=4,
        attention_types=[[["global", "local"], 2]], window_size=8,
        vocab_size=256, max_position_embeddings=128, resid_dropout=0.0,
        embed_dropout=0.0, attention_dropout=0.0, torch_dtype="float32")),
    "gpt_bigcode": ("GPTBigCodeForCausalLM", "GPTBigCodeConfig",
                    "gpt_bigcode", dict(
                        GPT_DROP, n_embd=64, n_head=4, n_layer=3,
                        n_positions=128, multi_query=True, vocab_size=256)),
    "opt": ("OPTForCausalLM", "OPTConfig", "opt", dict(
        hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        ffn_dim=128, vocab_size=256, max_position_embeddings=128,
        word_embed_proj_dim=64, do_layer_norm_before=True, dropout=0.0,
        attention_dropout=0.0, torch_dtype="float32")),
    "biogpt": ("BioGptForCausalLM", "BioGptConfig", "biogpt", dict(
        hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        intermediate_size=128, vocab_size=256, max_position_embeddings=128,
        scale_embedding=True, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, activation_dropout=0.0,
        torch_dtype="float32")),
    "xglm": ("XGLMForCausalLM", "XGLMConfig", "xglm", dict(
        d_model=64, attention_heads=4, num_layers=3, ffn_dim=128,
        vocab_size=256, max_position_embeddings=128, dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0,
        scale_embedding=True, torch_dtype="float32")),
    "helium": ("HeliumForCausalLM", "HeliumConfig", "helium", dict(
        LLAMA_SHAPE, head_dim=16)),
    "ernie4_5": ("Ernie4_5ForCausalLM", "Ernie4_5Config", "ernie4_5", dict(
        LLAMA_SHAPE, tie_word_embeddings=True)),
    "seed_oss": ("SeedOssForCausalLM", "SeedOssConfig", "seed_oss", dict(
        LLAMA_SHAPE, head_dim=16, attention_bias=True)),
    "arcee": ("ArceeForCausalLM", "ArceeConfig", "arcee", dict(
        LLAMA_SHAPE, hidden_act="relu2")),
    "nemotron": ("NemotronForCausalLM", "NemotronConfig", "nemotron", dict(
        LLAMA_SHAPE, hidden_act="relu2", partial_rotary_factor=0.5,
        hidden_dropout=0.0)),
    "smollm3": ("SmolLM3ForCausalLM", "SmolLM3Config", "smollm3", dict(
        LLAMA_SHAPE, num_hidden_layers=4, pad_token_id=0,
        no_rope_layer_interval=2, tie_word_embeddings=True)),
    "cohere2": ("Cohere2ForCausalLM", "Cohere2Config", "cohere2", dict(
        LLAMA_SHAPE, num_hidden_layers=4, sliding_window=8,
        sliding_window_pattern=2,
        layer_types=["sliding_attention", "full_attention"] * 2,
        logit_scale=0.25)),
    "exaone4": ("Exaone4ForCausalLM", "Exaone4Config", "exaone4", dict(
        LLAMA_SHAPE, num_hidden_layers=4, head_dim=16, sliding_window=8,
        layer_types=["sliding_attention"] * 3 + ["full_attention"])),
}
# the multi-query families at a group over 16 (17 query heads of 64 over
# one KV head): the decode kernels' widened gate
WAVE2_VARIANTS["falcon_g17_d64"] = (
    "FalconForCausalLM", "FalconConfig", "falcon", dict(
        NO_DROP, hidden_size=17 * 64, num_attention_heads=17,
        num_hidden_layers=2, vocab_size=256, multi_query=True,
        parallel_attn=True, new_decoder_architecture=False, bias=False,
        alibi=False, hidden_dropout=0.0))
WAVE2_VARIANTS["gpt_bigcode_g17_d64"] = (
    "GPTBigCodeForCausalLM", "GPTBigCodeConfig", "gpt_bigcode", dict(
        WAVE2_VARIANTS["gpt_bigcode"][3], n_embd=17 * 64, n_head=17,
        n_layer=2, n_inner=256))
VARIANTS.update(WAVE2_VARIANTS)
WAVE2 = tuple(n for n in WAVE2_VARIANTS if "_g17_" not in n)
EXPECT.update({
    "gptj": dict(block_style="parallel_shared", rope_interleaved=True,
                 lm_head_bias=True, mlp_glu=False),
    "codegen": dict(block_style="parallel_shared", rope_interleaved=True),
    "gpt_neo": dict(layer_pattern=(False, True, False, True),
                    sliding_window=8, no_rope=True, attn_scale=1.0,
                    learned_pos=128),
    "gpt_bigcode": dict(num_kv_heads=1, no_rope=True, qkv_bias=True,
                        learned_pos=128),
    "opt": dict(act="relu", learned_pos=128, qkv_bias=True),
    "biogpt": dict(embed_scale=8.0, learned_pos=128),
    "xglm": dict(embed_scale=8.0, learned_pos=128),
    "helium": dict(head_dim=16),
    "ernie4_5": dict(tie_word_embeddings=True),
    "seed_oss": dict(qkv_bias=True, o_bias=True),
    "arcee": dict(act="relu2", mlp_glu=False),
    "nemotron": dict(norm_type="layernorm", mlp_glu=False),
    "smollm3": dict(layer_pattern=(True, False, True, False),
                    nope_global=True, tie_word_embeddings=True),
    "cohere2": dict(layer_pattern=(True, False, True, False),
                    block_style="parallel_shared", nope_global=True,
                    sliding_window=8, logits_divide=4.0),
    "exaone4": dict(norm_position="post", qk_norm=True, sandwich_norm=True,
                    layer_pattern=(True, True, True, False),
                    nope_global=True),
})
ROTARY.update({"gptj": 8, "codegen": 8, "nemotron": 8})
CONTROLS.update({
    "gptj": (dict(rope_interleaved=False),),
    "codegen": (dict(rope_interleaved=False),),
    "gpt_neo": (dict(attn_scale=None),),
    "biogpt": (dict(embed_scale=None),),
    "smollm3": (dict(nope_global=False),),
    "cohere2": (dict(nope_global=False),),
    "exaone4": (dict(nope_global=False),),
})
LEARNED = ("gpt_neo", "gpt_bigcode", "opt", "biogpt", "xglm")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory, WAVE2)


@pytest.mark.parametrize("name", WAVE2)
def test_spec_and_converter_match_jax(ckpts, name):
    """:func:`check_spec_and_tree` for the wave: the fused q/k/v splits
    (GPT-BigCode's multi-query ``c_attn``, CodeGen's [q | v | k] blocks),
    the position tables offset by 2, Nemotron's w + 1 norms, the filled-in
    Seed-OSS ``o_proj`` bias and EXAONE's unit pre-norms leaf for leaf."""
    check_spec_and_tree(ckpts, name)


@pytest.mark.parametrize("name", WAVE2)
def test_contiguous_logits_and_greedy_match_jax(ckpts, name):
    """:func:`check_contiguous` for the wave (the controls of GPT-J's
    interleaved rotation, GPT-Neo's unit scale, BioGPT's embedding scale
    and the NoPE global layers of SmolLM3, Cohere2 and EXAONE 4.0)."""
    check_contiguous(ckpts, name)


def test_xglm_synthesizes_its_sinusoidal_table(ckpts):
    """A checkpoint without XGLM's non-persistent position buffer converts
    to the same table in both packages (the synthesized sinusoids, offset
    by 2), and to the table HF itself computes (in fp32 from positions up
    to 129: 2e-5)."""
    from neuronx_distributed_inference_tpu.models.family import \
        get_family as j_get_family
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    from test_torch_contrib_dense import _specs
    from neuronx_distributed_inference_tpu_torch.utils import checkpoint
    tspec, jspec = _specs(ckpts["xglm"], "xglm")
    sd = checkpoint.load_state_dict(ckpts["xglm"])
    assert "model.embed_positions.weights" not in sd
    got = get_family("xglm").convert_hf_state_dict(sd, tspec)["pos_embed"]
    want = j_get_family("xglm").convert_hf_state_dict(sd, jspec)["pos_embed"]
    np.testing.assert_array_equal(got, want)
    from test_torch_contrib_dense import hf_model
    hf = hf_model("xglm")
    table = hf.model.embed_positions.weights.detach().numpy()
    np.testing.assert_allclose(got, table[2:2 + got.shape[0]], atol=2e-5)


PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True)
RNG = np.random.default_rng(43)
PROMPTS = [RNG.integers(1, 256, size=n).tolist() for n in (11, 23, 30)]


def _spy(monkeypatch):
    """Record (layer, window, group) of every paged-kernel wrapper call."""
    calls = set()
    orig = decode_attention.paged_decode_attention

    def spy(*a, **k):
        calls.add((int(a[5]), int(k.get("window", 0)),
                   a[0].shape[1] // a[3].shape[1]))
        return orig(*a, **k)
    monkeypatch.setattr(decode_attention, "paged_decode_attention", spy)
    return calls


def _paged_and_served(ckpt, name, calls):
    """The paged app's ``generate`` against JAX's (logits and greedy
    tokens), then the ragged engine's streams (prefill chunks of 16)
    against the JAX engine's."""
    japp, tapp = make_apps(ckpt, name, PAGED, paged=True)
    ids, mask = ids_of([20, 13], seed=5)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=8,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=8,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    japp.init_cache()
    tapp.init_cache()
    subs = [(p, n, "default") for p, n in zip(PROMPTS, (6, 5, 4))]
    jserved = _serve(japp, "jax", True, subs, chunk=16)
    served = _serve(tapp, "port", True, subs, chunk=16)
    assert served[:3] == jserved[:3]
    assert [len(t) for t in served[0]] == [6, 5, 4]
    return tapp


@pytest.mark.parametrize("name", ["gpt_neo", "cohere2"])
def test_windowed_patterns_paged_and_ragged_match_jax(ckpts, name,
                                                      monkeypatch):
    """The wave's new combinations over the paged cache: GPT-Neo's local
    layers (window 8) with learned positions read at the paged positions,
    Cohere2's windowed RoPE layers beside NoPE global ones. Prompts of 11-30
    tokens run past the window. Head_dim 16 keeps every step on the
    gather paths in both packages (no kernel call); the contiguous app of
    GPT-Neo holds the mixed cache (the local layers' rolling rows)."""
    calls = _spy(monkeypatch)
    _paged_and_served(ckpts[name], name, calls)
    assert calls == set()
    if name == "gpt_neo":
        _, tapp = make_apps(ckpts[name], name)
        assert {"k", "v", "k_l", "v_l"} <= set(tapp.cache)


@pytest.fixture(scope="module")
def wide_ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory,
                      ("falcon_g17_d64", "gpt_bigcode_g17_d64"))


@pytest.mark.parametrize("name", ["falcon_g17_d64", "gpt_bigcode_g17_d64"])
def test_group_over_16_reaches_the_decode_kernels(wide_ckpts, name,
                                                  monkeypatch):
    """Falcon-7B's and GPT-BigCode's shape at a tiny width (17 query heads
    of 64 over one KV head, G 17): the decode gates admit it (no group
    term, as the reference's), the paged app's T = 1 steps call the paged
    kernel's wrapper at every layer with G 17 (its twin here, the
    reference's Pallas kernel in interpret mode), and logits, greedy tokens
    and the ragged engine's streams match JAX's; the contiguous app takes
    the contiguous kernel's wrapper at both layers with the same
    logits."""
    from neuronx_distributed_inference_tpu_torch.models import model_base
    import torch
    calls = _spy(monkeypatch)
    tapp = _paged_and_served(wide_ckpts[name], name, calls)
    assert tapp.spec.gqa.q_per_kv == 17
    assert model_base.use_decode_kernel(tapp.spec, 1, torch.float32)
    assert calls == {(0, 0, 17), (1, 0, 17)}
    stacked = []
    orig = decode_attention.decode_attention_stacked

    def spy(*a, **k):
        stacked.append((int(a[5]), a[0].shape[1] // a[3].shape[1]))
        return orig(*a, **k)
    monkeypatch.setattr(decode_attention, "decode_attention_stacked", spy)
    tcfg = dict(CONTIG, attn_block_tkg_kernel_enabled=True)
    japp, tapp = make_apps(wide_ckpts[name], name, tcfg)
    ids, mask = ids_of([20, 13], seed=3)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=4,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=4,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], name)
    assert set(stacked) == {(0, 17), (1, 17)}


@pytest.mark.parametrize("name", LEARNED)
def test_speculation_refuses_learned_position_families(ckpts, name):
    """Speculation over the wave's learned-position families stays
    refused (the reference's tree and EAGLE forwards embed with no
    positions): every tree decoder over the target and an EAGLE decoder
    with it as the draft raise NotImplementedError; the same spec without
    its table passes the tree check."""
    from neuronx_distributed_inference_tpu_torch.models import speculation
    _, app = make_apps(ckpts[name], name)
    assert app.spec.learned_pos
    for build in (lambda: speculation.MedusaTreeDecoder(app),
                  lambda: speculation.DynamicTreeDecoder(app),
                  lambda: speculation.EagleTreeDecoder(
                      app, app.spec, app.params, app.cache),
                  lambda: speculation.EagleDecoder(
                      app, app.spec, app.params, app.cache)):
        with pytest.raises(NotImplementedError,
                           match="learned position table"):
            build()
    speculation._refuse_tree_target(dataclasses.replace(app.spec,
                                                        learned_pos=0))
