"""The contrib hub's third-wave dense families of the port (VaultGemma,
MiniCPM / MiniCPM4, Orion, InternLM3, OLMo-3) against the JAX package's,
through the checks of test_torch_contrib_dense.py: specs field for field,
converted trees leaf for leaf, fp32 logits at atol=2e-3, rtol=1e-3 and
greedy tokens identical on the contiguous app.

VaultGemma's and OLMo-3's tiny configs are the reference's own
(tests/test_contrib_hub3.py:58-72, :104-118). MiniCPM, Orion and
InternLM3 ship as remote code, so, as the reference's tests do
(tests/test_contrib_hub3.py:133-260), their checkpoints are a tiny Llama,
StableLM (full rotary, no q/k/v bias) and Qwen2 saved with the family's
``model_type`` and knobs written into config.json. Each knob the family
adds carries a control: the port with the knob removed parts from JAX."""

import json

import pytest

from test_torch_contrib_dense import (CONTROLS, EXPECT,  # noqa: F401
                                      VARIANTS, _no_tf32, check_contiguous,
                                      check_spec_and_tree, save_ckpt)

LLAMA_TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=2,
                  vocab_size=256, max_position_embeddings=128,
                  attention_dropout=0.0, torch_dtype="float32")
HUB3B_VARIANTS = {
    "vaultgemma": ("VaultGemmaForCausalLM", "VaultGemmaConfig",
                   "vaultgemma", dict(
                       hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=16,
                       num_hidden_layers=4, intermediate_size=128,
                       vocab_size=256, sliding_window=16,
                       attn_logit_softcapping=50.0,
                       final_logit_softcapping=30.0,
                       query_pre_attn_scalar=16,
                       layer_types=["sliding_attention",
                                    "full_attention"] * 2,
                       max_position_embeddings=128, torch_dtype="float32")),
    "olmo3": ("Olmo3ForCausalLM", "Olmo3Config", "olmo3", dict(
        LLAMA_TINY, num_hidden_layers=4, sliding_window=8,
        layer_types=["sliding_attention"] * 3 + ["full_attention"])),
    "minicpm": ("LlamaForCausalLM", "LlamaConfig", "minicpm", LLAMA_TINY),
    "minicpm4": ("LlamaForCausalLM", "LlamaConfig", "minicpm4", LLAMA_TINY),
    "orion": ("StableLmForCausalLM", "StableLmConfig", "orion", dict(
        LLAMA_TINY, partial_rotary_factor=1.0, use_qkv_bias=False,
        use_parallel_residual=False)),
    "internlm3": ("Qwen2ForCausalLM", "Qwen2Config", "internlm3",
                  LLAMA_TINY),
}
# config.json rewritten as the remote-code family's (the reference tests'
# knobs; MiniCPM4 at other scalings)
RENAMED = {
    "minicpm": dict(model_type="minicpm", scale_emb=4.0, scale_depth=1.4,
                    dim_model_base=32),
    "minicpm4": dict(model_type="minicpm4", scale_emb=12.0,
                     scale_depth=1.4, dim_model_base=16),
    "orion": dict(model_type="orion"),
    "internlm3": dict(model_type="internlm3", qkv_bias=True, bias=False),
}
VARIANTS.update(HUB3B_VARIANTS)
HUB3B = tuple(HUB3B_VARIANTS)
EXPECT.update({
    "vaultgemma": dict(layer_pattern=(True, False, True, False),
                       attn_soft_cap=50.0, logits_soft_cap=30.0,
                       norm_offset=1.0, sandwich_norm=False, embed_scale=8.0),
    "olmo3": dict(qk_norm_full=True, norm_position="post",
                  sandwich_norm=True, layer_pattern=(True, True, True, False),
                  sliding_window=8),
    "minicpm": dict(embed_scale=4.0, logits_divide=2.0),
    "minicpm4": dict(embed_scale=12.0, logits_divide=4.0),
    "orion": dict(norm_type="layernorm", norm_bias=True, qkv_bias=False),
    "internlm3": dict(qkv_bias=True, o_bias=False, mlp_bias=False),
})
CONTROLS.update({
    "vaultgemma": (dict(attn_soft_cap=None, logits_soft_cap=None),),
    "minicpm": (dict(residual_multiplier=1.0), dict(logits_divide=None)),
    "minicpm4": (dict(embed_scale=None),),
    "olmo3": (dict(layer_pattern=None, mixed_kv=False),),
})


def save_hub3b(d, name):
    """The tiny checkpoint of ``name``, config.json rewritten as the
    remote-code family's where it is one."""
    save_ckpt(d, name)
    if name in RENAMED:
        cj = json.loads((d / "config.json").read_text())
        cj.update(RENAMED[name])
        (d / "config.json").write_text(json.dumps(cj))
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {name: save_hub3b(tmp_path_factory.mktemp(name), name)
            for name in HUB3B}


@pytest.mark.parametrize("name", HUB3B)
def test_spec_and_converter_match_jax(ckpts, name):
    """:func:`check_spec_and_tree` for the wave (MiniCPM's residual
    multiplier scale_depth / sqrt(L) among the spec's fields)."""
    check_spec_and_tree(ckpts, name)


@pytest.mark.parametrize("name", HUB3B)
def test_contiguous_logits_and_greedy_match_jax(ckpts, name):
    """:func:`check_contiguous` for the wave (the controls of
    VaultGemma's soft caps, MiniCPM's scalings and OLMo-3's sliding
    layers)."""
    check_contiguous(ckpts, name)
