"""The port's weight quantization (``modules/quantization.py``) against the
JAX package's: the quantizers bit for bit, the in-graph products, the set
of leaves a model quantizes, and the MoE block over quantized experts.

Inputs come from numpy seeds and go through both packages in fp32 (JAX
with ``jax_default_matmul_precision="highest"``, set by conftest). Codes
and scales are compared bit for bit; ``dequantize`` is exact on both
sides; products of the same dequantized weights agree to fp32 rounding
(atol 2e-3, rtol 1e-3: the suite's tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig as JTpuConfig
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.modules import moe as jmoe
from neuronx_distributed_inference_tpu.modules import quantization as jq
from neuronx_distributed_inference_tpu_torch.config import TpuConfig
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.modules import quantization as tq

TOL = dict(atol=2e-3, rtol=1e-3)
# (dtype, scheme) of every quantizer the reference has
SCHEMES = {
    "int8_tensor": (tq.INT8, tq.PER_TENSOR),
    "int8_channel": (tq.INT8, tq.PER_CHANNEL),
    "int8_blockwise": (tq.INT8, tq.BLOCKWISE),
    "fp8_tensor": (tq.FP8, tq.PER_TENSOR),
    "fp8_channel": (tq.FP8, tq.PER_CHANNEL),
    "fp8_blockwise": (tq.FP8, tq.BLOCKWISE),
    "mxfp4": (tq.MXFP4, tq.PER_CHANNEL),
}
GROUP = 16          # the blockwise group of the module-level cases


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _specs(name, group=GROUP):
    dtype, scheme = SCHEMES[name]
    g = 32 if dtype == tq.MXFP4 else group
    return (jq.QuantSpec(dtype, scheme, group_size=g),
            tq.QuantSpec(dtype, scheme, group_size=g))


def _stacked_weight(seed=0):
    """A stacked (L, E, K, N) = (2, 3, 64, 48) weight with the quantizers'
    traps planted: fp4 ties (0.25 -> 0, 2.5 -> 2, 0.75 -> 0.5, 5 -> 4),
    small negatives that round to 0 (code 8, -0.0), -0.0 itself, a group
    whose largest value is exactly 6 x 2^-5 (log2 exact), an all-zero
    matrix and an all-zero group."""
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((2, 3, 64, 48))).astype(np.float32)
    w[0, 0, :32, 0] = 0.0
    w[0, 0, :9, 0] = [6.0, 0.25, 2.5, 0.75, 5.0, 3.5, -0.01, -0.0, 1.25]
    w[0, 1, :32, 1] = 0.01
    w[0, 1, 3, 1] = 6 * 2.0 ** -5
    w[1, 2] = 0.0
    w[1, 1, 32:, 5] = 0.0
    return w


def _codes(leaf):
    """Comparable numpy bits of a leaf-group of either package."""
    out = {}
    for k, v in leaf.items():
        if isinstance(v, torch.Tensor):
            v = v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn else v
            out[k] = v.numpy()
        else:
            v = np.asarray(v)
            out[k] = v.view(np.uint8) if v.dtype.name == "float8_e4m3fn" \
                else v
    return out


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_quantize_tensor_bit_exact(name):
    """Every dtype and scheme on a stacked (L, E, K, N) leaf with ties,
    -0 and zero groups: the same code bytes, dtypes and scales."""
    jspec, tspec = _specs(name)
    w = _stacked_weight()
    want = _codes(jq.quantize_tensor(w, jspec))
    got_leaf = tq.quantize_tensor(torch.from_numpy(w), tspec)
    got = _codes(got_leaf)
    assert got["qweight"].dtype == want["qweight"].dtype
    assert got["scale"].dtype == np.float32
    assert got["qweight"].shape == want["qweight"].shape
    assert got["scale"].shape == want["scale"].shape
    np.testing.assert_array_equal(got["qweight"], want["qweight"])
    np.testing.assert_array_equal(got["scale"], want["scale"])
    assert tq._leaf_scheme(got_leaf) == jq._leaf_scheme(
        {k: jnp.asarray(v) for k, v in jq.quantize_tensor(w, jspec).items()})


def test_mxfp4_codes_at_ties_and_powers_of_two():
    """The fp4 rounding rule spelled out: a tie takes the smaller value,
    a small negative keeps the sign bit (code 8), and a group whose
    largest value is 6 x 2^k exactly gets the scale 2^k (log2 exact),
    one ulp above it 2^(k+1)."""
    w = np.zeros((64, 2), np.float32)
    w[:8, 0] = [6.0, 0.25, 2.5, 0.75, 5.0, 3.5, -0.01, 1.75]
    w[:32, 1] = 0.1
    w[0, 1] = np.nextafter(np.float32(6.0), np.float32(7.0))
    w[32:, 0] = 0.3
    w[32, 0] = 6 * 2.0 ** -4
    leaf = tq.quantize_mxfp4(torch.from_numpy(w))
    ref = jq.quantize_mxfp4(w)
    np.testing.assert_array_equal(leaf["qweight"].numpy(), ref["qweight"])
    np.testing.assert_array_equal(leaf["scale"].numpy(), ref["scale"])
    assert leaf["scale"][:, 0].tolist() == [1.0, 2.0 ** -4]
    assert leaf["scale"][0, 1].item() == 2.0
    low = (leaf["qweight"][:4, 0] & 0x0F).tolist()
    high = (leaf["qweight"][:4, 0] >> 4).tolist()
    # 6 -> 7, 0.25 -> 0, 2.5 -> 4 (value 2), 0.75 -> 1 (0.5), 5 -> 6 (4),
    # 3.5 -> 5 (3), -0.01 -> 8 (-0), 1.75 -> 3 (1.5)
    assert [low[0], high[0], low[1], high[1], low[2], high[2], low[3],
            high[3]] == [7, 0, 4, 1, 6, 5, 8, 3]


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_dequantize_and_products_match_reference(name):
    """``dequantize`` exactly; ``qlinear`` on one layer's (K, N) slice and
    ``qeinsum`` / ``qmatmul`` on one layer's expert stack at fp32
    tolerance."""
    jspec, tspec = _specs(name)
    w = _stacked_weight(1)
    jleaf = {k: jnp.asarray(v) for k, v in
             jq.quantize_tensor(w, jspec).items()}
    tleaf = tq.quantize_tensor(torch.from_numpy(w), tspec)
    np.testing.assert_array_equal(
        tq.dequantize(tleaf, torch.float32).numpy(),
        np.asarray(jq.dequantize(jleaf, jnp.float32)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    one_j = {k: v[0, 1] for k, v in jleaf.items()}
    one_t = {k: v[0, 1] for k, v in tleaf.items()}
    want = np.asarray(jq.qlinear(jnp.asarray(x), one_j))
    got = tq.qlinear(torch.from_numpy(x), one_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ex_j = {k: v[0] for k, v in jleaf.items()}
    ex_t = {k: v[0] for k, v in tleaf.items()}
    want = np.asarray(jq.qeinsum("bth,ehi->btei", jnp.asarray(x), ex_j))
    got = tq.qeinsum("bth,ehi->btei", torch.from_numpy(x), ex_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    flat = tq.qmatmul(torch.from_numpy(x).reshape(1, 10, 64), ex_t)
    np.testing.assert_allclose(
        flat.numpy().transpose(1, 0, 2).reshape(2, 5, 3, 48), want, **TOL)


# ---------------------------------------------------------------------------
# which leaves a model quantizes
# ---------------------------------------------------------------------------

LEAF_FAMILIES = {
    "llama": dict(model_type="llama", hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, vocab_size=256,
                  rms_norm_eps=1e-5, hidden_act="silu"),
    "qwen3_moe": dict(model_type="qwen3_moe", hidden_size=64,
                      intermediate_size=96, moe_intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16, vocab_size=256,
                      num_experts=4, num_experts_per_tok=2,
                      rms_norm_eps=1e-6),
    "gpt_oss": dict(model_type="gpt_oss", hidden_size=64,
                    intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    head_dim=16, vocab_size=256, sliding_window=8,
                    num_local_experts=4, num_experts_per_tok=2,
                    layer_types=["sliding_attention", "full_attention"],
                    rope_theta=150000.0, attention_bias=True,
                    hidden_act="silu"),
    "deepseek_v3": dict(model_type="deepseek_v3", hidden_size=64,
                        intermediate_size=128, moe_intermediate_size=32,
                        num_hidden_layers=3, num_attention_heads=4,
                        num_key_value_heads=4, n_routed_experts=8,
                        n_shared_experts=1, num_experts_per_tok=2,
                        first_k_dense_replace=1, n_group=2, topk_group=1,
                        q_lora_rank=None, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=16,
                        v_head_dim=16, vocab_size=256, hidden_act="silu",
                        norm_topk_prob=True, routed_scaling_factor=2.0,
                        scoring_func="sigmoid", topk_method="noaux_tc",
                        rms_norm_eps=1e-6, rope_theta=10000.0),
}


def _leaf_table(tree, dtype_name, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_table(v, dtype_name, prefix + k + "."))
        else:
            out[prefix + k] = (tuple(v.shape), dtype_name(v))
    return out


@pytest.mark.parametrize("family", sorted(LEAF_FAMILIES))
def test_quantized_leaf_set_matches_reference(family):
    """Both packages quantize the same leaves, with the same shapes and
    dtypes: ``q_proj`` / ``k_proj`` / ``v_proj`` are fused into
    ``qkv_proj`` before quantizing, so a non-MLA model keeps its attention
    projection in full precision and quantizes ``o_proj``, the MLPs, the
    experts and the shared experts; MLA quantizes its bare ``q_proj``.
    Routers, norms, biases, the embedding and ``lm_head`` stay plain."""
    hf = LEAF_FAMILIES[family]
    kw = dict(batch_size=1, seq_len=32, dtype="float32", quantized=True,
              quantization_dtype="int8")
    jfam = j_get_family(hf["model_type"])
    japp = JApp(None, jfam.config_cls(JTpuConfig(**kw), **hf), jfam)
    japp.init_random_weights(0)
    tfam = get_family(hf["model_type"])
    tapp = CausalLMApplication(None, tfam.config_cls(TpuConfig(**kw), **hf),
                               tfam, device="cpu")
    tapp.init_random_weights(0)
    want = _leaf_table(jax.tree.map(np.asarray, japp.params,
                                    is_leaf=lambda n: not isinstance(n,
                                                                     dict)),
                       lambda v: np.asarray(v).dtype.name)
    got = _leaf_table(tapp.params,
                      lambda v: str(v.dtype).replace("torch.", ""))
    assert {k for k in got if k.endswith(".qweight")} == \
        {k for k in want if k.endswith(".qweight")}
    assert got.keys() == want.keys()
    for k in got:
        if k.endswith((".qweight", ".scale")):
            assert got[k] == want[k], k
        else:
            assert got[k][0] == want[k][0], k
    quantized = {k.rsplit(".", 2)[-2] for k in got if k.endswith(".qweight")}
    assert "qkv_proj" not in quantized and "router" not in quantized
    assert "o_proj" in quantized
    if family == "deepseek_v3":
        assert {"q_proj", "shared_gate", "expert_gate"} <= quantized


# ---------------------------------------------------------------------------
# the MoE block over quantized experts
# ---------------------------------------------------------------------------

MB, MT, MH, ME, MI = 2, 5, 64, 4, 64
MOE_SCHEMES = ("int8_channel", "fp8_blockwise", "mxfp4")


def _moe_weights(seed, name):
    """One MoE layer's weights (fp32 router and biases, experts and
    shared experts quantized by the reference) as numpy / JAX trees."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.3):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    fp = {"router": f(MH, ME, scale=1.0), "expert_gate": f(ME, MH, MI),
          "expert_up": f(ME, MH, MI), "expert_down": f(ME, MI, MH),
          "expert_gate_bias": f(ME, MI, scale=0.1),
          "expert_up_bias": f(ME, MI, scale=0.1),
          "expert_down_bias": f(ME, MH, scale=0.1),
          "shared_gate": f(MH, MI), "shared_up": f(MH, MI),
          "shared_down": f(MI, MH)}
    jspec, _ = _specs(name, group=32)
    return jq.quantize_params(fp, jspec)


def _to_torch(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v)
        else:
            v = np.asarray(v)
            if v.dtype.name == "float8_e4m3fn":
                out[k] = torch.from_numpy(v.view(np.uint8).copy()).view(
                    torch.float8_e4m3fn)
            else:
                out[k] = torch.from_numpy(v.copy())
    return out


@pytest.mark.parametrize("name", MOE_SCHEMES)
@pytest.mark.parametrize("dense_max_tokens", [64, 0], ids=["dense",
                                                           "ragged"])
def test_moe_block_quantized_matches_jax(dense_max_tokens, name):
    """The MoE block with quantized experts (biases, clamped GLU) and
    quantized shared experts on the dense path (the ``qeinsum`` scale
    rule on the (E, B·T, ·) layout) and the ragged path (dequantize, then
    the grouped product) against the JAX block."""
    host = _moe_weights(5, name)
    x = np.random.default_rng(6).standard_normal((MB, MT, MH)).astype(
        np.float32)
    kw = dict(num_experts=ME, top_k=2, intermediate_size=MI,
              expert_bias=True, glu_style="oss_clamp",
              shared_intermediate=MI, dense_max_tokens=dense_max_tokens)
    want = jmoe.moe_block(jmoe.MoESpec(**kw), jnp.asarray(x),
                          jax.tree.map(jnp.asarray, host))
    got = tmoe.moe_block(tmoe.MoESpec(**kw), torch.from_numpy(x),
                         _to_torch(host))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_cuda_quantize_matches_cpu(name):
    """On the card: the quantizer's codes and scales equal the CPU's, and
    ``qlinear`` agrees with the CPU product (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    _, tspec = _specs(name)
    w = torch.from_numpy(_stacked_weight(3))
    cpu = tq.quantize_tensor(w, tspec)
    card = tq.quantize_tensor(w.cuda(), tspec)
    for k in ("qweight", "scale"):
        np.testing.assert_array_equal(_codes({k: card[k].cpu()})[k],
                                      _codes({k: cpu[k]})[k])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 64)).astype(np.float32))
    one = {k: v[1, 0] for k, v in card.items()}
    np.testing.assert_allclose(
        tq.qlinear(x.cuda(), one).cpu().numpy(),
        tq.qlinear(x, {k: v[1, 0] for k, v in cpu.items()}).numpy(), **TOL)
