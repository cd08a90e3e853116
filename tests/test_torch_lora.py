"""Multi-LoRA of the port (``modules/lora.py``, the stacked factors of
``models/model_base.py`` and the application's LoRA methods) against the
JAX package's, on the CPU.

Geometry: ``conftest.tiny_llama_hf_config()`` (hidden 64, 4 layers, 4 q /
2 kv heads of 16) on the contiguous app, fp32, and tiny Qwen2 / OLMo-2 /
DBRX checkpoints whose q/k/v bias, full-width q/k norm and q/k/v clamp
make the order of the adapter delta against them visible. Adapter factors
are drawn from numpy seeds and written into the same slots of both apps
(``write_lora_slot``), or read from PEFT directories written into
``tmp_path`` (as tests/test_lora.py does). Tolerances: fp32 logits at
atol=2e-3, rtol=1e-3 and greedy tokens equal; ``lora_delta`` at atol 1e-6
in fp32 and one bf16 ulp in bf16; slot 0 against a LoRA-free build
exactly."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_llama_hf_config
from neuronx_distributed_inference_tpu.config import (
    LoraServingConfig as JLora, TpuConfig as JTpuConfig,
    load_pretrained_config as j_load_config)
from neuronx_distributed_inference_tpu.models import model_base as jmb
from neuronx_distributed_inference_tpu.models.application import \
    CausalLMApplication as JApp
from neuronx_distributed_inference_tpu.models.family import \
    get_family as j_get_family
from neuronx_distributed_inference_tpu.modules import lora as jlora
from neuronx_distributed_inference_tpu_torch.config import (
    LoraServingConfig, TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.models.application import \
    CausalLMApplication
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.modules import lora
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy

LOGIT_TOL = dict(atol=2e-3, rtol=1e-3)
ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")
QV = ("q_proj", "v_proj")
CONTIG = dict(batch_size=2, seq_len=48, dtype="float32", output_logits=True,
              enable_bucketing=False)
RANK = 4


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def lora_cfgs(targets, max_loras=3, rank=RANK, **kw):
    """The same LoRA serving config in both packages' classes."""
    fields = dict(max_loras=max_loras, max_lora_rank=rank,
                  target_modules=list(targets), **kw)
    return JLora(**fields), LoraServingConfig(**fields)


def adapter_arrays(app, seed, scale=0.3):
    """Random factors in the ``lora_adapter_arrays`` layout ({module:
    (A (L, in, r), B (L, r, out))}) for every module with leaves in the
    port app's tree."""
    rng = np.random.default_rng(seed)
    L = app.spec.num_layers
    out = {}
    for mod in app.spec.lora.target_modules:
        shapes = [d[f"lora_A_{mod}"].shape + d[f"lora_B_{mod}"].shape
                  for d in app.params.values()
                  if isinstance(d, dict) and f"lora_A_{mod}" in d]
        if not shapes:
            continue
        _, _, d_in, r, _, _, _, d_out = shapes[0]
        out[mod] = ((scale * rng.standard_normal((L, d_in, r))).astype(
            np.float32), (scale * rng.standard_normal((L, r, d_out))).astype(
                np.float32))
    return out


def jax_write(japp, slot, arrays):
    """The JAX app's ``write_lora_slot`` over the modules its tree holds
    (the reference writes ``params["layers"]`` only)."""
    lw = japp.params["layers"]
    japp.write_lora_slot(slot, {m: ab for m, ab in arrays.items()
                                if f"lora_A_{m}" in lw})


def llama_pair(targets=QV, lora_on=True, **hf_over):
    """(JAX app, port app) of the tiny Llama, the port holding the JAX
    tree (LoRA leaves included) through ``params_from_numpy``."""
    hf = tiny_llama_hf_config(**hf_over)
    jl, tl = lora_cfgs(targets) if lora_on else (None, None)
    fam_j, fam_t = j_get_family("llama"), get_family("llama")
    japp = JApp(None, fam_j.config_cls(JTpuConfig(**CONTIG, lora_config=jl),
                                       **hf), fam_j)
    japp.init_random_weights(seed=0).init_cache()
    tapp = CausalLMApplication(
        None, fam_t.config_cls(TpuConfig(**CONTIG, lora_config=tl), **hf),
        fam_t, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    return japp, tapp.init_cache()


def prompts(seed=0, lens=(9, 14), vocab=500):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def run_both(japp, tapp, ids, mask, aids, n=5):
    japp.reset()
    tapp.reset()
    j = japp.generate(ids, attention_mask=mask, max_new_tokens=n,
                      adapter_ids=aids, return_logits=True)
    t = tapp.generate(ids, attention_mask=mask, max_new_tokens=n,
                      adapter_ids=aids, return_logits=True)
    return j, t


def assert_same(j, t):
    assert len(j["logits"]) == len(t["logits"]) > 0
    for a, b in zip(j["logits"], t["logits"]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **LOGIT_TOL)
    np.testing.assert_array_equal(t["generated"], np.asarray(j["generated"]))


# ---------------------------------------------------------------------------
# lora_delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(3)
    # activations and factors at the scale of a served layer (deltas of
    # order 0.1), where fp32 rounding is far inside 1e-6
    x = (0.1 * rng.standard_normal((3, 5, 32))).astype(np.float32)
    a = (0.3 * rng.standard_normal((4, 32, 8))).astype(np.float32)
    b = (0.3 * rng.standard_normal((4, 8, 24))).astype(np.float32)
    ids = np.array([1, 3, 0], np.int32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jlora.lora_delta(
        jnp.asarray(x, jdt), jnp.asarray(a, jdt), jnp.asarray(b, jdt),
        jnp.asarray(ids)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = lora.lora_delta(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(a).to(tdt),
                          torch.from_numpy(b).to(tdt),
                          torch.from_numpy(ids))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        # one bf16 ulp of the larger magnitude (8 bits of mantissa)
        ulp = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7
        assert np.all(np.abs(got - want) <= ulp + 1e-30)
    # row 2 gathers slot 0 of a random A/B: the delta is not zero, and the
    # rows pick their own slots (a shuffled id set parts)
    alt = lora.lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b),
                          torch.from_numpy(ids[::-1].copy())).numpy()
    assert not np.allclose(alt, want, atol=1e-2)


# ---------------------------------------------------------------------------
# PEFT directories
# ---------------------------------------------------------------------------

def write_peft_adapter(path, hf, r=2, alpha=4.0, seed=0, modules=QV):
    """A PEFT-format adapter directory with random weights (the layout of
    tests/test_lora.py:81-110)."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(seed)
    H, I = hf["hidden_size"], hf["intermediate_size"]
    nq, nkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    D = H // nq
    out_dims = {"q_proj": nq * D, "k_proj": nkv * D, "v_proj": nkv * D,
                "o_proj": H, "gate_proj": I, "up_proj": I, "down_proj": H}
    in_dims = {"o_proj": nq * D, "down_proj": I}
    sd = {}
    for i in range(hf["num_hidden_layers"]):
        for m in modules:
            blk = "self_attn" if m[0] in "qkvo" else "mlp"
            pre = f"base_model.model.model.layers.{i}.{blk}.{m}"
            sd[f"{pre}.lora_A.weight"] = (0.3 * rng.standard_normal(
                (r, in_dims.get(m, H)))).astype(np.float32)
            sd[f"{pre}.lora_B.weight"] = (0.3 * rng.standard_normal(
                (out_dims[m], r))).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    save_file(sd, str(path / "adapter_model.safetensors"))
    with open(path / "adapter_config.json", "w") as f:
        json.dump({"r": r, "lora_alpha": alpha,
                   "target_modules": list(modules)}, f)
    return sd


def test_peft_load_and_arrays_match_jax(tmp_path):
    hf = tiny_llama_hf_config()
    write_peft_adapter(tmp_path / "ad", hf, seed=1, modules=ALL7)
    sd_t, cfg_t = lora.load_peft_adapter(str(tmp_path / "ad"))
    sd_j, cfg_j = jlora.load_peft_adapter(str(tmp_path / "ad"))
    assert cfg_t == cfg_j and sorted(sd_t) == sorted(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], np.asarray(sd_j[k]))
    japp, tapp = llama_pair(ALL7)
    want = japp.lora_adapter_arrays(str(tmp_path / "ad"))
    got = tapp.lora_adapter_arrays(str(tmp_path / "ad"))
    assert sorted(got) == sorted(want) == sorted(ALL7)
    for m in ALL7:
        for g, w in zip(got[m], want[m]):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    # alpha / r = 2 is folded into B; the rank is zero-padded to 4
    assert not got["q_proj"][0][:, :, 2:].any()
    with pytest.raises(FileNotFoundError):
        lora.load_peft_adapter(str(tmp_path))


# ---------------------------------------------------------------------------
# the contiguous generate under adapters, per family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family_ckpts(tmp_path_factory):
    """Tiny Qwen2 (q/k/v bias), OLMo-2 (full-width q/k norm) and DBRX
    (q/k/v clamp) checkpoints: the families whose knobs sit next to the
    q/k/v adapter deltas."""
    from test_torch_dbrx import hf_dbrx, VARIANTS as DBRX
    from test_torch_dense_families import hf_model
    out = {}
    for name in ("qwen2", "olmo2"):
        d = tmp_path_factory.mktemp("lora_" + name)
        hf_model(name).save_pretrained(d, safe_serialization=True)
        out[name] = str(d)
    d = tmp_path_factory.mktemp("lora_dbrx")
    hf_dbrx(DBRX["tiny"]).save_pretrained(d, safe_serialization=True)
    out["dbrx"] = str(d)
    return out


def family_pair(ckpt, model_type, targets):
    jl, tl = lora_cfgs(targets)
    jfam, tfam = j_get_family(model_type), get_family(model_type)
    japp = JApp(ckpt, jfam.config_cls(JTpuConfig(**CONTIG, lora_config=jl),
                                      load_config=j_load_config(ckpt)), jfam)
    tapp = CausalLMApplication(
        ckpt, tfam.config_cls(TpuConfig(**CONTIG, lora_config=tl),
                              load_config=load_pretrained_config(ckpt)),
        tfam, device="cpu")
    return (japp.load_weights().init_cache(),
            tapp.load_weights().init_cache())


@pytest.mark.parametrize("family", ["llama", "qwen2", "olmo2", "dbrx"])
@pytest.mark.parametrize("targets", [QV, ALL7], ids=["qv", "all7"])
def test_contiguous_generate_under_adapters_matches_jax(family_ckpts,
                                                        family, targets):
    """Two adapters in slots 1 and 2, a batch mixing slots 2 and 1, then
    slot 1 and the zero slot: logits within the tolerance, greedy tokens
    equal. Each adapter moves the logits (so the order of its delta
    against the bias, norm and clamp shows)."""
    if family == "llama":
        japp, tapp = llama_pair(targets)
    else:
        japp, tapp = family_pair(family_ckpts[family], family, targets)
    for slot, seed in ((1, 11), (2, 12)):
        arrays = adapter_arrays(tapp, seed)
        tapp.write_lora_slot(slot, arrays)
        jax_write(japp, slot, arrays)
    vocab = tapp.spec.vocab_size
    ids, mask = prompts(seed=5, vocab=vocab)
    base = tapp.generate(ids, attention_mask=mask, max_new_tokens=3,
                         return_logits=True)
    for aids in (np.array([2, 1], np.int32), np.array([1, 0], np.int32)):
        j, t = run_both(japp, tapp, ids, mask, aids)
        assert_same(j, t)
        moved = np.abs(np.asarray(t["logits"][0])
                       - np.asarray(base["logits"][0])).max()
        assert moved > 1e-2, (aids, moved)


def test_slot_zero_matches_no_lora_build():
    """Slot 0 (and no ids at all) on a LoRA build equals a LoRA-free build
    bit for bit, prefill and decode; the zero adapter adds nothing."""
    japp, tapp = llama_pair(ALL7)
    tapp.write_lora_slot(1, adapter_arrays(tapp, 1))
    _, base = llama_pair(lora_on=False)
    ids, mask = prompts(seed=2)
    outs = []
    for app, aids in ((base, None), (tapp, None),
                      (tapp, np.zeros((2,), np.int32))):
        app.reset()
        outs.append(app.generate(ids, attention_mask=mask, max_new_tokens=4,
                                 adapter_ids=aids, return_logits=True))
    for o in outs[1:]:
        for a, b in zip(o["logits"], outs[0]["logits"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(o["generated"], outs[0]["generated"])
    # the no-LoRA build refuses ids; an id past max_loras is refused too
    with pytest.raises(ConfigurationError, match="without"):
        base.generate(ids, attention_mask=mask, max_new_tokens=1,
                      adapter_ids=np.zeros((2,), np.int32))
    with pytest.raises(ConfigurationError, match="max_loras"):
        tapp.generate(ids, attention_mask=mask, max_new_tokens=1,
                      adapter_ids=np.array([0, 3], np.int32))
    assert tapp._lora_adapter_ids(np.array([-1, 2])).tolist() == [0, 2]


def test_peft_serve_and_set_lora_adapter_swap(tmp_path):
    """``load_lora_adapters`` from PEFT directories, then
    ``set_lora_adapter`` writing adapter b into slot 1: slot 1 then gives
    slot 2's logits; every step held to the JAX app."""
    hf = tiny_llama_hf_config()
    write_peft_adapter(tmp_path / "ad1", hf, seed=1)
    write_peft_adapter(tmp_path / "ad2", hf, seed=2)
    paths = {"a": str(tmp_path / "ad1"), "b": str(tmp_path / "ad2")}
    jl, tl = lora_cfgs(QV, lora_ckpt_paths=paths)
    fam_j, fam_t = j_get_family("llama"), get_family("llama")
    japp = JApp(None, fam_j.config_cls(JTpuConfig(**CONTIG, lora_config=jl),
                                       **hf), fam_j)
    japp.init_random_weights(seed=0).init_cache()
    tapp = CausalLMApplication(
        None, fam_t.config_cls(TpuConfig(**CONTIG, lora_config=tl), **hf),
        fam_t, device="cpu")
    tapp.params = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                    device="cpu")
    tapp.init_cache()
    assert tapp.load_lora_adapters() == japp.load_lora_adapters() == {
        "a": 1, "b": 2}
    ids, mask = prompts(seed=4)
    outs = {}
    for slot in (0, 1, 2):
        aids = np.full((2,), slot, np.int32)
        j, t = run_both(japp, tapp, ids, mask, aids, n=3)
        assert_same(j, t)
        outs[slot] = t
    assert not np.allclose(outs[1]["logits"][0], outs[0]["logits"][0])
    assert not np.allclose(outs[1]["logits"][0], outs[2]["logits"][0])
    leaf = tapp.params["layers"]["lora_B_q_proj"]
    ptr = leaf.data_ptr()
    tapp.set_lora_adapter(1, paths["b"])
    assert tapp.params["layers"]["lora_B_q_proj"].data_ptr() == ptr
    tapp.reset()
    swapped = tapp.generate(ids, attention_mask=mask, max_new_tokens=3,
                            adapter_ids=np.ones((2,), np.int32),
                            return_logits=True)
    for a, b in zip(swapped["logits"], outs[2]["logits"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_delta_matches_merged_weights(tmp_path):
    """The adapter's logits equal the base model's with the adapter merged
    into its weight, W + B @ A * alpha / r (q_proj's columns of the fused
    projection)."""
    hf = tiny_llama_hf_config(num_hidden_layers=2)
    sd = write_peft_adapter(tmp_path / "ad", hf, r=2, alpha=4.0, seed=3,
                            modules=("q_proj",))
    _, tl = lora_cfgs(("q_proj",), max_loras=2)
    fam = get_family("llama")
    cfg = dict(CONTIG, batch_size=1)
    app = CausalLMApplication(
        None, fam.config_cls(TpuConfig(**cfg, lora_config=tl), **hf), fam,
        device="cpu").init_random_weights(0).init_cache()
    app.set_lora_adapter(1, str(tmp_path / "ad"))
    ids = np.random.default_rng(6).integers(1, 500, size=(1, 6)).astype(
        np.int32)
    lens = np.array([6], np.int32)
    got = app._run_prefill(ids, lens, adapter_ids=np.array([1]))["logits"]
    base = CausalLMApplication(
        None, fam.config_cls(TpuConfig(**cfg), **hf), fam, device="cpu")
    params = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in app.params.items()}
    w = params["layers"]["qkv_proj"].clone()
    q = app.spec.q_size
    for i in range(2):
        pre = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        delta = (sd[f"{pre}.lora_B.weight"] @ sd[f"{pre}.lora_A.weight"]).T
        w[i, :, :q] += torch.from_numpy(delta * (4.0 / 2))
    params["layers"] = {k: v for k, v in params["layers"].items()
                        if not k.startswith("lora_")}
    params["layers"]["qkv_proj"] = w
    base.params = params
    base.init_cache()
    want = base._run_prefill(ids, lens)["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(
        got.numpy(), app._run_prefill(ids, lens)["logits"].numpy(),
        atol=1e-3)


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

MOE_HF = dict(model_type="qwen3_moe", hidden_size=64, intermediate_size=128,
              moe_intermediate_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
              decoder_sparse_step=1, mlp_only_layers=[], vocab_size=256,
              rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu",
              tie_word_embeddings=False)
DEEPSEEK_HF = dict(model_type="deepseek_v3", hidden_size=64,
                   intermediate_size=128, moe_intermediate_size=32,
                   num_hidden_layers=4, num_attention_heads=4,
                   num_key_value_heads=4, n_routed_experts=8,
                   n_shared_experts=1, num_experts_per_tok=2,
                   first_k_dense_replace=2, n_group=2, topk_group=1,
                   q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16, vocab_size=256,
                   rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu",
                   tie_word_embeddings=False, routed_scaling_factor=1.0,
                   norm_topk_prob=True, topk_method="noaux_tc",
                   scoring_func="sigmoid")


def _lora_leaves(specs):
    return {(group, k, tuple(v.shape)) for group, d in specs.items()
            if isinstance(d, dict) for k, v in d.items()
            if k.startswith("lora_")}


@pytest.mark.parametrize("hf", [tiny_llama_hf_config(), MOE_HF, DEEPSEEK_HF],
                         ids=["llama", "qwen3_moe", "deepseek"])
def test_lora_leaf_set_matches_jax(hf):
    """The LoRA leaves of ``decoder_param_specs``: the same names and
    shapes as the reference's; Qwen3-MoE's layers take no MLP factors,
    DeepSeek's MLA layers no attention factors (its dense layers keep
    their MLP's)."""
    jl, tl = lora_cfgs(ALL7)
    mt = hf["model_type"]
    cfg = dict(CONTIG, output_logits=False)
    jfam, tfam = j_get_family(mt), get_family(mt)
    jspec = jfam.build_spec(jfam.config_cls(
        JTpuConfig(**cfg, lora_config=jl), **hf), tp_degree=1)
    tspec = tfam.build_spec(tfam.config_cls(
        TpuConfig(**cfg, lora_config=tl), **hf), tp_degree=1)
    want = _lora_leaves(jmb.decoder_param_specs(jspec))
    got = _lora_leaves(model_base.decoder_param_specs(tspec))
    assert got == want and got
    mods = {k[len("lora_A_"):] for _, k, _ in got if k.startswith("lora_A")}
    if mt == "qwen3_moe":
        assert mods == {"q_proj", "k_proj", "v_proj", "o_proj"}
    if mt == "deepseek_v3":
        assert mods == {"gate_proj", "up_proj", "down_proj"}
        assert {g for g, *_ in got} == {"layers"}


def test_stack_lora_host_on_checkpoint_load():
    """A checkpoint carries base weights only: ``_put_params`` of a
    LoRA-free host tree stacks zeroed ``(L, max_loras, ...)`` factors (as
    the reference's), and ``stack_lora_host`` leaves present leaves and
    LoRA-free specs alone."""
    japp, tapp = llama_pair(ALL7)
    _, base = llama_pair(lora_on=False)
    host = {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in base.params.items()}
    fresh = CausalLMApplication(None, tapp.config, tapp.family, device="cpu")
    fresh._put_params(host)
    jhost = jax.tree.map(np.asarray, japp.params)
    for mod in ALL7:
        for ab in "AB":
            got = fresh.params["layers"][f"lora_{ab}_{mod}"]
            want = jhost["layers"][f"lora_{ab}_{mod}"]
            assert tuple(got.shape) == want.shape
            assert got.dtype == torch.float32 and not got.any()
    before = tapp.params["layers"]["lora_A_q_proj"]
    assert model_base.stack_lora_host(
        tapp.spec, tapp.params)["layers"]["lora_A_q_proj"] is before
    plain = {"layers": {"qkv_proj": np.zeros((2, 3))}}
    assert model_base.stack_lora_host(base.spec, plain) is plain
    assert set(plain["layers"]) == {"qkv_proj"}
    # the JAX tree's LoRA leaves cross to the port through params_from_numpy
    arrays = adapter_arrays(tapp, 9)
    jax_write(japp, 2, arrays)
    carried = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                device="cpu")
    for mod in ALL7:
        np.testing.assert_array_equal(
            carried["layers"][f"lora_B_{mod}"][:, 2].numpy(), arrays[mod][1])
    assert dataclasses.replace(tapp.spec, lora=None) != tapp.spec
