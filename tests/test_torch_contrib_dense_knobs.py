"""The contrib dense families' knobs in the port against the JAX package's
functions, and the kernel gates that keep ALiBi off every kernel.

``ops/attention``: ``alibi_slopes`` (both variants, power-of-two and
other head counts) and the ALiBi bias of ``mha`` / ``mha_hl`` (fp32, to
1e-5). ``models/model_base``: the plain and the biased MLP with xIELU's
learned alphas, the embeddings' LayerNorm and the learned position table
clamped at its last row, the refusal of a ``seq_len`` past that table.
Then the gates: BLOOM at head_dim 64 with ``attn_kernel_enabled`` and
``attn_block_tkg_kernel_enabled`` on (``flash_prefill`` and
``decode_kernel`` True) calls none of the three kernel wrappers on the
contiguous app, the paged app or the ragged engine, and gives the JAX
package's logits and streams; the same spec without ``alibi`` calls each
of them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.models import model_base as jmb
from neuronx_distributed_inference_tpu.ops import attention as jattn
from neuronx_distributed_inference_tpu.ops.rope import RopeConfig as JRope
from neuronx_distributed_inference_tpu.parallel.layers import \
    resolve_gqa_sharding as j_gqa
from neuronx_distributed_inference_tpu_torch.models import model_base
from neuronx_distributed_inference_tpu_torch.ops import attention as tattn
from neuronx_distributed_inference_tpu_torch.ops import (decode_attention,
                                                          flash_attention)
from neuronx_distributed_inference_tpu_torch.ops.rope import RopeConfig
from neuronx_distributed_inference_tpu_torch.parallel.layers import \
    resolve_gqa_sharding
from test_torch_contrib_dense import (_no_tf32,  # noqa: F401
                                      assert_logits_close, make_apps, parts,
                                      save_ckpt, save_ckpts)
from test_torch_dense_families import ids_of
from test_torch_serving_engine import _serve

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["bloom", "mpt"])
def test_alibi_slopes_equal_the_reference(variant):
    """Both variants' slopes equal the reference's bit for bit at 12, 20,
    32 and 71 heads (a power of two and three that are not) and at every
    head count up to 256, since the port computes both with one formula,
    and fall from 2^(-8/n2) head by head at 32 heads (n2 = 32)."""
    for n in (12, 20, 32, 71) + tuple(range(1, 257)):
        got = tattn.alibi_slopes(n, variant)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got, jattn.alibi_slopes(n, variant))
    np.testing.assert_allclose(tattn.alibi_slopes(32, variant),
                               2.0 ** (-0.25 * np.arange(1, 33)), rtol=1e-6)
    with pytest.raises(ValueError):
        tattn.alibi_slopes(8, "neox")


@pytest.mark.parametrize("kv_rows", [1, 2], ids=["shared_pos", "row_pos"])
def test_mha_alibi_bias_matches_jax(kv_rows):
    """``mha`` (k/v (B, S, Hkv, D)) and ``mha_hl`` (the cache layouts) with
    the ALiBi bias over key positions (1, S) or (B, S), a causal mask and
    G 2, against the JAX cores on the same fp32 inputs; without the bias
    both part."""
    rng = np.random.default_rng(7)
    b, t, s, hq, hkv, d = 2, 5, 12, 8, 4, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    slopes = tattn.alibi_slopes(hq, "bloom") * 4
    qpos = np.arange(s - t, s)[None].repeat(b, 0)
    kpos = np.arange(s)[None].repeat(kv_rows, 0) + 3 * np.arange(
        kv_rows)[:, None]
    mask = kpos[:, None, :].repeat(b // kv_rows, 0) <= qpos[:, :, None]
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask), 0.25,
                                alibi=(jnp.asarray(slopes),
                                       jnp.asarray(kpos))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = torch.from_numpy(mask)
    al = (torch.from_numpy(slopes), torch.from_numpy(kpos))
    got = tattn.mha(tq, tk, tv, tmask, 0.25, alibi=al).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got_hl = tattn.mha_hl(tq, tk.permute(0, 2, 3, 1), tv.permute(0, 2, 1, 3),
                          tmask, 0.25, alibi=al).numpy()
    np.testing.assert_allclose(got_hl, want, **TOL)
    off = tattn.mha(tq, tk, tv, tmask, 0.25).numpy()
    assert np.abs(off - want).max() > 0.05


def _specs(**knobs):
    base = dict(num_layers=1, hidden_size=64, num_q_heads=4, num_kv_heads=4,
                head_dim=16, intermediate_size=96, vocab_size=200,
                padded_vocab=256, rms_eps=1e-5)
    jspec = jmb.DecoderSpec(**base, rope=JRope(head_dim=16),
                            gqa=j_gqa(4, 4, 1), dtype=jnp.float32, **knobs)
    tspec = model_base.DecoderSpec(**base, rope=RopeConfig(head_dim=16),
                                   gqa=resolve_gqa_sharding(4, 4, 1),
                                   dtype=torch.float32, **knobs)
    return jspec, tspec


@pytest.mark.parametrize("knobs", [
    dict(act="xielu", mlp_glu=False, mlp_bias=True),
    dict(act="xielu", mlp_glu=False),
    dict(act="gelu_pytorch_tanh", mlp_glu=False, mlp_bias=True),
    dict(act="silu", mlp_bias=True),
], ids=["xielu_bias", "xielu", "plain_bias", "glu_bias"])
def test_mlp_block_matches_jax(knobs):
    """The dense MLP slot against the JAX ``_mlp_block`` on the same fp32
    weights and inputs: plain or GLU, with or without the projections'
    biases, xIELU with learned alphas (eps above some inputs, so both of
    its branches and the clamp run). The param specs hold exactly the
    leaves used; each bias and the xIELU row moves the output."""
    jspec, tspec = _specs(**knobs)
    rng = np.random.default_rng(3)
    leaf = model_base._dense_mlp_param_specs(tspec, 1)
    assert set(leaf) == set(jmb._dense_mlp_param_specs(jspec, 1))
    w = {k: (0.3 * rng.standard_normal(ps.shape[1:])).astype(np.float32)
         for k, ps in leaf.items()}
    if "xielu" in w:
        w["xielu"] = np.array([0.8, -0.3, 0.5, -0.2], np.float32)
        assert leaf["xielu"].dtype == torch.float32
    x = (2 * rng.standard_normal((2, 3, 64))).astype(np.float32)
    want = np.asarray(jmb._mlp_block(
        jspec, jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()},
        "dense", None))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = model_base._mlp_block(tspec, torch.from_numpy(x), tw, "prefill",
                                "dense").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("gate_bias", "down_bias", "xielu"):
        if k in w:
            moved = dict(tw, **{k: tw[k] * 1.5 + 0.1})
            out = model_base._mlp_block(tspec, torch.from_numpy(x), moved,
                                        "prefill", "dense").numpy()
            assert np.abs(out - want).max() > 1e-2, k


def test_embed_norm_and_learned_positions_match_jax():
    """``_embed`` with the embeddings' LayerNorm and a 16-row position
    table against the JAX ``_embed``; positions past the table take its
    last row (clamped); without positions the port raises, where the
    reference adds no row."""
    jspec, tspec = _specs(embed_norm=True, learned_pos=16)
    rng = np.random.default_rng(4)
    p = {"embed": rng.standard_normal((256, 64)),
         "embed_norm": 1 + 0.1 * rng.standard_normal(64),
         "embed_norm_b": 0.1 * rng.standard_normal(64),
         "pos_embed": rng.standard_normal((16, 64))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ids = rng.integers(0, 200, size=(2, 6))
    pos = np.array([[0, 1, 2, 3, 4, 5], [12, 13, 14, 15, 16, 40]])
    want = np.asarray(jmb._embed(jspec, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                 jnp.asarray(ids), jnp.asarray(pos)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = model_base._embed(tspec, tp, torch.from_numpy(ids),
                            torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="position_ids"):
        model_base._embed(tspec, tp, torch.from_numpy(ids))
    bare = model_base._embed(dataclasses.replace(tspec, learned_pos=0), tp,
                             torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got - bare, p["pos_embed"][np.minimum(pos,
                                                                     15)],
                               **TOL)


def test_seq_len_past_the_position_table_is_refused(tmp_path):
    """A ``seq_len`` beyond GPT-2's ``n_positions`` raises ValueError in
    both packages (reference model_base.py:2562-2567); at the table's
    length it builds."""
    from neuronx_distributed_inference_tpu.config import (
        TpuConfig as JTpuConfig, load_pretrained_config as j_load_config)
    from neuronx_distributed_inference_tpu.models.family import \
        get_family as j_get_family
    from neuronx_distributed_inference_tpu_torch.config import (
        TpuConfig, load_pretrained_config)
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    d = save_ckpt(tmp_path / "gpt2", "gpt2", n_positions=32)
    for fam, tc, load in ((j_get_family("gpt2"), JTpuConfig, j_load_config),
                          (get_family("gpt2"), TpuConfig,
                           load_pretrained_config)):
        with pytest.raises(ValueError, match="learned position table"):
            fam.build_spec(fam.config_cls(tc(batch_size=1, seq_len=48),
                                          load_config=load(d)), 1)
        spec = fam.build_spec(fam.config_cls(tc(batch_size=1, seq_len=32),
                                             load_config=load(d)), 1)
        assert spec.learned_pos == 32


def test_speculation_refuses_learned_positions(tmp_path):
    """The reference's token-tree forward and EAGLE draft embed with no
    positions (speculation.py:236, :580), which would skip GPT-2's position
    table: every tree decoder over a GPT-2 target, an EAGLE decoder with a
    GPT-2 draft and ``tree_forward`` itself raise NotImplementedError in
    the port; the same spec without its table passes the tree check."""
    from neuronx_distributed_inference_tpu_torch.models import speculation
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.config import (
        TpuConfig, load_pretrained_config)
    from neuronx_distributed_inference_tpu_torch.models.family import \
        get_family
    d = save_ckpt(tmp_path / "gpt2", "gpt2")
    fam = get_family("gpt2")
    app = CausalLMApplication(
        d, fam.config_cls(TpuConfig(batch_size=1, seq_len=32,
                                    dtype="float32"),
                          load_config=load_pretrained_config(d)),
        fam, device="cpu").load_weights().init_cache()
    assert app.spec.learned_pos
    match = "learned position table"
    for build in (lambda: speculation.MedusaTreeDecoder(app),
                  lambda: speculation.DynamicTreeDecoder(app),
                  lambda: speculation.EagleTreeDecoder(
                      app, app.spec, app.params, app.cache),
                  lambda: speculation.EagleDecoder(
                      app, app.spec, app.params, app.cache),
                  lambda: speculation.tree_forward(
                      app.spec, app.tpu_config, app.params, app.cache,
                      None, None, None, None, None),
                  lambda: speculation.eagle_forward(
                      app.spec, app.tpu_config, app.params, app.cache,
                      None, None, None, None)):
        with pytest.raises(NotImplementedError, match=match):
            build()
    speculation._refuse_tree_target(dataclasses.replace(app.spec,
                                                        learned_pos=0))


@pytest.fixture(scope="module")
def leaf_ckpts(tmp_path_factory):
    return save_ckpts(tmp_path_factory, LEAF_FAMILIES)


LEAF_FAMILIES = ("apertus", "bloom", "gpt2", "persimmon")


@pytest.mark.parametrize("name", LEAF_FAMILIES)
def test_params_from_numpy_carries_the_new_leaves(leaf_ckpts, name):
    """``utils/jax_params.params_from_numpy`` over the JAX app's loaded
    tree gives the port's own ``load_weights`` tree leaf for leaf, the new
    leaves included (``pos_embed``, ``embed_norm(_b)``, the fp32
    ``alibi_slopes`` and ``xielu``, the MLP biases, the q/k LayerNorm
    biases), each in its dtype."""
    import jax
    from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
        params_from_numpy
    japp, tapp = make_apps(leaf_ckpts[name], name)
    carried = params_from_numpy(jax.tree.map(np.asarray, japp.params),
                                device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(carried)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(tapp.params)[0])
    assert flat.keys() == want.keys()
    for path, t in flat.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
    names = {str(k[-1].key) for k in flat}
    assert {"apertus": {"xielu"}, "bloom": {"alibi_slopes", "embed_norm",
                                            "embed_norm_b", "gate_bias"},
            "gpt2": {"pos_embed", "down_bias"},
            "persimmon": {"q_norm_b", "k_norm_b"}}[name] <= names


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

KERNELS = ((flash_attention, "flash_attention"),
           (decode_attention, "decode_attention_stacked"),
           (decode_attention, "paged_decode_attention"))
CONTIG = dict(batch_size=2, seq_len=128, dtype="float32", output_logits=True,
              enable_bucketing=False, attn_kernel_enabled=True,
              attn_block_tkg_kernel_enabled=True)
PAGED = dict(batch_size=2, seq_len=64, dtype="float32",
             is_block_kv_layout=True, pa_block_size=8, is_prefix_caching=True,
             context_encoding_buckets=[32], output_logits=True,
             attn_block_tkg_kernel_enabled=True)


@pytest.fixture(scope="module")
def bloom(tmp_path_factory):
    return save_ckpts(tmp_path_factory, ("bloom_d64",))["bloom_d64"]


@pytest.fixture
def calls(monkeypatch):
    """name -> number of calls of each kernel wrapper."""
    seen = {name: 0 for _, name in KERNELS}
    for mod, name in KERNELS:
        def counted(*a, _orig=getattr(mod, name), _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return seen


def test_contiguous_gates_keep_alibi_off_the_kernels(bloom, calls):
    """BLOOM at head_dim 64 on the contiguous app with both kernels asked
    for: no flash and no decode-kernel call, and the JAX app's logits and
    greedy tokens (its gates keep ALiBi off its kernels too). The same
    spec without ``alibi`` calls flash at the prefill and the decode
    kernel at every layer of every step."""
    japp, tapp = make_apps(bloom, "bloom_d64", CONTIG)
    assert tapp.spec.flash_prefill and tapp.spec.decode_kernel is True
    assert tapp.spec.head_dim == 64 and tapp.spec.alibi
    ids, mask = ids_of([40, 29], seed=8)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert_logits_close(got["logits"], want["logits"], "bloom")
    assert sum(calls.values()) == 0, calls
    tapp.spec = dataclasses.replace(tapp.spec, alibi=False)
    tapp.init_cache()
    off = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    assert calls["flash_attention"] == 2           # 2 layers x 1 prefill
    assert calls["decode_attention_stacked"] == 2 * 5
    assert parts(off["logits"], want["logits"])


def test_paged_and_ragged_gates_keep_alibi_off_the_kernel(bloom, calls):
    """BLOOM at head_dim 64 on the paged app and the ragged engine with the
    decode kernel forced on: no kernel call, JAX's logits and the JAX
    engine's streams. The same spec without ``alibi`` calls the paged
    kernel at every layer of every T = 1 step."""
    japp, tapp = make_apps(bloom, "bloom_d64", PAGED, paged=True)
    ids, mask = ids_of([20, 13], seed=5)
    want = japp.generate(ids, attention_mask=mask, max_new_tokens=6,
                         return_logits=True)
    got = tapp.generate(ids, attention_mask=mask, max_new_tokens=6,
                        return_logits=True)
    assert_logits_close(got["logits"], want["logits"], "bloom paged")
    japp.init_cache()
    tapp.init_cache()
    rng = np.random.default_rng(2)
    subs = [(rng.integers(1, 256, size=n).tolist(), m, "default")
            for n, m in ((11, 5), (23, 4), (30, 3))]
    assert (_serve(tapp, "port", True, subs, chunk=16)[:3]
            == _serve(japp, "jax", True, subs, chunk=16)[:3])
    assert sum(calls.values()) == 0, calls
    tapp.spec = dataclasses.replace(tapp.spec, alibi=False)
    tapp.init_cache()
    tapp.generate(ids, attention_mask=mask, max_new_tokens=6)
    assert calls["paged_decode_attention"] == 2 * 5
    tapp.init_cache()
    _serve(tapp, "port", True, subs, chunk=16)
    assert calls["paged_decode_attention"] > 2 * 5
    assert calls["flash_attention"] == calls["decode_attention_stacked"] == 0


def test_chip_smoke_contrib_dense_helpers(capsys):
    """Phase 26's helpers (chip_smoke): the full-width specs pass
    ``check_contrib_dense_specs`` (Pythia-6.9B at G 1 with rotary 32 of
    128 and the parallel-dual block, admitted by the decode gates;
    BLOOM-7B1 with ALiBi refused by every kernel gate with both kernels
    forced on, admitted without it); ``init_weights`` gives a BLOOM app
    its published slopes (the random tree's are zeros) and draws the
    embeddings' norm bias; the group is registered."""
    from test_torch_decode_attention import _chip_smoke
    cs = _chip_smoke()
    cs.check_contrib_dense_specs()
    assert '"contrib_dense_specs"' in capsys.readouterr().out
    assert "contrib_dense" in cs.GROUPS
    assert cs.bloom_cut(2)["n_layer"] == cs.bloom_cut(2)[
        "num_hidden_layers"] == 2
    assert cs.CONTRIB_DENSE_SERVE["seq_len"] == cs.PYTHIA_6_9B[
        "max_position_embeddings"]
    assert max(cs.CONTRIB_DENSE_SERVE["lens"]) + cs.RAGGED_TOKENS <= 2048
    hf = dict(cs.bloom_cut(2), hidden_size=256, n_head=4, vocab_size=512)
    app = cs.make_app(hf, torch.device("cpu"), "float32", batch=1,
                      seq_len=64, graphs=False)
    assert float(app.init_random_weights(0).params["layers"][
        "alibi_slopes"].abs().max()) == 0.0
    cs.init_weights(app, 0)
    slopes = app.params["layers"]["alibi_slopes"]
    np.testing.assert_array_equal(slopes[1].numpy(),
                                  tattn.alibi_slopes(4, "bloom"))
    assert float(app.params["embed_norm_b"].abs().max()) > 0
