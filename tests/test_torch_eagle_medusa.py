"""EAGLE, Medusa and token-tree speculation of the port against the JAX
package's (the pins of tests/test_eagle_medusa.py; its
``test_data_parallel_sampler_matches_global`` belongs to ``sample_dp``,
ROADMAP A13).

Geometry: the tiny fp32 Llama of ``tests/test_torch_speculation.py``
(hidden 256, 4 q / 2 kv heads of head_dim 64, 2 layers; batch 2, seq_len
96), EAGLE drafts of 1-2 layers at the target's width, 3 Medusa heads.
The JAX trees (target, heads, drafts) are carried into the port with
``params_from_numpy``. Tolerances: logits, hidden states and log-probs
atol=2e-3, rtol=1e-3; token ids, tree tables and masks exact; every
decoder's stream equals the JAX decoder's and plain greedy decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.models import model_base as jmb
from neuronx_distributed_inference_tpu.models import speculation as jspec
from neuronx_distributed_inference_tpu.modules import token_tree as jtt
from neuronx_distributed_inference_tpu.modules.kv_cache import (
    KVCacheSpec as JKVCacheSpec, init_cache as jinit_cache)
from neuronx_distributed_inference_tpu_torch.models import speculation
from neuronx_distributed_inference_tpu_torch.modules import kv_cache
from neuronx_distributed_inference_tpu_torch.modules import token_tree
from neuronx_distributed_inference_tpu_torch.utils.jax_params import \
    params_from_numpy
from test_torch_speculation import TARGET, TCFG, make_pair

TOL = dict(atol=2e-3, rtol=1e-3)
EAGLE_CFG = dict(speculation_length=3, enable_fused_speculation=True,
                 enable_eagle_speculation=True)
MEDUSA_CFG = dict(medusa_speculation_length=4, num_medusa_heads=3)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def spec_pair(cfg, medusa_heads=0, **over):
    """(JAX, port) target apps with a speculation config (EAGLE_CFG or
    MEDUSA_CFG) and, with ``medusa_heads``, the heads in both trees."""
    japp, tapp = make_pair(TARGET, spec_cfg=cfg, **over)
    if medusa_heads:
        japp.spec = dataclasses.replace(japp.spec, medusa_heads=medusa_heads)
        tapp.spec = dataclasses.replace(tapp.spec, medusa_heads=medusa_heads)
        japp.init_random_weights(7).init_cache()
        tapp.params = params_from_numpy(jax.tree.map(np.asarray,
                                                     japp.params),
                                        device="cpu")
        tapp.init_cache()
    return japp, tapp


def eagle_draft(japp, tapp, layers=2, seed=7, input_norm=False):
    """(JAX (spec, params, cache), port (spec, params, cache)) of one
    EAGLE draft on the same weights."""
    jds = jmb.spec_from_config(japp.config, tp_degree=1, num_layers=layers)
    jp = jspec.init_eagle_draft_params(jds, jax.random.PRNGKey(seed),
                                       japp.mesh, input_norm=input_norm)
    jc = jinit_cache(JKVCacheSpec(
        num_layers=layers, batch_size=2, max_seq_len=TCFG["seq_len"],
        num_kv_heads=jds.gqa.num_kv_heads, head_dim=jds.head_dim,
        dtype=jds.kv_dtype), japp.mesh)
    tds = dataclasses.replace(tapp.spec, num_layers=layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tc = kv_cache.init_cache(kv_cache.KVCacheSpec(
        num_layers=layers, batch_size=2, max_seq_len=TCFG["seq_len"],
        num_kv_heads=tds.gqa.num_kv_heads, head_dim=tds.head_dim,
        dtype=tds.kv_dtype), torch.device("cpu"))
    return (jds, jp, jc), (tds, tp, tc)


def _ids(seed, s=10):
    return np.random.default_rng(seed).integers(1, 500, size=(2, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def plain():
    return make_pair(TARGET)


@pytest.fixture(scope="module")
def golden(plain):
    jp, tp = plain
    out = {}
    for seed, n in ((0, 16), (1, 8)):
        jp.init_cache()
        tp.init_cache()
        want = np.asarray(jp.generate(_ids(seed), max_new_tokens=n)[
            "generated"])
        got = tp.generate(_ids(seed), max_new_tokens=n)["generated"]
        np.testing.assert_array_equal(got, want)
        out[seed] = got
    return out


@pytest.fixture(scope="module")
def eagle_apps():
    return spec_pair(EAGLE_CFG, output_full_hidden=True)


@pytest.fixture(scope="module")
def medusa_apps():
    return spec_pair(MEDUSA_CFG, medusa_heads=3)


# ---------------------------------------------------------------------------
# token trees and the lattice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paths", [jtt.DEFAULT_TREE,
                                   [[0], [1], [0, 0], [0, 1], [1, 0],
                                    [0, 0, 0], [0, 0, 1], [1, 0, 0]]])
def test_token_tree_tables_and_masks_match_jax(paths):
    want, got = jtt.TokenTree(paths), token_tree.TokenTree(paths)
    assert got.paths == want.paths and got.num_nodes == want.num_nodes
    for name in ("depth", "parent", "branch", "ancestor_mask",
                 "level_widths"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for a, b in zip(got.leaf_path_matrix(), want.leaf_path_matrix()):
        np.testing.assert_array_equal(a, b)
    base = np.array([4, 2])
    np.testing.assert_array_equal(got.attention_mask(base, 12),
                                  want.attention_mask(base, 12))
    np.testing.assert_array_equal(got.node_positions(base),
                                  want.node_positions(base))
    # the device mask of the decoders equals the host one
    dev = speculation.tree_attention_mask(
        torch.as_tensor(got.ancestor_mask), torch.as_tensor(base), 12)
    np.testing.assert_array_equal(dev.numpy(), want.attention_mask(base, 12))
    assert token_tree.TokenTree.from_config({"paths": paths}).paths \
        == want.paths
    assert token_tree.DEFAULT_TREE == jtt.DEFAULT_TREE


def test_token_tree_requires_parents():
    with pytest.raises(ValueError):
        token_tree.TokenTree([[0, 0]])


def test_lattice_and_dynamic_select_match_jax():
    for bk, depth in ((3, 2), (4, 3)):
        want = jspec.build_lattice(bk, depth)
        got = speculation.build_lattice(bk, depth)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    lat = jspec.build_lattice(3, 3)
    logp = np.log(np.random.default_rng(0).dirichlet(
        np.ones(3), size=(2, 3))).astype(np.float32)
    # a tie between two branches: both packages keep the lower index first
    logp[0, 1, 2] = logp[0, 1, 1]
    jsel, jsc = jspec.dynamic_tree_select(
        tuple(jnp.asarray(x) for x in lat), jnp.asarray(logp), 10)
    tsel, tsc = speculation.dynamic_tree_select(
        speculation.lattice_tensors(lat, "cpu"), torch.as_tensor(logp), 10)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("input_norm", [False, True])
def test_eagle_forward_matches_jax(eagle_apps, input_norm):
    """The fused draft forward over a prompt (T = 9) and one step (T = 1,
    the port's kernel twin): logits, hidden states and the draft caches."""
    japp, tapp = eagle_apps
    (jds, jp, jc), (tds, tp, tc) = eagle_draft(japp, tapp, layers=1,
                                               input_norm=input_norm)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 500, size=(2, 9)).astype(np.int32)
    hid = rng.normal(0, 1, size=(2, 9, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1, 10, dtype=np.int32), (2, 9)).copy()
    sid = np.arange(2, dtype=np.int32)
    for t_toks, t_hid, t_pos in ((toks, hid, pos),
                                 (toks[:, :1], hid[:, :1], pos[:, -1:] + 1)):
        want = jspec.eagle_forward(jds, japp.tpu_config, jp, jc, t_toks,
                                   t_hid, t_pos, sid, input_norm)
        jc = want["cache"]
        got = speculation.eagle_forward(
            tds, tapp.tpu_config, tp, tc, torch.as_tensor(t_toks),
            torch.as_tensor(t_hid), torch.as_tensor(t_pos),
            torch.as_tensor(sid), input_norm)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), **TOL)
        np.testing.assert_allclose(got["hidden"].numpy(),
                                   np.asarray(want["hidden"]), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(
                jc[name]), **TOL)


def test_eagle_speculation_step_matches_jax(eagle_apps):
    """One fused EAGLE step from equal caches: emitted tokens, counts, the
    next (token, hidden) pair and both caches (the draft's refresh pushes
    the rejected columns past the cache: dropped)."""
    japp, tapp = eagle_apps
    (jds, jp, jc), (tds, tp, tc) = eagle_draft(japp, tapp)
    japp.init_cache()
    tapp.init_cache()
    ids = _ids(4)
    lens = np.full((2,), 10, np.int32)
    jout = japp._run_prefill(ids, lens)
    tout = tapp._run_prefill(ids, lens)
    hs = np.asarray(jout["hidden_states"])
    np.testing.assert_allclose(tout["hidden_states"].numpy(), hs, **TOL)
    np.testing.assert_allclose(tout["last_hidden"].numpy(),
                               np.asarray(jout["last_hidden"]), **TOL)
    root = np.asarray(jout["tokens"]).astype(np.int32)
    sid = np.arange(2, dtype=np.int32)
    want = jspec.eagle_speculation_step(
        jds, japp.spec, japp.tpu_config, jp, japp.params, jc, japp.cache,
        root, jnp.asarray(hs[:, -1]), lens, sid)
    got = speculation.eagle_speculation_step(
        tds, tapp.spec, tapp.tpu_config, tp, tapp.params, tc, tapp.cache,
        torch.as_tensor(root), tout["hidden_states"][:, -1],
        torch.as_tensor(lens), torch.as_tensor(sid))
    for key in ("tokens", "num_emitted", "next_token"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_allclose(got["next_hidden"].numpy(),
                               np.asarray(want["next_hidden"]), **TOL)
    for a, b in ((tc, want["draft_cache"]),
                 (tapp.cache, want["target_cache"])):
        for name in ("k", "v"):
            np.testing.assert_allclose(a[name].numpy(), np.asarray(b[name]),
                                       **TOL)


def test_medusa_propose_scored_matches_jax(medusa_apps):
    """Ids equal, log-probs within the tolerance, and tied scores ordered
    by index as ``lax.top_k`` orders them (the medusa lm head's first
    columns duplicated, so heads see exact ties)."""
    japp, tapp = medusa_apps
    feat = np.random.default_rng(5).normal(0, 1, (2, 256)).astype(np.float32)
    jparams = dict(japp.params)
    lm = np.asarray(jparams["medusa_lm"]).copy()
    lm[:, :, 1] = lm[:, :, 0]
    lm[:, :, 2] = lm[:, :, 0]
    jparams["medusa_lm"] = jnp.asarray(lm)
    tparams = dict(tapp.params)
    tparams["medusa_lm"] = torch.as_tensor(lm)
    for params_j, params_t in ((japp.params, tapp.params),
                               (jparams, tparams)):
        wids, wlp = jspec.medusa_propose_scored(japp.spec, params_j,
                                                jnp.asarray(feat), 6)
        gids, glp = speculation.medusa_propose_scored(
            tapp.spec, params_t, torch.as_tensor(feat), 6)
        np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
        np.testing.assert_allclose(glp.numpy(), np.asarray(wlp), **TOL)
        np.testing.assert_array_equal(
            speculation.medusa_propose(tapp.spec, params_t,
                                       torch.as_tensor(feat), 2).numpy(),
            np.asarray(wids)[..., :2])


def test_medusa_tree_step_matches_jax(medusa_apps):
    """One tree-verify step over DEFAULT_TREE from equal caches: emitted
    tokens, counts, bonus, the accepted feature and the refreshed cache."""
    japp, tapp = medusa_apps
    japp.init_cache()
    tapp.init_cache()
    ids = _ids(6)
    lens = np.full((2,), 10, np.int32)
    jout = japp._run_prefill(ids, lens)
    tout = tapp._run_prefill(ids, lens)
    tree = jtt.TokenTree(jtt.DEFAULT_TREE)
    props = np.asarray(jspec.medusa_propose(japp.spec, japp.params,
                                            jout["last_hidden"], 3))
    root = np.asarray(jout["tokens"]).astype(np.int32)
    nodes = np.zeros((2, tree.num_nodes), np.int32)
    nodes[:, 0] = root
    for i in range(1, tree.num_nodes):
        nodes[:, i] = props[:, tree.depth[i] - 1, tree.branch[i]]
    paths, plens = tree.leaf_path_matrix()
    mask = tree.attention_mask(lens, TCFG["seq_len"])
    sid = np.arange(2, dtype=np.int32)
    want = jspec.medusa_tree_step(japp.spec, japp.tpu_config, japp.params,
                                  japp.cache, nodes, lens, sid, mask, paths,
                                  plens, tree.depth)
    got = speculation.medusa_tree_step(
        tapp.spec, tapp.tpu_config, tapp.params, tapp.cache,
        torch.as_tensor(nodes), torch.as_tensor(lens), torch.as_tensor(sid),
        torch.as_tensor(mask), torch.as_tensor(paths),
        torch.as_tensor(plens), torch.as_tensor(tree.depth))
    for key in ("tokens", "num_emitted", "bonus"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_allclose(got["feature"].numpy(),
                               np.asarray(want["feature"]), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tapp.cache[name].numpy(),
                                   np.asarray(want["cache"][name]), **TOL)


# ---------------------------------------------------------------------------
# every decoder: the JAX decoder's stream, which is plain greedy's
# ---------------------------------------------------------------------------

def _run(japp, tapp, make_j, make_t, seed=0, n=16):
    japp.init_cache()
    tapp.init_cache()
    want = make_j().generate(_ids(seed), max_new_tokens=n)
    got = make_t().generate(_ids(seed), max_new_tokens=n)
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
    return got


@pytest.mark.parametrize("input_norm", [False, True])
def test_eagle_decoder_matches_jax_and_greedy(eagle_apps, golden,
                                              input_norm):
    japp, tapp = eagle_apps
    (jds, jp, jc), (tds, tp, tc) = eagle_draft(
        japp, tapp, layers=1 if input_norm else 2,
        seed=3 if input_norm else 7, input_norm=input_norm)
    seed, n = (1, 8) if input_norm else (0, 16)
    got = _run(japp, tapp,
               lambda: jspec.EagleDecoder(japp, jds, jp, jc, input_norm),
               lambda: speculation.EagleDecoder(tapp, tds, tp, tc,
                                                input_norm),
               seed, n)
    np.testing.assert_array_equal(got["generated"], golden[seed])
    assert got["mean_tokens_per_step"] >= 1.0


def test_medusa_decoders_match_jax_and_greedy(medusa_apps, golden):
    """Chain mode, the DEFAULT_TREE tree and the dynamic tree (branch 3,
    10 nodes)."""
    japp, tapp = medusa_apps
    for make_j, make_t, key in (
            (lambda: jspec.MedusaDecoder(japp),
             lambda: speculation.MedusaDecoder(tapp),
             "mean_tokens_per_step"),
            (lambda: jspec.MedusaTreeDecoder(japp),
             lambda: speculation.MedusaTreeDecoder(tapp),
             "mean_tokens_per_step"),
            (lambda: jspec.DynamicTreeDecoder(japp, branch_k=3,
                                              num_nodes=10),
             lambda: speculation.DynamicTreeDecoder(tapp, branch_k=3,
                                                    num_nodes=10),
             "mean_accept")):
        got = _run(japp, tapp, make_j, make_t)
        np.testing.assert_array_equal(got["generated"], golden[0])
        assert got[key] >= 1.0


def test_eagle_tree_matches_jax_and_greedy(eagle_apps, golden):
    japp, tapp = eagle_apps
    (jds, jp, jc), (tds, tp, tc) = eagle_draft(japp, tapp)
    got = _run(japp, tapp,
               lambda: jspec.EagleTreeDecoder(japp, jds, jp, jc, depth=3,
                                              branch_k=3, num_nodes=10),
               lambda: speculation.EagleTreeDecoder(tapp, tds, tp, tc,
                                                    depth=3, branch_k=3,
                                                    num_nodes=10))
    np.testing.assert_array_equal(got["generated"], golden[0])
    assert got["mean_tokens_per_step"] >= 1.0


def test_eagle_tree_accepts_at_least_chain(eagle_apps, golden):
    """An informative draft (the target's own stack, ``fc`` routing the
    embedding straight through): the dynamic tree's alternatives can only
    add acceptance over the chain's single greedy path."""
    _, tapp = eagle_apps
    spec = tapp.spec
    H = spec.hidden_size

    def informative():
        params = dict(tapp.params)
        fc = torch.zeros((2 * H, H))
        fc[:H] = torch.eye(H)
        params["fc"] = fc
        cache = kv_cache.init_cache(kv_cache.KVCacheSpec(
            num_layers=spec.num_layers, batch_size=2,
            max_seq_len=TCFG["seq_len"], num_kv_heads=spec.gqa.num_kv_heads,
            head_dim=spec.head_dim, dtype=spec.kv_dtype),
            torch.device("cpu"))
        return spec, params, cache

    tapp.init_cache()
    chain = speculation.EagleDecoder(tapp, *informative()).generate(
        _ids(0), max_new_tokens=16)
    tapp.init_cache()
    tree = speculation.EagleTreeDecoder(tapp, *informative(), depth=3,
                                        branch_k=3, num_nodes=10).generate(
        _ids(0), max_new_tokens=16)
    np.testing.assert_array_equal(tree["generated"], golden[0])
    np.testing.assert_array_equal(chain["generated"], golden[0])
    assert (tree["mean_tokens_per_step"]
            >= chain["mean_tokens_per_step"] - 1e-9)
    assert tree["mean_tokens_per_step"] > 1.5
