"""The port's MoE block against the JAX package's ``modules/moe.py``.

Inputs are drawn from a numpy seed and go through both packages in fp32
(JAX with ``jax_default_matmul_precision="highest"``, set by conftest;
the port's matmuls on the CPU are fp32). Routing affinities agree to
1e-6 (softmax and a normalising divide over fp32 logits of 16-wide
products: a few ULPs) and top-k indices exactly, ties included. Expert
outputs agree to 1e-5 absolute and relative: sums of 32-wide fp32
products, taken in another order by the two packages' GEMMs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import moe as jmoe
from neuronx_distributed_inference_tpu.modules import quantization as jq
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.resilience import \
    ConfigurationError

ROUTE_TOL = dict(atol=1e-6, rtol=1e-6)
EXPERT_TOL = dict(atol=1e-5, rtol=1e-5)
B, T, H, E, I = 2, 5, 16, 8, 32

ROUTE_CASES = {
    "softmax": dict(),
    "sigmoid": dict(router_act="sigmoid"),
    "pre_softmax_topk": dict(pre_softmax_topk=True),
    "bias_select": dict(router_act="sigmoid", has_router_bias=True),
    "bias_logits": dict(pre_softmax_topk=True, has_router_bias=True,
                        router_bias_mode="logits"),
    "n_group": dict(router_act="sigmoid", has_router_bias=True, n_group=4,
                    topk_group=2, top_k=3),
    "routed_scaling": dict(routed_scaling=2.5),
    "no_normalize": dict(normalize_topk=False, top_k=3),
    "sparsemixer": dict(router_act="sparsemixer"),
}

EXPERT_CASES = {
    "gated": dict(),
    "input_scaled": dict(input_scaled=True, router_act="sigmoid",
                         top_k=1, normalize_topk=False),
    "oss_clamp": dict(glu_style="oss_clamp"),
    "expert_bias": dict(expert_bias=True),
}


def _spec(pkg, **over):
    kw = dict(num_experts=E, top_k=2, intermediate_size=I)
    kw.update(over)
    return pkg.MoESpec(**kw)


def _weights(seed, *, bias=False, shared=0):
    """A layer's MoE weights as numpy: router (H, E), experts (E, H, I) /
    (E, I, H), optional biases and shared experts."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.3):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    w = {"router": f(H, E, scale=1.0), "expert_gate": f(E, H, I),
         "expert_up": f(E, H, I), "expert_down": f(E, I, H),
         "router_bias": f(E, scale=0.2)}
    if bias:
        w.update(expert_gate_bias=f(E, I), expert_up_bias=f(E, I),
                 expert_down_bias=f(E, H))
    if shared:
        w.update(shared_gate=f(H, shared), shared_up=f(H, shared),
                 shared_down=f(shared, H))
    return w


def _x(seed, b=B, t=T):
    return np.random.default_rng(seed).standard_normal(
        (b, t, H)).astype(np.float32)


def _route_both(over, x, w):
    bias = w["router_bias"] if over.get("has_router_bias") else None
    jv, ji = jmoe.route(_spec(jmoe, **over), jnp.asarray(x),
                        jnp.asarray(w["router"]),
                        None if bias is None else jnp.asarray(bias))
    tv, ti = tmoe.route(_spec(tmoe, **over), torch.from_numpy(x),
                        torch.from_numpy(w["router"]),
                        None if bias is None else torch.from_numpy(bias))
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_matches_jax(name):
    """Every router mode: affinities at ROUTE_TOL, indices exactly."""
    (jv, ji), (tv, ti) = _route_both(ROUTE_CASES[name], _x(1),
                                     _weights(2))
    assert tv.dtype == np.float32 and tv.shape == jv.shape
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **ROUTE_TOL)


@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_tied_router_scores_order_as_lax_top_k(mode):
    """Experts with identical router columns tie exactly; both packages
    put the lower expert id first, as ``jax.lax.top_k`` does."""
    w = _weights(3)
    r = w["router"]
    r[:, 6] = r[:, 1]
    r[:, 5] = r[:, 3]
    r[:, 7] = r[:, 3]
    over = dict(top_k=4, router_act=mode)
    (jv, ji), (tv, ti) = _route_both(over, _x(4), w)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **ROUTE_TOL)
    # all-equal logits: the first k expert ids, in order
    flat = dict(w, router=np.zeros_like(r))
    (_, ji), (_, ti) = _route_both(over, _x(4), flat)
    np.testing.assert_array_equal(ti, np.broadcast_to(np.arange(4),
                                                      ti.shape))
    np.testing.assert_array_equal(ti, ji)


def _experts_both(fn, over, x, w, bias):
    jspec, tspec = _spec(jmoe, **over), _spec(tmoe, **over)
    jv, ji = jmoe.route(jspec, jnp.asarray(x), jnp.asarray(w["router"]))
    names = ["expert_gate", "expert_up", "expert_down"]
    if bias:
        names += ["expert_gate_bias", "expert_up_bias", "expert_down_bias"]
    want = getattr(jmoe, fn)(jspec, jnp.asarray(x), jv, ji,
                             *(jnp.asarray(w[n]) for n in names))
    tv, ti = tmoe.route(tspec, torch.from_numpy(x),
                        torch.from_numpy(w["router"]))
    got = getattr(tmoe, fn)(tspec, torch.from_numpy(x), tv, ti,
                            *(torch.from_numpy(w[n]) for n in names))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("fn", ["experts_dense", "experts_ragged"])
@pytest.mark.parametrize("name", sorted(EXPERT_CASES))
def test_experts_match_jax(fn, name):
    over = EXPERT_CASES[name]
    bias = bool(over.get("expert_bias"))
    want, got = _experts_both(fn, over, _x(5), _weights(6, bias=bias), bias)
    assert got.shape == (B, T, H) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **EXPERT_TOL)


@pytest.mark.parametrize("dense_max_tokens", [64, 0])
def test_moe_block_with_shared_experts_matches_jax(dense_max_tokens):
    """The whole block (route, experts, shared experts) on the dense path
    (B·T = 10 <= 64) and the ragged one (threshold 0)."""
    over = dict(shared_intermediate=24, dense_max_tokens=dense_max_tokens)
    w = _weights(7, shared=24)
    x = _x(8)
    want = jmoe.moe_block(_spec(jmoe, **over), jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in w.items()})
    got = tmoe.moe_block(_spec(tmoe, **over), torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in w.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXPERT_TOL)


def test_dense_and_ragged_paths_agree_and_take_their_threshold(
        monkeypatch):
    """``moe_block`` takes the dense path at B·T <= dense_max_tokens and
    the ragged one above; both give the same output (fp32)."""
    w = {k: torch.from_numpy(v) for k, v in _weights(9).items()}
    x = torch.from_numpy(_x(10, b=4, t=4))                   # B·T = 16
    seen = []
    for name in ("experts_dense", "experts_ragged"):
        def counted(*a, _orig=getattr(tmoe, name), _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tmoe, name, counted)
    dense = tmoe.moe_block(_spec(tmoe, dense_max_tokens=16), x, w)
    ragged = tmoe.moe_block(_spec(tmoe, dense_max_tokens=15), x, w)
    assert seen == ["experts_dense", "experts_ragged"]
    np.testing.assert_allclose(dense.numpy(), ragged.numpy(), **EXPERT_TOL)


def test_group_ends_and_grouped_mm_match_a_loop():
    """The device-side group offsets and the grouped product, with empty
    groups, against a per-group loop (the ``ragged_dot`` contract)."""
    rng = np.random.default_rng(11)
    sizes = np.asarray([0, 5, 0, 3, 9, 0, 1, 2])
    ids = torch.from_numpy(np.repeat(np.arange(E), sizes))
    ends = tmoe.group_ends(ids, E)
    assert ends.dtype == torch.int32
    np.testing.assert_array_equal(ends.numpy(), np.cumsum(sizes))
    a = rng.standard_normal((int(sizes.sum()), H)).astype(np.float32)
    w = rng.standard_normal((E, H, I)).astype(np.float32)
    got = tmoe.grouped_mm(torch.from_numpy(a), torch.from_numpy(w), ends)
    want = np.concatenate([a[s - n:s] @ w[e] for e, (n, s) in enumerate(
        zip(sizes, np.cumsum(sizes))) if n])
    np.testing.assert_allclose(got.numpy(), want, **EXPERT_TOL)
    jwant = jax.lax.ragged_dot(jnp.asarray(a), jnp.asarray(w),
                               jnp.asarray(sizes, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               **EXPERT_TOL)


@pytest.mark.parametrize("case", ["tkg_experts_local", "quantized_leaf"])
def test_unported_expert_layouts_raise(case):
    """``tkg_experts_local`` (the hybrid decode layout, a layout across a
    mesh, ROADMAP A13b) no longer raises: on one card it keeps the stored
    layout and both paths match the JAX block with the knob on. A
    quantized expert leaf (int8 per-channel ``expert_up``, the
    reference's quantizer) does not raise either: both paths match the
    JAX block on the same leaf."""
    w = {k: torch.from_numpy(v) for k, v in _weights(12).items()}
    x = torch.from_numpy(_x(13))
    if case == "tkg_experts_local":
        for dense_max in (64, 0):
            want = jmoe.moe_block(
                _spec(jmoe, dense_max_tokens=dense_max,
                      tkg_experts_local=True), jnp.asarray(x.numpy()),
                jax.tree.map(jnp.asarray, _weights(12)), phase="decode")
            got = tmoe.moe_block(_spec(tmoe, dense_max_tokens=dense_max,
                                       tkg_experts_local=True),
                                 x, w, phase="decode")
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **EXPERT_TOL)
        return
    host = _weights(12)
    host["expert_up"] = jq.quantize_tensor(host["expert_up"], jq.QuantSpec())
    w["expert_up"] = {k: torch.from_numpy(np.asarray(v))
                      for k, v in host["expert_up"].items()}
    assert w["expert_up"]["qweight"].dtype == torch.int8
    for dense_max in (64, 0):
        want = jmoe.moe_block(_spec(jmoe, dense_max_tokens=dense_max),
                              jnp.asarray(x.numpy()),
                              jax.tree.map(jnp.asarray, host),
                              phase="decode")
        got = tmoe.moe_block(_spec(tmoe, dense_max_tokens=dense_max), x, w,
                             phase="decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **EXPERT_TOL)
