"""The port's collectives (``parallel/collectives``) on the CPU: the
int8 and fp8 two-phase ring all-reduce and reduce-scatter at g 2 and 4,
each rank a process spawned over gloo (one world of 4, the g-2 ring over
its first two ranks), against the JAX package's ring under ``shard_map``
on the same inputs (the same codes: equal within fp32 summation order)
and within ``RING_TOL`` of the exact sum, as the reference's
tests/test_quantized_collectives.py:55-257 holds its ring; the group of
one is the identity; the typed refusals; the plain all-reduce and
all-gather; the wire pricing of the census (an int8 entry at a quarter of
the fp32 one, DCN against ICI); the routing: an NCCL mesh never moves
its tensors through the host, a gloo mesh on the card does; and rank 0's
dispatch records (``parallel/dispatch``), which reach the other ranks
with every argument's type, dtype and value, each schema sent once."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from neuronx_distributed_inference_tpu.parallel import \
    collectives as jcoll
from neuronx_distributed_inference_tpu_torch.parallel import (
    collectives, dispatch)
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    DP_OVER_DCN, Mesh, spawn_world)
from neuronx_distributed_inference_tpu_torch.resilience.errors import \
    ConfigurationError
from neuronx_distributed_inference_tpu_torch.telemetry import observatory

import torch_tp_ranks

RING_TOL = {"int8": 0.02, "fp8": 0.06}
# the two rings quantize the same partial sums in the same order; what
# may part them is fp32 rounding (the dequantized hop plus the local
# chunk, XLA's fused multiply against torch's), a few ulps of the sum
SAME_RING = dict(atol=1e-5, rtol=1e-5)
CASES = [(op, dtype, g) for op in ("all_reduce", "reduce_scatter")
         for dtype in ("int8", "fp8") for g in (2, 4)]


def _inputs():
    """Each case's per-rank partial sums: the reference test's draws
    (shards of (1, 128) from N(0, 1), seed 0 for the all-reduce, 1 for the
    reduce-scatter)."""
    out = {}
    for op, dtype, g in CASES:
        rng = np.random.default_rng(0 if op == "all_reduce" else 1)
        out[(op, dtype, g)] = np.stack([rng.normal(size=(1, 128))
                                        for _ in range(g)]).astype(
                                            np.float32)
    return out


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    xs = _inputs()
    got = spawn_world(torch_tp_ranks.rings_at, 4, "gloo", "cpu",
                      str(tmp_path_factory.mktemp("ring_world")), 120.0,
                      (xs, CASES))
    plain = spawn_world(torch_tp_ranks.plain_at, 2, "gloo", "cpu",
                        str(tmp_path_factory.mktemp("plain_world")),
                        120.0, (list(xs["all_reduce", "int8", 2]),))
    return xs, got, plain


def _jax_ring(op, dtype, x):
    g = x.shape[0]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:g]), ("tp",))
    fn = (jcoll.quantized_all_reduce if op == "all_reduce"
          else jcoll.quantized_reduce_scatter)
    with jax.sharding.set_mesh(mesh):
        out = jax.jit(jax.shard_map(
            lambda xl: fn(xl[0], "tp", g, dtype=dtype, block=32)[None],
            mesh=mesh, in_specs=P("tp"), out_specs=P("tp"),
            check_vma=False))(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ring_matches_the_jax_ring_and_the_exact_sum(rings, case):
    op, dtype, g = case
    xs, got, _ = rings
    want = _jax_ring(op, dtype, xs[case])
    exact = xs[case].sum(axis=0)
    chunk = exact.shape[-1] // g
    for r in range(g):
        mine = got[r][case]
        np.testing.assert_allclose(mine, want[r], **SAME_RING)
        ref = exact if op == "all_reduce" else exact[..., r * chunk:
                                                     (r + 1) * chunk]
        rel = np.abs(mine - ref).max() / np.abs(exact).max()
        assert rel < RING_TOL[dtype], (case, r, rel)
    if op == "all_reduce":
        # rank r keeps its own chunk at full precision, as the JAX ring
        assert not np.array_equal(got[0][case], got[1][case])


def test_plain_all_reduce_and_all_gather(rings):
    xs, _, plain = rings
    pair = list(xs["all_reduce", "int8", 2])
    for red, gat in plain:
        np.testing.assert_allclose(red, pair[0] + pair[1], rtol=1e-6)
        np.testing.assert_array_equal(gat, np.concatenate(pair, axis=-1))


def test_group_of_one_is_identity():
    x = torch.arange(64, dtype=torch.float32)[None, :]
    one = Mesh(None, "gloo", "cpu", 0, 1)
    for fn in (collectives.quantized_all_reduce,
               collectives.quantized_reduce_scatter):
        assert fn(x, one) is x


def test_refusals_are_typed():
    with pytest.raises(ConfigurationError, match="int4"):
        collectives.require_supported_dtype("int4")
    four = Mesh(None, "gloo", "cpu", 0, 4)
    with pytest.raises(ConfigurationError, match="block"):
        collectives.quantized_all_reduce(torch.ones(1, 64), four,
                                         dtype="int8", block=3)
    with pytest.raises(ConfigurationError, match="divisible"):
        collectives.quantized_all_reduce(torch.ones(1, 62), four,
                                         dtype="int8")


def test_fake_tensors_are_heard_not_run():
    """On fake tensors (the observatory's count) the collectives run
    nothing and report each op: a ring of g ranks is 2 (g - 1) hops of
    codes and scales."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    four = Mesh(None, "gloo", "cpu", 0, 4)
    heard = []
    with FakeTensorMode(), collectives.collective_listener(heard.append):
        x = torch.empty(2, 256)
        collectives.all_reduce(x, four)
        assert collectives.all_gather(x, four).shape == (2, 1024)
        out = collectives.quantized_all_reduce(x, four, dtype="int8")
        assert out.shape == (2, 256)
    kinds = [e["kind"] for e in heard]
    assert kinds[:2] == ["all_reduce", "all_gather"]
    hops = heard[2:]
    assert len(hops) == 2 * 2 * 3
    assert {e["dtype"] for e in hops} == {"int8", "float32"}
    assert heard[1]["elems"] == 2 * 1024


def _entry(dtype, elem_bytes, kind="all_reduce", comm="tp", elems=4096,
           g=4):
    return {"kind": kind, "comm": comm, "dtype": dtype, "elems": elems,
            "elem_bytes": elem_bytes, "bytes": elems * elem_bytes,
            "group_size": g}


@pytest.mark.parametrize("dtype,eb", [("s8", 1), ("f8e4m3fn", 1)])
def test_wire_bytes_price_by_element_width(dtype, eb):
    f32, q = _entry("f32", 4), _entry(dtype, eb)
    assert observatory._wire_bytes(q) * (4 / eb) == pytest.approx(
        observatory._wire_bytes(f32))
    assert (observatory.comm_roofline_seconds([q], 200.0, 25.0) * 4
            == pytest.approx(observatory.comm_roofline_seconds(
                [f32], 200.0, 25.0)))
    assert observatory._wire_bytes(f32) == pytest.approx(
        2 * 3 / 4 * 4096 * 4)
    assert observatory._wire_bytes_saved(q) == pytest.approx(
        2 * 3 / 4 * 4096 * (4 - eb))
    assert observatory._wire_bytes_saved(f32) == 0.0


def test_wire_pricing_dcn_vs_ici():
    tp, dp = _entry("s8", 1, comm="tp"), _entry("s8", 1, comm="dp")
    t_tp = observatory.comm_roofline_seconds([tp], 200.0, 25.0,
                                             topology=DP_OVER_DCN)
    t_dp = observatory.comm_roofline_seconds([dp], 200.0, 25.0,
                                             topology=DP_OVER_DCN)
    assert t_dp == pytest.approx(t_tp * 200.0 / 25.0)
    agg = observatory.aggregate_census([tp, tp, dp])
    assert agg == {"all_reduce@tp@s8": {"count": 2, "bytes": 8192},
                   "all_reduce@dp@s8": {"count": 1, "bytes": 4096}}


def test_host_route_only_for_a_gloo_group_on_the_card():
    """NCCL never takes the host route; gloo takes it for CUDA tensors
    only (the caller's choice of backend), never on the CPU."""
    assert not Mesh(None, "nccl", "cuda:0", 0, 2).host_route
    assert Mesh(None, "gloo", "cuda:0", 0, 2).host_route
    assert not Mesh(None, "gloo", "cpu", 0, 2).host_route


@pytest.mark.parametrize("case", ["rank_fails", "rank_hangs"])
def test_a_failed_or_hung_rank_fails_its_caller(tmp_path, case):
    """``spawn_world`` never hangs its caller: a rank that raises fails
    the call with the rank's traceback, a rank that outlives the time
    limit fails it at the limit, and every rank is stopped."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        if case == "rank_fails":
            spawn_world(torch_tp_ranks.fail_at, 2, "gloo", "cpu",
                        str(tmp_path), 60.0)
        else:
            spawn_world(torch_tp_ranks.hang_at, 2, "gloo", "cpu",
                        str(tmp_path), 6.0, (600.0,))
    msg = str(err.value)
    assert ("fails on purpose" in msg if case == "rank_fails"
            else "did not finish within 6.0 s" in msg), msg
    assert time.monotonic() - t0 < 50.0


def test_a_rank_that_lingers_after_its_result_is_stopped(tmp_path):
    """A rank whose process outlives its result (an NCCL group's teardown
    can hang) is stopped ``EXIT_GRACE_S`` after the results are in: the
    world returns them well before its time limit."""
    import time

    from neuronx_distributed_inference_tpu_torch.parallel import mesh
    t0 = time.monotonic()
    got = spawn_world(torch_tp_ranks.linger_at, 2, "gloo", "cpu",
                      str(tmp_path), 120.0, (600.0,))
    assert got == [0, 1]
    assert time.monotonic() - t0 < 60.0 + mesh.EXIT_GRACE_S


def _records():
    """Dispatch records of every kind of argument, two schemas: the first
    four records share one (their numbers and shapes differ; the fourth's
    host bytes outgrow the frame), the last two the other."""
    rng = np.random.default_rng(7)
    recs = []
    for b, w in ((2, 5), (3, 1), (4, 7), (64, 80)):
        recs.append(("_run_ragged", (
            rng.integers(0, 500, size=(b, w)).astype(np.int32),
            rng.integers(-3, 9, size=(b,)).astype(np.int64),
            np.zeros((b, 0), np.int32), w, -(2 ** 40) - w),
            {"row_seeds": torch.arange(b, dtype=torch.int64),
             "sampling_params": torch.rand(b, 3).to(torch.bfloat16),
             "want_hidden": False, "adapter_ids": None}))
    for t in (0.5, 1.25):
        recs.append(("_run_decode_loop", (
            [np.float32(t), np.int64(3)], (t, "greedy", True)),
            {"mask": np.array([[True, False]]),
             "nested": {"a": (np.arange(3, dtype=np.float64), [1, 2])}}))
    return recs


def _same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a == b
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


def test_dispatch_records_reach_every_rank(tmp_path):
    """Rank 0's records reach the other ranks as sent: arrays, tensors,
    numpy scalars, ints (past 32 bits), floats, empty arrays, and the
    constant parts (None, bools, strings, the tree) in place; two schemas
    for six records (each pickled once); one broadcast a record whose
    host bytes fit the frame, and one more for the record they outgrow."""
    recs = _records()
    assert sum(np.asarray(a).nbytes for a in recs[3][1][:3]) > dispatch.ROOM
    got = spawn_world(torch_tp_ranks.records_at, 3, "gloo", "cpu",
                      str(tmp_path), 120.0, (recs,))
    # six frames, the stop's and the big host payload's
    assert got[0] == (2, len(recs) + 1 + 1)
    for r in (1, 2):
        mine = pickle.loads(got[r])
        assert len(mine) == len(recs)
        for want, rec in zip(recs, mine):
            _same(want, rec)


def test_dispatch_records_refuse_what_they_cannot_carry():
    """A record whose dims and numbers outgrow the header, or that holds
    an array torch cannot view as bytes, raises before anything is
    sent."""
    ch = dispatch.Channel(Mesh(None, "gloo", "cpu", 0, 2))
    with pytest.raises(ConfigurationError, match="header values"):
        ch.send("_run_paged", tuple(range(dispatch.HEADER)), {})
    with pytest.raises(ConfigurationError, match="cannot carry"):
        ch.send("_run_paged", (np.array(["a", "b"], dtype=object),), {})
    assert ch.schemas == 0
