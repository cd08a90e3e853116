"""The port's threefry PRNG and coupled sampler against jax 0.9's.

``ops/sampling.py`` copies JAX's threefry2x32 (``jax_threefry_partitionable``
on, as tests/conftest.py sets it): keys, random bits and uniform floats are
held to EXACT equality with jax's; the gumbel noise to ``atol=1e-6`` (torch's
``log`` and XLA's differ by about one ULP: where larger, two ULPs of the
value, and in the tail near u = 1 the error four ULPs of log(u) make
there); the coupled sampler's tokens to
equality except where the reference's two largest perturbed scores lie
within ``NEAR_TIE`` of each other (such rows are counted and printed, never
re-seeded away)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import \
    OnDeviceSamplingConfig as JOnDeviceSamplingConfig
from neuronx_distributed_inference_tpu.ops import sampling as jsampling
from neuronx_distributed_inference_tpu_torch.config import \
    OnDeviceSamplingConfig
from neuronx_distributed_inference_tpu_torch.ops import sampling

GUMBEL_ATOL = 1e-6
NEAR_TIE = 1e-5
SEEDS = [0, 1, -1, -3, 2 ** 31 - 1, -2 ** 31]
POSITIONS = np.arange(131072, dtype=np.int32)


def _gumbel_close(got, want) -> float:
    """Largest |got - want| over the allowed difference (at most 1
    passes): GUMBEL_ATOL; or two fp32 ULPs of the value, where larger
    (one ULP of ``log`` becomes one ULP of the output: 9.5e-7 at |g| = 8);
    or, in the tail where u nears 1, four ULPs of log(u) below 1 (2**-24
    each) carried through the outer log, 4 * 2**-24 * e**g: there
    -log(u) is tiny and g = -log(-log(u)) magnifies the inner log's
    absolute error (one run in ~15 differed from XLA's CPU log by ~1e-4,
    100x GUMBEL_ATOL, at a value this prints when it fails)."""
    want = np.asarray(want, np.float32)
    tol = np.maximum(GUMBEL_ATOL, 2 * np.spacing(np.abs(want)))
    tol = np.maximum(tol, 4 * 2.0 ** -24 * np.exp(want.astype(np.float64)))
    ratio = np.abs(np.asarray(got, np.float32) - want) / tol
    i = np.unravel_index(ratio.argmax(), ratio.shape)
    print(f"gumbel worst at g = {want[i]:.6f}: |difference| "
          f"{abs(float(np.asarray(got)[i]) - float(want[i])):.3e}, "
          f"{float(ratio[i]):.3f} of its bound")
    return float(ratio[i])


def _jax_stream_keys(stream_seed, seeds, positions):
    return np.asarray(jax.random.key_data(jax.vmap(
        lambda s, p: jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(stream_seed), s), p))(
        jnp.asarray(seeds, jnp.int32), jnp.asarray(positions, jnp.int32))))


def _torch_keys(stream_seed, seeds, positions):
    return sampling.stream_keys(stream_seed, torch.as_tensor(seeds),
                                torch.as_tensor(positions))


def _jax_keyed(fn, keys, n):
    return np.asarray(jax.vmap(lambda k: fn(jax.random.wrap_key_data(k),
                                            (n,)))(
        jnp.asarray(keys.numpy().astype(np.uint32))))


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_keys_equal_jax_exactly(seed):
    """fold_in(fold_in(PRNGKey(stream), seed), pos) for positions
    0-131071 (stream seeds 11 and the request seed itself): every key word
    equals jax's."""
    seeds = np.full(POSITIONS.shape, seed, np.int32)
    for stream in (11, seed):
        want = _jax_stream_keys(stream, seeds, POSITIONS)
        got = _torch_keys(stream, seeds, POSITIONS).numpy()
        assert np.array_equal(got, want.astype(np.int64))


def test_prng_key_and_fold_in_equal_jax():
    for seed in SEEDS:
        k0, k1 = sampling.prng_key(seed)
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        assert [k0, k1] == want.astype(np.int64).tolist()
        data = np.asarray([0, 5, -7, 2 ** 31 - 1], np.int32)
        got = sampling.fold_in((k0, k1), torch.as_tensor(data)).numpy()
        ref = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.PRNGKey(seed), jnp.int32(d)))) for d in data])
        assert np.array_equal(got, ref.astype(np.int64))


def test_random_bits_and_uniform_equal_jax_exactly():
    """32-bit random bits (256 per key) and the uniform floats on
    [tiny, 1) built from them are bit-identical to jax's."""
    seeds = np.asarray(SEEDS * 8, np.int32)
    keys = _torch_keys(11, seeds, np.arange(seeds.size, dtype=np.int32)
                       * 4099)
    bits = _jax_keyed(lambda k, s: jax.random.bits(k, s, jnp.uint32),
                      keys, 256)
    assert np.array_equal(sampling.random_bits(keys, 256).numpy(),
                          bits.astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    uni = _jax_keyed(lambda k, s: jax.random.uniform(
        k, s, jnp.float32, minval=tiny), keys, 256)
    got = sampling.uniform(keys, 256, tiny, 1.0).numpy()
    assert np.array_equal(got.view(np.int32), uni.view(np.int32))


def test_gumbel_within_one_ulp_of_log():
    """The gumbel noise agrees to GUMBEL_ATOL, or the ULP bounds of
    ``_gumbel_close`` where larger (XLA's log and torch's differ by an
    ULP)."""
    seeds = np.repeat(np.asarray(SEEDS, np.int32), 64)
    keys = _torch_keys(7, seeds, np.arange(seeds.size, dtype=np.int32))
    want = _jax_keyed(lambda k, s: jax.random.gumbel(k, s, jnp.float32),
                      keys, 256)
    got = sampling.gumbel(keys, 256).numpy()
    print(f"gumbel max abs difference {np.abs(got - want).max():.3e}")
    assert _gumbel_close(got, want) <= 1.0


def _near_ties(logits, cfg_kw, params, seeds, positions):
    """Rows where the reference's two largest perturbed scores lie within
    NEAR_TIE: their token may differ by the log ULP."""
    jcfg = JOnDeviceSamplingConfig(**cfg_kw)
    sp = (jnp.broadcast_to(jnp.asarray([[jcfg.top_k, jcfg.top_p,
                                         jcfg.temperature]], jnp.float32),
                           (logits.shape[0], 3))
          if params is None else jnp.asarray(params))
    probs, _ = jsampling.truncated_probs(jnp.asarray(logits), sp,
                                         jcfg.global_topk)
    keys = jsampling.stream_keys(jcfg.stream_seed, jnp.asarray(seeds),
                                 jnp.asarray(positions))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (probs.shape[-1],),
                                             jnp.float32))(keys)
    score = np.asarray(jnp.where(probs > 0, jnp.log(probs) + g, -jnp.inf))
    top2 = -np.sort(-score, axis=-1)[:, :2]
    return np.abs(top2[:, 0] - top2[:, 1]) < NEAR_TIE


@pytest.mark.parametrize("per_row_params", [False, True])
@pytest.mark.parametrize("shape", [(16, 512), (4, 5, 512)])
def test_coupled_sample_matches_jax(shape, per_row_params):
    """coupled_sample on (B=16, V=512) and (B, T, V) logits gives the
    reference's tokens, except at counted near-ties."""
    rng = np.random.default_rng(5)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    b = shape[0]
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, size=b).astype(np.int32)
    positions = rng.integers(0, 131072, size=shape[:-1]).astype(np.int32)
    cfg_kw = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.7,
                  stream_seed=1234)
    params = None
    if per_row_params:
        params = np.stack([rng.integers(1, 64, b), rng.uniform(0.5, 1, b),
                           rng.uniform(0.5, 1.5, b)], 1).astype(np.float32)
    want = np.asarray(jsampling.coupled_sample(
        jnp.asarray(logits), JOnDeviceSamplingConfig(**cfg_kw),
        None if params is None else jnp.asarray(params),
        jnp.asarray(seeds), jnp.asarray(positions)))
    got = sampling.coupled_sample(
        torch.as_tensor(logits), OnDeviceSamplingConfig(**cfg_kw),
        None if params is None else torch.as_tensor(params),
        torch.as_tensor(seeds), torch.as_tensor(positions)).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    flat_logits = logits.reshape(-1, shape[-1])
    flat_seeds = np.broadcast_to(seeds.reshape(b, *([1] * (len(shape) - 2))),
                                 shape[:-1]).reshape(-1)
    flat_params = (None if params is None else
                   np.repeat(params, flat_logits.shape[0] // b, axis=0))
    ties = _near_ties(flat_logits, cfg_kw, flat_params, flat_seeds,
                      positions.reshape(-1))
    differ = got.reshape(-1) != want.reshape(-1)
    print(f"near-ties {int(ties.sum())} of {ties.size}; token differences "
          f"{int(differ.sum())}")
    assert not (differ & ~ties).any()


def test_coupled_sample_breaks_ties_as_lax_top_k():
    """bf16 logits share few distinct values, so the kept candidates tie
    often; the draw hangs its noise on their ranks, so the tie order must
    be ``jax.lax.top_k``'s (the lower index first). On bf16-rounded logits
    every token equals the reference's (exact equality: no noise
    difference can matter where the ranks agree and the gumbel values
    differ by 1e-6 only at near-ties, counted as in the test above)."""
    rng = np.random.default_rng(0)
    logits = torch.as_tensor((1.3 * rng.standard_normal((32, 32000)))
                             .astype(np.float32)).to(torch.bfloat16).float()
    sorted_vals = logits.sort(dim=-1, descending=True).values[:, :50]
    assert (sorted_vals[:, 1:] == sorted_vals[:, :-1]).any(dim=1).all()
    cfg_kw = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.7,
                  stream_seed=1234)
    seeds = np.arange(32, dtype=np.int32)
    positions = np.arange(32, dtype=np.int32) + 100
    want = np.asarray(jsampling.coupled_sample(
        jnp.asarray(logits.numpy()), JOnDeviceSamplingConfig(**cfg_kw),
        None, jnp.asarray(seeds), jnp.asarray(positions)))
    got = sampling.coupled_sample(
        logits, OnDeviceSamplingConfig(**cfg_kw), None,
        torch.as_tensor(seeds), torch.as_tensor(positions)).numpy()
    ties = _near_ties(logits.numpy(), cfg_kw, None, seeds, positions)
    differ = got != want
    print(f"near-ties {int(ties.sum())} of {ties.size}; token differences "
          f"{int(differ.sum())}")
    assert not (differ & ~ties).any()


def test_coupled_sample_is_position_keyed_and_deterministic_mode():
    """The same (seed, position) draws the same token in any batch; a
    different position or request seed forks it; ``deterministic`` takes
    the argmax of the truncated distribution, as the reference does."""
    rng = np.random.default_rng(2)
    logits = torch.as_tensor(rng.standard_normal((1, 512)).astype(
        np.float32)).expand(64, 512)
    cfg = OnDeviceSamplingConfig(do_sample=True, top_k=50, top_p=0.95,
                                 temperature=1.5, stream_seed=3)
    seeds = torch.zeros(64, dtype=torch.int32)
    pos = torch.arange(64, dtype=torch.int32)
    toks = sampling.coupled_sample(logits, cfg, None, seeds, pos)
    again = sampling.coupled_sample(logits[:8], cfg, None, seeds[:8],
                                    pos[:8])
    assert torch.equal(toks[:8], again)
    assert len(set(toks.tolist())) > 4
    det = OnDeviceSamplingConfig(do_sample=True, deterministic=True,
                                 top_k=50, stream_seed=3)
    jdet = JOnDeviceSamplingConfig(do_sample=True, deterministic=True,
                                   top_k=50, stream_seed=3)
    got = sampling.coupled_sample(logits, det, None, seeds, pos)
    want = np.asarray(jsampling.coupled_sample(
        jnp.asarray(logits.numpy()), jdet, None, jnp.asarray(seeds.numpy()),
        jnp.asarray(pos.numpy())))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_cuda_coupled_sampler_equals_cpu():
    """On the card: the same keys and random bits as on the CPU, gumbel
    within the bounds of ``_gumbel_close``, and the coupled tokens of (B=16, V=128256) logits
    equal the CPU's except at near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    seeds = torch.as_tensor(np.repeat(np.asarray(SEEDS, np.int32), 512))
    pos = torch.arange(seeds.numel(), dtype=torch.int32) * 37
    cpu = sampling.stream_keys(1234, seeds, pos)
    card = sampling.stream_keys(1234, seeds.cuda(), pos.cuda())
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(sampling.random_bits(card, 256).cpu(),
                       sampling.random_bits(cpu, 256))
    assert _gumbel_close(sampling.gumbel(card, 256).cpu().numpy(),
                         sampling.gumbel(cpu, 256).numpy()) <= 1.0
    rng = np.random.default_rng(9)
    logits = torch.as_tensor((3.0 * rng.standard_normal((16, 128256)))
                             .astype(np.float32))
    cfg = OnDeviceSamplingConfig(do_sample=True, top_k=50, top_p=0.9,
                                 temperature=0.7, stream_seed=1234)
    s16, p16 = seeds[:16], pos[:16]
    got = sampling.coupled_sample(logits.cuda(), cfg, None, s16.cuda(),
                                  p16.cuda()).cpu()
    want = sampling.coupled_sample(logits, cfg, None, s16, p16)
    probs, _ = sampling.truncated_probs(logits, sampling._config_params(
        cfg, 16, "cpu"), cfg.global_topk)
    g = sampling.gumbel(sampling.stream_keys(1234, s16, p16),
                        probs.shape[-1])
    score = torch.where(probs > 0, torch.log(probs) + g,
                        torch.full_like(probs, float("-inf")))
    top2 = score.topk(2, dim=-1).values
    ties = (top2[:, 0] - top2[:, 1]).abs() < NEAR_TIE
    assert not ((got != want) & ~ties).any()
