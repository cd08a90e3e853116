"""On-device sampling (counterpart:
``neuronx_distributed_inference_tpu/ops/sampling.py:24-100``, ``stream_keys``
:102, ``coupled_sample`` :116 and ``sample`` :169): greedy argmax, or
per-request top-k / top-p / temperature sampling over a (B, 3)
``[top_k, top_p, temperature]`` parameter tensor.

Two sources of noise:

  * :func:`sample` draws from an explicit ``torch.Generator``; those draws
    are not the JAX package's, so such sampled streams of the two packages
    differ (and a generator draw cannot be replayed by a captured graph);
  * :func:`coupled_sample` keys every draw by (stream seed, request seed,
    absolute position) through a bit-exact copy of JAX's threefry2x32 PRNG
    (``jax._src.prng`` of jax 0.9 with ``jax_threefry_partitionable``:
    ``threefry_seed``, ``fold_in``, the partitionable random bits; and
    ``jax._src.random``'s ``uniform`` and ``gumbel``). Keys and random bits
    equal JAX's exactly. The gumbel noise agrees to about one ULP of the
    logarithm (torch's ``log`` is not XLA's), so a sampled token differs
    from the JAX package's only where two perturbed scores lie within
    ~1e-6 of each other.

The PRNG holds its uint32 words in int64 tensors masked to 32 bits
(torch's uint32 lacks add and shift on some devices); everything runs on
the logits' device, with no host read, so a captured graph can hold it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import OnDeviceSamplingConfig


def prepare_sampling_params(batch_size: int, top_k=1, top_p=1.0,
                            temperature=1.0) -> np.ndarray:
    """Host helper -> (B, 3) fp32 [top_k, top_p, temperature]."""

    def _bcast(v):
        a = np.asarray(v, dtype=np.float32).reshape(-1)
        if a.size == 1:
            a = np.full((batch_size,), a[0], dtype=np.float32)
        if a.size != batch_size:
            raise ValueError(f"sampling param batch {a.size} != "
                             f"{batch_size}")
        return a

    return np.stack([_bcast(top_k), _bcast(top_p), _bcast(temperature)],
                    axis=1)


def mask_padded_logits(logits: torch.Tensor, pad_size: int) -> torch.Tensor:
    """Mask the vocab-padding columns (the vocabulary is padded to a
    multiple of 128) with the dtype's most negative finite value."""
    if pad_size == 0:
        return logits
    v = logits.shape[-1]
    col = torch.arange(v, device=logits.device) >= (v - pad_size)
    return logits.masked_fill(col, torch.finfo(logits.dtype).min)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) -> (…,) int32 argmax (first index on ties, like jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` leaves ties in no set order). Returns
    (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def truncated_probs(logits: torch.Tensor, sampling_params: torch.Tensor,
                    global_topk: int = 256):
    """logits (B, V) + sampling_params (B, 3) -> (probs, top_idx), both
    (B, k) with k = min(global_topk, V) in ``jax.lax.top_k``'s order,
    probs renormalized over the kept prefix. top_k <= 0 means no k
    truncation beyond ``global_topk``."""
    b, v = logits.shape
    k = min(global_topk, v)
    lf = logits.float()
    # ties in ``jax.lax.top_k``'s order matter: bf16 logits share few
    # distinct values, and the coupled draw hangs its noise on the ranks
    top_vals, top_idx = top_k(lf, k)
    sp = sampling_params.to(device=lf.device, dtype=torch.float32)
    req_k, req_p = sp[:, 0], sp[:, 1]
    temp = torch.clamp(sp[:, 2], min=1e-6)
    ranks = torch.arange(k, dtype=torch.float32, device=lf.device)[None, :]
    kmask = torch.where(req_k[:, None] > 0, ranks < req_k[:, None],
                        torch.ones_like(ranks, dtype=torch.bool))
    scaled = top_vals / temp[:, None]
    probs = torch.softmax(scaled.masked_fill(~kmask, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    pmask = (cum - probs) < req_p[:, None]
    probs = torch.where(pmask & kmask, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs, top_idx


def topk_topp_sample(logits: torch.Tensor, sampling_params: torch.Tensor,
                     generator: Optional[torch.Generator],
                     global_topk: int = 256,
                     deterministic: bool = False) -> torch.Tensor:
    """Per-request top-k/top-p/temperature sampling: a gumbel-max draw over
    the truncated distribution, noise from ``generator``."""
    probs, top_idx = truncated_probs(logits, sampling_params, global_topk)
    if deterministic:
        choice = torch.argmax(probs, dim=-1)
    else:
        u = torch.rand(probs.shape, generator=generator,
                       device=probs.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        g = -torch.log(-torch.log(u.clamp(min=tiny)))
        score = torch.where(probs > 0, torch.log(probs) + g,
                            torch.full_like(probs, float("-inf")))
        choice = torch.argmax(score, dim=-1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# threefry2x32, as jax 0.9 defines it (jax_threefry_partitionable=True)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher (``jax._src.prng.threefry2x32``, 20
    rounds, 5 key injections) over uint32 words held in int64 tensors;
    ``k0, k1`` (the key) and ``x0, x1`` (the counter) broadcast. Returns
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for an int32 seed: the key words
    (0, seed mod 2**32), as Python ints (they enter the cipher as
    scalars, so no tensor is copied to the device)."""
    return 0, int(seed) & _M32


def fold_in(keys, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys a (..., 2) tensor or one
    (k0, k1) pair of ints, data (...) int32 values (a negative one folds
    in its two's complement) -> (..., 2)."""
    k0, k1 = ((keys[..., 0], keys[..., 1])
              if isinstance(keys, torch.Tensor) else keys)
    d = data.long() & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: keys (..., 2) ->
    (..., n) int64 holding uint32 values. The partitionable counters of a
    1-D shape are (0, i); the 32 bits are the XOR of the two words."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(i), i)
    return b0 ^ b1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    23 mantissa bits under the exponent of 1.0, minus 1, scaled, then
    clamped below at ``minval``."""
    mant = ((random_bits(keys, n) >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    return torch.clamp(f * (maxval - minval) + minval, min=minval)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per key:
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def stream_keys(stream_seed: int, seeds: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Per-draw keys of the positionally coupled stream: row i's key is
    ``fold_in(fold_in(PRNGKey(stream_seed), seeds[i]), positions[i])``,
    a pure function of (engine stream seed, request seed, absolute
    position of the sampled token). seeds, positions (N,) -> (N, 2)."""
    return fold_in(fold_in(prng_key(stream_seed), seeds), positions)


def _config_params(config: OnDeviceSamplingConfig, n: int,
                   device) -> torch.Tensor:
    """(n, 3) fp32 [top_k, top_p, temperature] from the config, built by
    fills (no host-to-device copy, so a captured graph can hold it)."""
    return torch.stack([torch.full((n,), float(v), dtype=torch.float32,
                                   device=device)
                        for v in (config.top_k, config.top_p,
                                  config.temperature)], dim=1)


def coupled_sample(logits: torch.Tensor, config: OnDeviceSamplingConfig,
                   sampling_params: Optional[torch.Tensor],
                   seeds: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Positionally coupled top-k/top-p/temperature sampling: the gumbel
    noise of each row has the fixed shape (k,) and the key of
    :func:`stream_keys`, so the sampled token is a pure function of
    (stream_seed, request seed, position, logits) and any graph that
    samples that position (eager decode, the draft loop, a verify column,
    a ragged row) draws the same token. That is what makes exact-match
    acceptance of sampled drafts preserve the stream.

    logits (B, V) with seeds (B,) / positions (B,), or (B, T, V) with
    seeds (B,) broadcast over columns and positions (B, T);
    sampling_params (B, 3) (repeated per column) or None (the config's).
    Returns int32 tokens of shape logits.shape[:-1]."""
    shape = logits.shape[:-1]
    if logits.dim() == 3:
        b, t, v = logits.shape
        logits = logits.reshape(b * t, v)
        seeds = seeds.reshape(b, 1).expand(b, t).reshape(-1)
        positions = positions.reshape(-1)
        if sampling_params is not None and sampling_params.shape[0] == b:
            sampling_params = torch.repeat_interleave(sampling_params, t,
                                                      dim=0)
    if sampling_params is None:
        sampling_params = _config_params(config, logits.shape[0],
                                         logits.device)
    probs, top_idx = truncated_probs(logits, sampling_params,
                                     config.global_topk)
    if config.deterministic:
        choice = torch.argmax(probs, dim=-1)
    else:
        keys = stream_keys(config.stream_seed or 0, seeds.to(logits.device),
                           positions.to(logits.device))
        g = gumbel(keys, probs.shape[-1])
        score = torch.where(probs > 0, torch.log(probs) + g,
                            torch.full_like(probs, float("-inf")))
        choice = torch.argmax(score, dim=-1)
    toks = torch.gather(top_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return toks.reshape(shape)


def sample(logits: torch.Tensor, config: Optional[OnDeviceSamplingConfig],
           sampling_params: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy vs multinomial; (B, V) or (B, T, V) logits -> int32 tokens."""
    shape = logits.shape[:-1]
    logits = logits.reshape(-1, logits.shape[-1])
    if sampling_params is None and (config is None or not config.do_sample):
        toks = greedy_sample(logits)
    else:
        if sampling_params is None:
            sampling_params = torch.tensor(
                [[config.top_k, config.top_p, config.temperature]],
                dtype=torch.float32, device=logits.device).expand(
                    logits.shape[0], 3)
        elif sampling_params.shape[0] != logits.shape[0]:
            sampling_params = torch.repeat_interleave(
                sampling_params,
                logits.shape[0] // sampling_params.shape[0], dim=0)
        toks = topk_topp_sample(
            logits, sampling_params, generator,
            config.global_topk if config else 256,
            config.deterministic if config else False)
    return toks.reshape(shape)


# ---------------------------------------------------------------------------
# data-parallel sampling (counterpart ops/sampling.py:198-237)
# ---------------------------------------------------------------------------

def sampling_seed(seed: int, dp_index: int = 0) -> int:
    """The generator seed of dp replica ``dp_index``: ``seed`` on replica
    0 (a one-replica app draws as before), another seed on every other
    replica, so that no two replicas draw the same noise."""
    return (int(seed) + dp_index * 0x9E3779B97F4A7C15) % (1 << 63)


def _key_tensor(key, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(key, dtype=np.int64) & _M32,
                           device=device).reshape(2)


def keyed_sample(logits: torch.Tensor,
                 config: Optional[OnDeviceSamplingConfig],
                 sampling_params: Optional[torch.Tensor] = None,
                 key=None) -> torch.Tensor:
    """The counterpart's :func:`sample` with its PRNG ``key`` (the two
    uint32 words of ``jax.random.PRNGKey``): greedy, or the gumbel-max
    draw over the truncated distribution with the noise of
    ``jax.random.gumbel(key, probs.shape)`` bit for bit."""
    shape = logits.shape[:-1]
    logits = logits.reshape(-1, logits.shape[-1])
    if sampling_params is None and (config is None or not config.do_sample):
        return greedy_sample(logits).reshape(shape)
    if sampling_params is None:
        sampling_params = _config_params(config, logits.shape[0],
                                         logits.device)
    elif sampling_params.shape[0] != logits.shape[0]:
        sampling_params = torch.repeat_interleave(
            sampling_params, logits.shape[0] // sampling_params.shape[0],
            dim=0)
    probs, top_idx = truncated_probs(
        logits, sampling_params, config.global_topk if config else 256)
    if config is not None and config.deterministic:
        choice = torch.argmax(probs, dim=-1)
    else:
        g = gumbel(_key_tensor(key, logits.device)[None],
                   probs.numel()).reshape(probs.shape)
        choice = torch.argmax(torch.where(
            probs > 0, torch.log(probs) + g,
            torch.full_like(probs, float("-inf"))), dim=-1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0].to(
        torch.int32).reshape(shape)


def sample_replica(logits: torch.Tensor, config, sampling_params, key,
                   dp_index: int) -> torch.Tensor:
    """Replica ``dp_index``'s share of :func:`sample_dp`: its rows'
    logits and sampling params, the key folded with its index
    (``jax.random.fold_in(key, axis_index("dp"))``)."""
    if key is not None:
        dev = logits.device
        key = fold_in(_key_tensor(key, dev), torch.tensor(
            dp_index, dtype=torch.int64, device=dev))
    return keyed_sample(logits, config, sampling_params, key)


def sample_dp(logits: torch.Tensor, config, sampling_params=None, key=None,
              mesh=None) -> torch.Tensor:
    """Batch-sharded sampling (counterpart :198-237, the reference's
    ``DataParallelSampler``): replica ``mesh.dp_rank`` samples its rows
    [i·B/dp, (i+1)·B/dp) with the key folded with its index, and the
    tokens are gathered over dp. Without a dp axis, or with a batch dp
    does not divide, every replica samples the whole batch with the key
    as given."""
    b = logits.shape[0]
    if mesh is None or mesh.dp <= 1 or b % mesh.dp:
        return keyed_sample(logits, config, sampling_params, key)
    from ..parallel import collectives
    n = b // mesh.dp
    rows = slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)
    sp = (sampling_params[rows] if sampling_params is not None
          and sampling_params.shape[0] == b else sampling_params)
    toks = sample_replica(logits[rows], config, sp, key, mesh.dp_rank)
    return collectives.gather_dim(toks, mesh, "dp", 0)
