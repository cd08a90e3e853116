"""Bucket ladder generation — a copy of
``neuronx_distributed_inference_tpu/modules/autobucketing.py`` (reference:
modules/autobucketing.py), so the port pads prefill windows and sizes
block tables exactly as the JAX package does. The telemetry counter of
bucket selections is left out.

Buckets are the static shapes we AOT-compile; the host pads each request to
the smallest bucket that fits (reference: generate_buckets :8-20 — powers of
two between min and max)."""

from __future__ import annotations

from typing import List, Optional


def generate_buckets(min_len: int, max_len: int) -> List[int]:
    """Powers-of-2 ladder from min to max, always including max
    (reference: autobucketing.py:8-20)."""
    if min_len >= max_len:
        return [max_len]
    buckets = []
    b = max(min_len, 1)
    # round min up to a power of two
    while b & (b - 1):
        b += b & -b
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def context_encoding_buckets(tpu_config) -> List[int]:
    """Prefill bucket ladder (reference: autobucketing.py:149)."""
    if not tpu_config.enable_bucketing:
        return [tpu_config.max_context_length]
    if tpu_config.context_encoding_buckets:
        return sorted(tpu_config.context_encoding_buckets)
    return generate_buckets(128, tpu_config.max_context_length)


def token_generation_buckets(tpu_config) -> List[int]:
    """Decode-side bucket ladder over total sequence length
    (reference: autobucketing.py:226). The decode graph compiled for bucket
    ``b`` READS only cache slots [0, b) — early decode streams a fraction of
    the allocated cache (the decode step is HBM-bound, so this is a direct
    throughput win; the reference's TKG seq buckets serve the same role)."""
    if not tpu_config.enable_bucketing:
        return [tpu_config.seq_len]
    if tpu_config.token_generation_buckets:
        return sorted(tpu_config.token_generation_buckets)
    return generate_buckets(128, tpu_config.seq_len)


def get_target_bucket(buckets: List[int], length: int) -> int:
    """Smallest bucket >= length (reference: model_wrapper.py:831-921)."""
    for b in buckets:
        if b >= length:
            return b
    raise ValueError(f"length {length} exceeds largest bucket {buckets[-1]}")


def batch_buckets(tpu_config) -> List[int]:
    """TKG batch-bucket ladder (reference: 2-D batch x seq TKG buckets,
    autobucketing.py:203): with 2-D bucketing a short batch pads to the
    smallest BATCH bucket instead of the full compiled batch — fewer pad
    rows, at the cost of extra compiled graphs. 1-D mode keeps the single
    full-batch bucket."""
    full = tpu_config.batch_size
    if not (tpu_config.enable_bucketing and tpu_config.enable_2d_bucketing):
        return [full]
    if tpu_config.tkg_batch_buckets:
        out = sorted(set(tpu_config.tkg_batch_buckets))
        if out[-1] != full:
            raise ValueError("tkg_batch_buckets must end at batch_size")
        return out
    return generate_buckets(1, full)


def ragged_row_buckets(ctx_buckets: List[int],
                       chunk_tokens: Optional[int] = None) -> List[int]:
    """THE unified per-row width ladder of the ragged mixed dispatch
    (serving/ragged/, README "Ragged dispatch"): one ladder covers every
    row shape a ``paged_ragged_step`` dispatch can carry — decode steps
    (width 1), speculative verify windows (width k+1) and prefill chunks
    (width up to the chunk cap) — so mixed load warms ONE set of shapes
    instead of the three separate ctx / prefill-chunk / spec-width
    ladders it used to pay.

    The ladder is the powers-of-2 ramp from 1 up to the smallest ctx
    bucket, merged with the ctx buckets themselves (so chunk dispatches
    keep running at already-compiled ctx-bucket widths), capped at the
    smallest ctx bucket covering ``chunk_tokens`` (``None`` = the full
    ctx ladder)."""
    if not ctx_buckets:
        raise ValueError("ragged_row_buckets needs a non-empty ctx ladder")
    if chunk_tokens is None:
        cap = ctx_buckets[-1]
    else:
        cap = get_target_bucket(ctx_buckets,
                                min(chunk_tokens, ctx_buckets[-1]))
    low = generate_buckets(1, ctx_buckets[0])
    return sorted({b for b in low if b <= cap}
                  | {b for b in ctx_buckets if b <= cap})


def prefill_chunk_buckets(ctx_buckets: List[int],
                          chunk_tokens: Optional[int] = None) -> List[int]:
    """DEPRECATED — thin wrapper over :func:`ragged_row_buckets`, kept so
    external callers and existing tests keep working: the old standalone
    prefill-chunk width ladder is the ctx-bucket slice of the unified
    ragged ladder (chunk dispatches only ever ran at already-compiled
    ctx-bucket widths). New code should consume ``ragged_row_buckets``
    directly — the ragged dispatch pads prefill rows, decode rows and
    verify windows to the SAME ladder."""
    ctx = set(ctx_buckets)
    return [b for b in ragged_row_buckets(ctx_buckets, chunk_tokens)
            if b in ctx]


def spec_width_buckets(max_width: int) -> List[int]:
    """DEPRECATED — thin wrapper over :func:`ragged_row_buckets`, kept so
    external callers and existing tests keep working: the old standalone
    verify-width ladder is the unified ragged ladder of a one-bucket
    "ctx" ladder at ``max_width`` (= speculation k + 1; always starts at
    1, so a fully clamped batch degenerates to an eager-width verify).
    New code should consume ``ragged_row_buckets`` directly."""
    if max_width < 1:
        raise ValueError(f"spec width must be >= 1, got {max_width}")
    return ragged_row_buckets([max_width])


def block_table_buckets(tpu_config, max_blocks: int) -> List[int]:
    """Paged-app block-table width ladder (reference: 2-D prefix x prefill
    buckets, autobucketing.py:22-64 + selection model_wrapper.py:923-1045):
    each paged call sizes its table to the smallest bucket covering the
    live blocks instead of always max_blocks — the attention gather /
    ragged kernel grid shrink with it."""
    if not (tpu_config.enable_bucketing and tpu_config.enable_2d_bucketing):
        return [max_blocks]
    return generate_buckets(1, max_blocks)


