#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds every kernel
under ``neuronx_distributed_inference_tpu_torch/csrc/`` from source (one
nvcc per source, all started together), then:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, kernel build seconds;
  2. each kernel against its plain-PyTorch twin on the card, over the case
     matrix of the TPU kernel's tests, at the serving paths' shapes: the
     paged decode kernel, the contiguous decode kernel and the flash
     prefill kernel; then each decode kernel's fused merge: 23 calls,
     eager and under CUDA-graph replay, give one output bit for bit, the
     merge counters end at 0, and every split count 1-64 agrees with the
     twin;
  3. the paged path, bf16, Llama-3.2-1B geometry at full depth with random
     weights from seed 0: ``PagedCausalLMApplication.generate`` of 64 new
     tokens for 4 prompts; the paged kernel's launches must equal layers x
     all-decode steps, and every decode step's logits must agree with the
     same app and weights built with ``attn_block_tkg_kernel_enabled=False``
     (the gather path) fed the same tokens;
  4. paged serving, fp32 (TF32 off), same geometry: 6 requests with
     staggered admission through ``PagedEngineAdapter``; each stream must
     equal that prompt's single-request ``generate`` (a first difference is
     accepted only at a near-tie of the reference's top-2 logits, and
     printed);
  5. paged timings: kernel, plain twin and the SDPA yardstick as device
     time (CUDA-graph replay between CUDA events), prefill and decode steps
     on the host clock, and a torch.profiler trace of the decode steps
     (device time by kernel, device idle share);
  6. the contiguous path (the README's entry point), bf16, Mistral-7B-v0.1
     geometry at full width and depth with random weights from seed 0:
     ``CausalLMApplication.generate`` of 64 new tokens for 4 prompts with
     ``attn_kernel_enabled=True``; the flash kernel's launches must equal
     layers x prefill calls and the contiguous decode kernel's layers x
     decode steps, and the prefill and every decode step's logits must
     agree with the same app and weights built with both kernels off, fed
     the same tokens; then its timings as in 5;
  7. the window bites: full width, 4 layers, ``sliding_window=512``, the
     same prompts and checks as 6;
  8. contiguous serving, fp32 (TF32 off), full width, 8 layers: 6 requests
     with staggered admission through ``ContinuousBatchingAdapter``
     (decode on the gather path), each stream held to the single-request
     static ``generate`` (decode on the kernel) as in 4;
  9. ragged serving, bf16, Llama-3.1-8B geometry at full width and depth
     with random weights from seed 0:
     ``ServingEngine(PagedEngineAdapter(app, ragged=True,
     prefill_chunk_tokens=512))`` over a paged app (batch 8, seq_len 4096,
     block 32, prefix caching) serves 8 requests (37-1900 prompt tokens,
     48 new tokens each), four submitted at once and one more every 4
     passes, so mixed passes (decode rows plus prefill chunks) and
     all-decode passes both occur. Gates: every pass makes at most one
     ragged dispatch and one blocking fetch and no standalone prefill
     dispatch; the paged kernel's launches equal 32 x the all-decode
     ragged steps (head_dim 128); every stream holds 48 in-vocab tokens
     and finished on length. Prints the passes by kind, host ms per pass
     of each kind, time to first token, the pad waste, a torch.profiler
     trace of 8 all-decode and 4 mixed passes (device ms by kernel, device
     idle share), and the paged kernel at the served cache's shapes;
 10. ragged serving, fp32 (TF32 off), Llama-3.1-8B width, 4 layers: the
     same submissions with 24 new tokens through the ragged engine, the
     two-phase (non-ragged) engine and single-request ``generate`` on the
     same weights; the ragged streams must equal both (a first difference
     only at a near-tie of the reference's top-2 logits, printed), and the
     launch gate of 9 holds (fp32 pages: the kernel's CUDA-core route).

Every line before the last is one JSON object; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no last line. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Llama-3.2-1B (HF config.json of meta-llama/Llama-3.2-1B)
LLAMA_3_2_1B = dict(
    model_type="llama", hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, vocab_size=128256, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, hidden_act="silu",
    tie_word_embeddings=True)

# Mistral-7B-v0.1 (HF config.json of mistralai/Mistral-7B-v0.1)
MISTRAL_7B = dict(
    model_type="mistral", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    vocab_size=32000, rms_norm_eps=1e-5, rope_theta=10000.0,
    sliding_window=4096, max_position_embeddings=32768, hidden_act="silu",
    tie_word_embeddings=False)

PROMPT_LENS = (37, 300, 900, 1500)      # phase 3 prompts (batch 4)
NEW_TOKENS = 64
SERVE_LENS = (23, 57, 101, 150, 77, 190)  # phases 4 and 8 requests
SERVE_TOKENS = 32
MISTRAL_LENS = (37, 300, 900, 1900)     # phases 6-7 prompts (ctx bucket 2048)
MISTRAL_SEQ = 4096

# Llama-3.1-8B (HF config.json of meta-llama/Llama-3.1-8B)
LLAMA_3_1_8B = dict(
    model_type="llama", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, vocab_size=128256, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    max_position_embeddings=131072, hidden_act="silu",
    tie_word_embeddings=False)
# phases 9-10: the ragged engine (batch 8, one spare block per row)
RAGGED = dict(lens=(37, 300, 900, 1900, 123, 640, 1500, 64), seq_len=4096,
              chunk=512, block=32)
RAGGED_TOKENS = 48                      # phase 9
RAGGED_CHECK_TOKENS = 24                # phase 10

# Tolerances, with their reasons:
# kernel vs twin, bf16 out: both accumulate in fp32 and round the output
#   to bf16 once; one bf16 ulp at |o| < 2 is <= 7.8e-3.
TOL_KERNEL_BF16 = 1e-2
# kernel vs twin, fp32 out: fp32 sums in another order (split-K online
#   softmax vs one softmax) differ by ~1e-6 relative.
TOL_KERNEL_FP32 = 1e-4


def tol_flash_bf16(inputs) -> float:
    """Flash kernel vs twin, bf16 out: both compute in fp32 and round the
    output to bf16 once, so they differ by at most one bf16 ulp of the
    output; each output is a convex combination of value rows, so |o| <=
    max |v|, and the ulp there is 2^(floor(log2 max|v|) - 7)."""
    vmax = inputs["v"].float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(vmax)) - 7)
# decode logits, kernel app vs gather app, bf16: the gather path rounds
#   the softmax probabilities to bf16 before the value product (the
#   kernel keeps them fp32) and every layer's output is rounded to bf16;
#   logits have std ~0.9 here and bf16 spacing 1.6e-2 at |x| in [2, 4).
TOL_LOGITS_BF16 = 0.25
# the contiguous path (prefill and decode logits): the same two roundings
#   differ between the kernel app and the kernels-off app, and over 32
#   layers at 4096 width they move the logits by ~0.4 at a logit std of
#   ~1.3 (measured), so a fixed bound says little. Both bf16 apps are
#   held to an fp32 app on the same (upcast) weights and tokens instead:
#   the kernels keep the probabilities in fp32, so the kernel app's mean
#   |logit error| must be no larger than the kernels-off app's, up to
#   this factor for rounding noise between the two.
TOL_CONTIG_VS_FP32 = 1.25
# fp32 serving: batched and single-row matmuls may take different kernels;
#   a stream may first differ only where the reference's top-2 logits are
#   closer than this.
NEAR_TIE = 1e-3

HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_kernels():
    """One nvcc per csrc/*.cu source, all started together."""
    import os
    from neuronx_distributed_inference_tpu_torch import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        list(ex.map(_build.build, names))
    return {n: round(_build.BUILD_SECONDS[n], 2) for n in names}


def time_cuda(fn, calls: int = 100, reps: int = 7) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (median). The graph
    takes the host out of the measurement: eager calls of a small kernel
    wait on Python and launch latency, not on the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                   # lazy init off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def time_eager(fn, calls: int = 200) -> float:
    """Host ms per call of ``fn`` called back to back, ending in a sync:
    what a caller pays, Python and launch overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_host(fn, reps: int = 5) -> float:
    """Median ms of ``fn`` on the host clock; ``fn`` ends in a sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernel against twin
# ---------------------------------------------------------------------------

def paged_inputs(gen, device, *, b, hq, hkv, d, bs, mb, lens, layers=1,
                 act_dtype, page_dtype, kv_scale=None):
    """Random q / new_k / new_v and a stacked page cache with each row's
    live pages scattered through a random block table (block 0 = null)."""
    import torch
    n = 1 + b * mb

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    pages = []
    for _ in range(2):
        p = rnd(layers, n, bs, hkv, d)
        if kv_scale is not None:
            p = p / kv_scale
        pages.append(p.to(page_dtype))
    perm = torch.randperm(n - 1, generator=gen, device=device)[:b * mb] + 1
    table = torch.zeros((b, mb), dtype=torch.int32, device=device)
    for i, ln in enumerate(lens):
        live = -(-(int(ln) + 1) // bs)
        table[i, :live] = perm[i * mb:i * mb + live].to(torch.int32)
    return dict(q=rnd(b, hq, d).to(act_dtype), k_pages=pages[0],
                v_pages=pages[1], new_k=rnd(b, hkv, d).to(act_dtype),
                new_v=rnd(b, hkv, d).to(act_dtype),
                lens=torch.tensor(lens, dtype=torch.int32, device=device),
                block_table=table)


def kernel_cases(device):
    """(name, inputs, kwargs, tolerance) over the TPU kernel's test matrix
    at the serving path's shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    slice_lens = [0, 1, 31, 32, 333, 1000, 1777, 2047]
    cases = []
    for dt, tol in ((torch.bfloat16, TOL_KERNEL_BF16),
                    (torch.float32, TOL_KERNEL_FP32)):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        cases.append((f"llama3.2-1b_{tag}", paged_inputs(
            gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64,
            lens=slice_lens, act_dtype=dt, page_dtype=dt),
            dict(scale=64 ** -0.5), tol))
        cases.append((f"llama3.1-8b_{tag}", paged_inputs(
            gen, device, b=8, hq=32, hkv=8, d=128, bs=32, mb=64,
            lens=slice_lens, act_dtype=dt, page_dtype=dt),
            dict(scale=128 ** -0.5), tol))
    sink = torch.randn((32,), generator=gen, device=device)
    cases.append(("window_sink_softcap_bf16", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        act_dtype=torch.bfloat16, page_dtype=torch.bfloat16),
        dict(scale=64 ** -0.5, window=100, sink=sink, soft_cap=5.0),
        TOL_KERNEL_BF16))
    cases.append(("stacked_layers_bf16", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        layers=3, act_dtype=torch.bfloat16, page_dtype=torch.bfloat16),
        dict(scale=64 ** -0.5, layer=2), TOL_KERNEL_BF16))
    cases.append(("fp8_e4m3_pages_kv_scale", paged_inputs(
        gen, device, b=8, hq=32, hkv=8, d=64, bs=32, mb=64, lens=slice_lens,
        act_dtype=torch.bfloat16, page_dtype=torch.float8_e4m3fn,
        kv_scale=0.5), dict(scale=64 ** -0.5, kv_scale=0.5),
        TOL_KERNEL_BF16))
    return cases


def check_kernel_against_twin(inputs, kw):
    """max |kernel - twin| for one input set (both on the card)."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    kw = dict(kw)
    layer = kw.pop("layer", 0)
    args = (inputs["q"], inputs["k_pages"], inputs["v_pages"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"],
            inputs["block_table"])
    got = decode_attention.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = decode_attention.paged_decode_attention_plain(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return err


def contiguous_inputs(gen, device, *, b, hq, hkv, d, s, lens, layers=1,
                      act_dtype, cache_dtype, kv_scale=None):
    """Random q / new_k / new_v and a stacked contiguous cache, K
    transposed (L, B, Hkv, D, S) and V (L, B, Hkv, S, D)."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    caches = []
    for shape in ((layers, b, hkv, d, s), (layers, b, hkv, s, d)):
        c = rnd(*shape)
        if kv_scale is not None:
            c = c / kv_scale
        caches.append(c.to(cache_dtype))
    return dict(q=rnd(b, hq, d).to(act_dtype), k_cache=caches[0],
                v_cache=caches[1], new_k=rnd(b, hkv, d).to(act_dtype),
                new_v=rnd(b, hkv, d).to(act_dtype),
                lens=torch.tensor(lens, dtype=torch.int32, device=device))


def decode_cases(device):
    """(name, inputs, kwargs, tolerance) for the contiguous decode kernel
    at Mistral-7B shapes (Hq 32, Hkv 8, D 128, S 4096, batch 4)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(3)
    lens = [0, 517, 2048, 4095]
    mk = dict(b=4, hq=32, hkv=8, s=MISTRAL_SEQ, lens=lens)
    cases = []
    for dt, tol in ((torch.bfloat16, TOL_KERNEL_BF16),
                    (torch.float32, TOL_KERNEL_FP32)):
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        cases.append((f"mistral-7b_L2_{tag}", contiguous_inputs(
            gen, device, d=128, layers=2, act_dtype=dt, cache_dtype=dt,
            **mk), dict(scale=128 ** -0.5, layer=1), tol))
    cases.append(("d64_bf16", contiguous_inputs(
        gen, device, d=64, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **mk), dict(scale=64 ** -0.5),
        TOL_KERNEL_BF16))
    sink = torch.randn((32,), generator=gen, device=device)
    cases.append(("window1024_sink_softcap_bf16", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **mk),
        dict(scale=128 ** -0.5, window=1024, sink=sink, soft_cap=5.0),
        TOL_KERNEL_BF16))
    cases.append(("fp8_e4m3_cache_kv_scale", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.float8_e4m3fn, kv_scale=0.5, **mk),
        dict(scale=128 ** -0.5, kv_scale=0.5), TOL_KERNEL_BF16))
    # S not a multiple of a 16-byte piece's keys: K loaded key by key
    cases.append(("s4095_bf16", contiguous_inputs(
        gen, device, d=128, act_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, **dict(mk, s=MISTRAL_SEQ - 1)),
        dict(scale=128 ** -0.5, window=1024), TOL_KERNEL_BF16))
    return cases


def decode_args(inputs, kw):
    kw = dict(kw)
    layer = kw.pop("layer", 0)
    return (inputs["q"], inputs["k_cache"], inputs["v_cache"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"]), kw


def check_decode_against_twin(inputs, kw):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    args, kw = decode_args(inputs, kw)
    got = decode_attention.decode_attention_stacked(*args, **kw)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_stacked_plain(*args, **kw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return (got.float() - want.float()).abs().max().item()


def flash_cases(device):
    """(name, inputs, kwargs, tolerance) for the flash prefill kernel at
    Mistral-7B shapes (Hq 32, Hkv 8)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(4)

    def qkv(b, s, d, dt):
        return {n: torch.randn((b, s, h, d), generator=gen,
                               device=device).to(dt)
                for n, h in (("q", 32), ("k", 8), ("v", 8))}
    bf = torch.bfloat16
    return [
        ("b2_s2048_d128_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5), tol_flash_bf16),
        ("window512_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=512), tol_flash_bf16),
        ("softcap30_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, soft_cap=30.0), tol_flash_bf16),
        ("d64_bf16", qkv(2, 2048, 64, bf), dict(scale=64 ** -0.5),
         tol_flash_bf16),
        ("s512_fp32", qkv(2, 512, 128, torch.float32),
         dict(scale=128 ** -0.5), TOL_KERNEL_FP32),
        ("s128_one_tile_bf16", qkv(4, 128, 128, bf),
         dict(scale=128 ** -0.5), tol_flash_bf16),
        ("window200_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=200), tol_flash_bf16),
        ("softcap30_window200_bf16", qkv(2, 2048, 128, bf),
         dict(scale=128 ** -0.5, window=200, soft_cap=30.0),
         tol_flash_bf16),
        ("d64_window200_bf16", qkv(2, 1024, 64, bf),
         dict(scale=64 ** -0.5, window=200), tol_flash_bf16),
    ]


def check_flash_against_twin(inputs, kw):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention
    args = (inputs["q"], inputs["k"], inputs["v"])
    got = flash_attention.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_plain(*args, **kw)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output is not finite")
    return (got.float() - want.float()).abs().max().item()


def check_fused_merge(phase, call, plain, splits_attr):
    """A fused decode kernel's merge: ``call()`` 3 times eagerly and 10
    times in one CUDA graph replayed twice gives the first output bit for
    bit (the merging block puts its counter back to 0), the counters end
    at 0, and every split count 1 to 64 (the wrapper's ``splits_attr``
    overridden) agrees with ``plain()``, the twin."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    first = call()
    same = [torch.equal(call(), first) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(10)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same += [torch.equal(o, first) for o in outs]
    zero = int(decode_attention.merge_counters(first.device, 32).abs()
               .sum()) == 0
    want = plain()
    num_splits = getattr(decode_attention, splits_attr)
    errs = []
    try:
        for n in range(1, 65):
            setattr(decode_attention, splits_attr, lambda *a, n=n: n)
            errs.append((call().float() - want.float()).abs().max().item())
    finally:
        setattr(decode_attention, splits_attr, num_splits)
    emit({"phase": phase, "calls_identical": sum(same),
          "calls": len(same), "counters_zero": zero,
          "splits_checked": len(errs), "max_abs_err_over_splits": max(errs),
          "tol": TOL_KERNEL_BF16})
    if not (all(same) and zero and max(errs) <= TOL_KERNEL_BF16):
        raise AssertionError(f"{phase}: eager / graph outputs differ, "
                             "counters not reset, or a split count "
                             "disagrees with the twin")


def check_fused_merges(device):
    """Both decode kernels' fused merges (:func:`check_fused_merge`), each
    at its main path's decode shapes: paged B 4, Hq 32, Hkv 8, D 64, lens
    100/363/963/1563; contiguous B 4, Hq 32, Hkv 8, D 128, S 4096, lens
    100/363/963/1963; bf16."""
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    gen = torch.Generator(device=device).manual_seed(6)
    x = paged_inputs(gen, device, b=4, hq=32, hkv=8, d=64, bs=32, mb=64,
                     lens=[100, 363, 963, 1563], act_dtype=torch.bfloat16,
                     page_dtype=torch.bfloat16)
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    check_fused_merge(
        "paged_fused_merge",
        lambda: decode_attention.paged_decode_attention(*args, scale=0.125),
        lambda: decode_attention.paged_decode_attention_plain(*args,
                                                              scale=0.125),
        "num_splits")
    gen = torch.Generator(device=device).manual_seed(7)
    x = contiguous_inputs(gen, device, b=4, hq=32, hkv=8, d=128,
                          s=MISTRAL_SEQ, lens=[100, 363, 963, 1963],
                          act_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16)
    cargs, kw = decode_args(x, dict(scale=128 ** -0.5))
    check_fused_merge(
        "contiguous_fused_merge",
        lambda: decode_attention.decode_attention_stacked(*cargs, **kw),
        lambda: decode_attention.decode_attention_stacked_plain(*cargs,
                                                                **kw),
        "contiguous_num_splits")


def reset_launches():
    """Set every kernel's launch count to 0."""
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    decode_attention.paged_decode_attention.launches = 0
    decode_attention.decode_attention_stacked.launches = 0
    flash_attention.flash_attention.launches = 0


def phase_kernels(device):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for kernel, cases, check in (
            ("paged_decode_attention", kernel_cases, check_kernel_against_twin),
            ("decode_attention_stacked", decode_cases,
             check_decode_against_twin),
            ("flash_attention", flash_cases, check_flash_against_twin)):
        for name, inputs, kw, tol in cases(device):
            if callable(tol):
                tol = tol(inputs)
            err = check(inputs, kw)
            results[(kernel, name)] = err
            emit({"phase": "kernel_vs_twin", "kernel": kernel, "case": name,
                  "max_abs_err": err, "tol": tol})
            if not err <= tol:
                raise AssertionError(f"{kernel} {name}: max abs err {err} "
                                     f"> {tol}")
        torch.cuda.empty_cache()
    check_fused_merges(device)
    # comparison launches are not main-path launches
    reset_launches()
    return results


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------

def make_app(hf, device, dtype, *, batch, seq_len, kernel=None,
             prefix_caching=True, output_logits=False, num_blocks=None):
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        PagedCausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.llama import (
        LlamaFamily, LlamaInferenceConfig)
    tcfg = TpuConfig(batch_size=batch, seq_len=seq_len, dtype=dtype,
                     is_block_kv_layout=True, pa_block_size=32,
                     pa_num_blocks=num_blocks,
                     is_prefix_caching=prefix_caching,
                     output_logits=output_logits,
                     attn_block_tkg_kernel_enabled=kernel)
    app = PagedCausalLMApplication(None, LlamaInferenceConfig(tcfg, **hf),
                                   LlamaFamily, device=device)
    return app.init_cache()


def prompts_of(lens, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    width = max(lens)
    ids = np.zeros((len(lens), width), np.int64)
    mask = np.zeros((len(lens), width), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def phase_main_path(hf, device, on_card=True):
    import numpy as np
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    app = make_app(hf, device, "bfloat16", batch=len(PROMPT_LENS),
                   seq_len=2048, output_logits=True)
    app.init_random_weights(0)
    ids, mask = prompts_of(PROMPT_LENS, hf["vocab_size"], seed=0)
    reset_launches()
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True)
    gen_s = time.perf_counter() - t0
    launches = decode_attention.paged_decode_attention.launches
    decode_steps = NEW_TOKENS - 1
    want = hf["num_hidden_layers"] * decode_steps if on_card else 0
    emit({"phase": "main_path", "generate_s": gen_s, "launches": launches,
          "expected_launches": want, "decode_steps": decode_steps,
          "generated_shape": list(out["generated"].shape)})
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"decode steps {want}")
    gen = out["generated"]
    if gen.shape != (len(PROMPT_LENS), NEW_TOKENS) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"bad generated tokens {gen.shape}")

    # the gather path, same weights, fed the kernel app's tokens
    ref = make_app(hf, device, "bfloat16", batch=len(PROMPT_LENS),
                   seq_len=2048, kernel=False, output_logits=True)
    ref.params = app.params
    ref_out = ref.generate(ids, attention_mask=mask,
                           max_new_tokens=NEW_TOKENS, return_logits=True,
                           teacher_tokens=gen[:, :decode_steps])
    errs = []
    for step in range(1, NEW_TOKENS):
        a, b = out["logits"][step], ref_out["logits"][step]
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite logits at decode step {step}")
        errs.append(float(np.abs(a - b).max()))
    worst = max(errs)
    emit({"phase": "main_path_vs_gather", "decode_steps_compared":
          len(errs), "max_abs_logit_diff": worst,
          "mean_step_max_diff": float(np.mean(errs)),
          "ref_logit_std": float(np.std(ref_out["logits"][1])),
          "tol": TOL_LOGITS_BF16})
    if not worst <= TOL_LOGITS_BF16:
        raise AssertionError(f"decode logits differ from the gather path "
                             f"by {worst} > {TOL_LOGITS_BF16}")
    return app, ids, mask, launches


# ---------------------------------------------------------------------------
# Phase 4: serving through the adapter, fp32
# ---------------------------------------------------------------------------

def near_tie_check(phase, s, got, want, prompt_len):
    """The first difference of a served stream from the reference
    ``generate`` (``want`` with per-step logits) is accepted only where the
    reference's top-2 logits are closer than NEAR_TIE; returns the case
    or None."""
    import numpy as np
    exp = want["generated"][0]
    diff = np.nonzero(got != exp)[0]
    if not diff.size:
        return None
    i = int(diff[0])
    # step 0 is the prefill: its logits cover the whole window
    lg = want["logits"][i][0, prompt_len - 1 if i == 0 else 0]
    top2 = np.sort(lg)[-2:]
    margin = float(top2[1] - top2[0])
    case = {"seq_id": s, "first_diff_step": i, "margin": margin}
    emit({"phase": phase, **case, "bound": NEAR_TIE})
    if not margin < NEAR_TIE:
        raise AssertionError(f"stream {s} differs from generate at step {i} "
                             f"with top-2 margin {margin}")
    return case


def serve_staggered(eng, prompts):
    """Admit prompts 0-1 at step 0, 2-3 at step 8, 4-5 at step 16; release
    each stream once it holds SERVE_TOKENS tokens. Returns (streams,
    engine steps)."""
    streams = {i: [] for i in range(len(prompts))}
    admit_at = {0: (0, 1), 8: (2, 3), 16: (4, 5)}
    step = 0
    while True:
        if step in admit_at:
            sids = list(admit_at[step])
            first = eng.add_requests(sids, [prompts[s] for s in sids])
            for s, t in first.items():
                streams[s].append(t)
        done = [s for s in eng.seqs if len(streams[s]) >= SERVE_TOKENS]
        if done:
            eng.release(done)
        if not eng.seqs and step > max(admit_at):
            break
        for s, t in eng.step().items():
            streams[s].append(t)
        step += 1
    return streams, step


def phase_serving(hf, device):
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    app = make_app(hf, device, "float32", batch=8, seq_len=512)
    app.init_random_weights(0)
    ref = make_app(hf, device, "float32", batch=1, seq_len=512,
                   output_logits=True)
    ref.params = app.params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in SERVE_LENS]
    eng = PagedEngineAdapter(app)
    streams, step = serve_staggered(eng, prompts)
    near_ties = []
    for s, prompt in enumerate(prompts):
        want = ref.generate(np.asarray([prompt]),
                            max_new_tokens=SERVE_TOKENS, return_logits=True)
        ref.reset()
        case = near_tie_check("serving_near_tie", s,
                              np.asarray(streams[s][:SERVE_TOKENS]), want,
                              len(prompt))
        if case:
            near_ties.append(case)
    emit({"phase": "serving", "requests": len(prompts),
          "tokens_per_stream": SERVE_TOKENS, "engine_steps": step,
          "streams_identical": len(prompts) - len(near_ties),
          "near_ties": len(near_ties), "host_stats": eng.host_stats})


# ---------------------------------------------------------------------------
# Phase 5: timings
# ---------------------------------------------------------------------------

def kernel_bounds(inputs):
    """Least time for the kernel's work on the H100: bytes (live K/V rows,
    q, new_k/new_v, out, lens, the live table entries) over the HBM rate,
    and operations (QK and PV over the live keys plus the active token)
    over the peak rate of the page type; returns (ms, "bytes"|"operations")."""
    q, kp = inputs["q"], inputs["k_pages"]
    b, hq, d = q.shape
    bs, hkv = kp.shape[2], kp.shape[3]
    lens = [int(x) for x in inputs["lens"].tolist()]
    keys = sum(lens)
    kv_bytes = 2 * keys * hkv * d * kp.element_size()
    act_bytes = (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
    meta_bytes = 4 * b + 4 * sum(-(-n // bs) for n in lens)
    bytes_ms = (kv_bytes + act_bytes + meta_bytes) / HBM_BYTES_PER_S * 1e3
    flops = 4 * (keys + b) * hq * d
    rate = PEAK_FLOPS.get(str(kp.dtype).replace("torch.", ""),
                          PEAK_FLOPS["bfloat16"])
    ops_ms = flops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def sdpa_inputs(inputs, layer):
    """The same attention pre-gathered contiguously for
    ``scaled_dot_product_attention`` (the active token at slot lens[b])."""
    import torch
    kp, vp, table = inputs["k_pages"], inputs["v_pages"], inputs[
        "block_table"]
    b, hq, d = inputs["q"].shape
    mb, bs, hkv = table.shape[1], kp.shape[2], kp.shape[3]
    k = kp[layer][table.long()].reshape(b, mb * bs, hkv, d).clone()
    v = vp[layer][table.long()].reshape(b, mb * bs, hkv, d).clone()
    rows = torch.arange(b, device=k.device)
    lens = inputs["lens"].long()
    k[rows, lens] = inputs["new_k"]
    v[rows, lens] = inputs["new_v"]
    pos = torch.arange(mb * bs, device=k.device)[None, :]
    mask = (pos <= lens[:, None])[:, None, None, :]
    return (inputs["q"][:, :, None, :], k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask)


def contiguous_sdpa_inputs(inputs, layer, window=0):
    """The contiguous decode attention for ``scaled_dot_product_attention``
    (no sink, soft-cap or kv_scale; each lens[b] < S): K and V of layer
    ``layer`` as (B, Hkv, S, D) copies with the last dimension contiguous
    (SDPA's fused backends need stride(-1) == 1; the cache holds K
    transposed), the active token at slot lens[b], and a boolean mask of
    the keys at or before it (within ``window`` when it is > 0)."""
    import torch
    k = inputs["k_cache"][layer].transpose(2, 3).contiguous()
    v = inputs["v_cache"][layer].clone()
    b, s = k.shape[0], k.shape[2]
    rows = torch.arange(b, device=k.device)
    lens = inputs["lens"].long()
    k[rows, :, lens] = inputs["new_k"].to(k.dtype)
    v[rows, :, lens] = inputs["new_v"].to(v.dtype)
    pos = torch.arange(s, device=k.device)[None, :]
    live = pos <= lens[:, None]
    if window > 0:
        live &= lens[:, None] - pos < window
    return inputs["q"][:, :, None, :], k, v, live[:, None, None, :]


def device_kernels(fn):
    """(host ms, {kernel name: device ms}) of one ``fn()`` traced with
    ``torch.profiler`` (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3
    return wall, per


def profile_decode(prefill_only, prefill_and_decode, steps: int):
    """Device time by kernel and the device's idle share over ``steps``
    decode steps: the trace of prefill + decode minus the trace of the
    prefill alone."""
    try:
        w0, p0 = device_kernels(prefill_only)
        w1, p1 = device_kernels(prefill_and_decode)
    except RuntimeError as e:        # the profiler is optional equipment
        emit({"phase": "decode_profile", "measured": False,
              "reason": str(e)[:200]})
        return
    busy = sum(p1.values()) - sum(p0.values())
    wall = w1 - w0
    per_step = {n: (p1[n] - p0.get(n, 0.0)) / steps for n in p1}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "decode_profile", "measured": busy > 0,
          "steps": steps, "host_ms_per_step": wall / steps,
          "device_busy_ms_per_step": busy / steps,
          "device_idle_share": (1 - busy / wall) if busy > 0 else None,
          "top_kernels_ms_per_step": [[n[:80], ms] for n, ms in top]})


def phase_timings(hf, device, app, ids, mask, launches):
    b = len(PROMPT_LENS)
    timing_app = make_app(hf, device, "bfloat16", batch=b, seq_len=2048,
                          prefix_caching=False)
    timing_app.params = app.params

    def gen(n):
        timing_app.generate(ids, attention_mask=mask, max_new_tokens=n)
        timing_app.reset()
    prefill_ms = time_host(lambda: gen(1))
    k = 32
    decode_ms = (time_host(lambda: gen(1 + k)) - prefill_ms) / k
    profile_decode(lambda: gen(1), lambda: gen(1 + k), k)

    # the kernel at the main path's decode shapes, over the main path's
    # own cache and tables (positions after its last decode step)
    pos = [n + NEW_TOKENS - 1 for n in PROMPT_LENS]
    table = app.kv_mgr.block_table_array(range(b), app._bt_width(b))
    t = time_paged_kernel(app, table, pos, device, seed=2)
    emit({"phase": "timings", "prefill_ms_per_prompt": prefill_ms / b,
          "prefill_ms_batch": prefill_ms, "prompt_lens": list(PROMPT_LENS),
          "decode_ms_per_step_batch4": decode_ms, **t["report"],
          "launches": launches})
    return [paged_kernel_entry(t, launches, "paged_generate")]


def time_paged_kernel(app, table, pos, device, seed: int):
    """The paged kernel over ``app``'s own cache and block ``table`` at
    lens ``pos`` (last layer, random q and active token): held to its
    twin, then timed by CUDA-graph replay beside the twin, SDPA over the
    pre-gathered KV and the bound."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    spec = app.spec
    b = len(pos)
    gen_t = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen_t,
                           device=device).to(torch.bfloat16)
    inputs = dict(
        q=rnd(b, spec.num_q_heads, spec.head_dim),
        new_k=rnd(b, spec.num_kv_heads, spec.head_dim),
        new_v=rnd(b, spec.num_kv_heads, spec.head_dim),
        k_pages=app.cache["k"], v_pages=app.cache["v"],
        lens=torch.tensor(pos, dtype=torch.int32, device=device),
        block_table=torch.as_tensor(table, device=device))
    layer = spec.num_layers - 1
    kw = dict(scale=spec.scale)
    err = check_kernel_against_twin(dict(inputs), dict(kw, layer=layer))
    if not err <= TOL_KERNEL_BF16:
        raise AssertionError(f"kernel at main-path shapes: {err}")
    args = (inputs["q"], inputs["k_pages"], inputs["v_pages"],
            inputs["new_k"], inputs["new_v"], layer, inputs["lens"],
            inputs["block_table"])
    kernel_ms = time_cuda(
        lambda: decode_attention.paged_decode_attention(*args, **kw))
    kernel_eager_ms = time_eager(
        lambda: decode_attention.paged_decode_attention(*args, **kw))
    plain_ms = time_cuda(
        lambda: decode_attention.paged_decode_attention_plain(*args, **kw),
        calls=20)
    q4, k4, v4, m4 = sdpa_inputs(inputs, layer)
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=spec.scale, enable_gqa=True))
    bound_ms, bound_by = kernel_bounds(inputs)
    bs = app.kv_mgr.spec.block_size
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "report": {
                "kernel_us": kernel_ms * 1e3, "bound_us": bound_ms * 1e3,
                "kernel_eager_us": kernel_eager_ms * 1e3,
                "splits": decode_attention.num_splits(
                    b, spec.num_kv_heads, int(table.shape[1]), bs,
                    spec.head_dim),
                "plain_us": plain_ms * 1e3, "library_us": library_ms * 1e3,
                "max_abs_err": err, "kernel_shape": {
                    "B": b, "Hq": spec.num_q_heads, "Hkv": spec.num_kv_heads,
                    "D": spec.head_dim, "Bs": bs, "lens": list(pos),
                    "table_width": int(table.shape[1])}}}


def paged_kernel_entry(t, launches, path):
    """The paged kernel's object of the ``{"kernels": [...]}`` line;
    ``path`` names the run whose launches it counts."""
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "neuronx_distributed_inference_tpu_torch/csrc/"
                      "paged_decode_attention.cu",
            "replaces": "neuronx_distributed_inference_tpu/ops/"
                        "decode_attention.py:336",
            "launches": launches, "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "path": path, "shape": t["report"]["kernel_shape"]}


# ---------------------------------------------------------------------------
# Phases 6-8: the contiguous path
# ---------------------------------------------------------------------------

def make_contiguous_app(hf, device, dtype, *, batch, seq_len, kernels=True,
                        output_logits=False, cb=False):
    """``CausalLMApplication`` over the Mistral family. kernels=True: the
    flash prefill kernel (``attn_kernel_enabled``) and the decode kernel by
    default admission; False: both off (mha prefill, gather decode)."""
    from neuronx_distributed_inference_tpu_torch.config import TpuConfig
    from neuronx_distributed_inference_tpu_torch.models.application import \
        CausalLMApplication
    from neuronx_distributed_inference_tpu_torch.models.mistral import (
        MistralFamily, MistralInferenceConfig)
    tcfg = TpuConfig(batch_size=batch, seq_len=seq_len, dtype=dtype,
                     attn_kernel_enabled=kernels,
                     attn_block_tkg_kernel_enabled=None if kernels else False,
                     rolling_kv_cache=False, output_logits=output_logits,
                     is_continuous_batching=cb)
    app = CausalLMApplication(None, MistralInferenceConfig(tcfg, **hf),
                              MistralFamily, device=device)
    return app.init_cache()


def kernel_counts():
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    return {"paged_decode_attention":
            decode_attention.paged_decode_attention.launches,
            "decode_attention_stacked":
            decode_attention.decode_attention_stacked.launches,
            "flash_attention": flash_attention.flash_attention.launches}


def _upcast(params):
    """The parameter tree in fp32 (same values as the bf16 tree)."""
    if isinstance(params, dict):
        return {k: _upcast(v) for k, v in params.items()}
    return params.float()


def phase_contiguous(hf, device, phase: str):
    """Generate with both kernels, check their launch counts, then hold
    the prefill and every decode step's logits against the kernels-off app
    on the same weights and tokens. Returns (app, ids, mask, counts)."""
    import numpy as np
    import torch
    layers = hf["num_hidden_layers"]
    app = make_contiguous_app(hf, device, "bfloat16",
                              batch=len(MISTRAL_LENS), seq_len=MISTRAL_SEQ,
                              output_logits=True)
    app.init_random_weights(0)
    ids, mask = prompts_of(MISTRAL_LENS, hf["vocab_size"], seed=0)
    reset_launches()
    t0 = time.perf_counter()
    out = app.generate(ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
                       return_logits=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernel_counts()
    decode_steps = NEW_TOKENS - 1
    want = {"paged_decode_attention": 0,
            "decode_attention_stacked": layers * decode_steps,
            "flash_attention": layers * 1}
    gen = out["generated"]
    emit({"phase": phase, "generate_s": gen_s, "launches": counts,
          "expected_launches": want, "decode_steps": decode_steps,
          "prefill_calls": 1, "sliding_window": hf["sliding_window"],
          "layers": layers, "generated_shape": list(gen.shape)})
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    if gen.shape != (len(MISTRAL_LENS), NEW_TOKENS) or not (
            (gen >= 0) & (gen < hf["vocab_size"])).all():
        raise AssertionError(f"bad generated tokens {gen.shape}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logits = {"kernels": out["logits"]}
    for name, dtype in (("kernels_off", "bfloat16"),
                        ("fp32_reference", "float32")):
        ref = make_contiguous_app(hf, device, dtype,
                                  batch=len(MISTRAL_LENS),
                                  seq_len=MISTRAL_SEQ, kernels=False,
                                  output_logits=True)
        ref.params = (app.params if dtype == "bfloat16"
                      else _upcast(app.params))
        logits[name] = ref.generate(
            ids, attention_mask=mask, max_new_tokens=NEW_TOKENS,
            return_logits=True, teacher_tokens=gen[:, :decode_steps])[
                "logits"]
        del ref
        torch.cuda.empty_cache()
    real = np.arange(out["logits"][0].shape[1])[None, :] < np.asarray(
        MISTRAL_LENS)[:, None]                      # (B, bucket)

    def diffs(a_name, b_name):
        """(prefill max, decode max, mean over every compared logit) of
        |a - b|: prefill at the real positions, decode steps 1..63."""
        a, b = logits[a_name], logits[b_name]
        pre = np.abs(a[0] - b[0])[real]
        dec = np.stack([np.abs(a[i] - b[i]) for i in range(1, NEW_TOKENS)])
        n = pre.size + dec.size
        return (float(pre.max()), float(dec.max()),
                float((pre.sum(dtype=np.float64)
                       + dec.sum(dtype=np.float64)) / n))
    for name in logits:
        if not all(np.isfinite(x).all() for x in logits[name]):
            raise AssertionError(f"{phase}: non-finite {name} logits")
    direct = diffs("kernels", "kernels_off")
    k32 = diffs("kernels", "fp32_reference")
    o32 = diffs("kernels_off", "fp32_reference")
    emit({"phase": phase + "_logits",
          "kernels_vs_kernels_off": {"prefill_max": direct[0],
                                     "decode_max": direct[1],
                                     "mean": direct[2]},
          "kernels_vs_fp32": {"prefill_max": k32[0], "decode_max": k32[1],
                              "mean": k32[2]},
          "kernels_off_vs_fp32": {"prefill_max": o32[0],
                                  "decode_max": o32[1], "mean": o32[2]},
          "fp32_logit_std": float(np.std(logits["fp32_reference"][1])),
          "decode_steps_compared": decode_steps,
          "factor": TOL_CONTIG_VS_FP32})
    if not k32[2] <= TOL_CONTIG_VS_FP32 * o32[2]:
        raise AssertionError(
            f"{phase}: the kernel app's mean |logit error| vs fp32 {k32[2]} "
            f"exceeds {TOL_CONTIG_VS_FP32} x the kernels-off app's {o32[2]}")
    return app, ids, mask, counts


def phase_contiguous_serving(hf, device):
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    app = make_contiguous_app(hf, device, "float32", batch=8, seq_len=512,
                              cb=True)
    app.init_random_weights(0)
    ref = make_contiguous_app(hf, device, "float32", batch=1, seq_len=512,
                              output_logits=True)
    ref.params = app.params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in SERVE_LENS]
    reset_launches()
    eng = ContinuousBatchingAdapter(app)
    streams, step = serve_staggered(eng, prompts)
    served = kernel_counts()
    near_ties = []
    for s, prompt in enumerate(prompts):
        want = ref.generate(np.asarray([prompt]),
                            max_new_tokens=SERVE_TOKENS, return_logits=True)
        ref.reset()
        case = near_tie_check("cb_serving_near_tie", s,
                              np.asarray(streams[s][:SERVE_TOKENS]), want,
                              len(prompt))
        if case:
            near_ties.append(case)
    emit({"phase": "cb_serving", "layers": hf["num_hidden_layers"],
          "requests": len(prompts), "tokens_per_stream": SERVE_TOKENS,
          "engine_steps": step, "launches_while_serving": served,
          "streams_identical": len(prompts) - len(near_ties),
          "near_ties": len(near_ties), "host_stats": eng.host_stats})
    if served["flash_attention"] == 0:
        raise AssertionError("continuous-batching prefill never ran the "
                             "flash kernel")


def decode_bounds(inputs):
    """Least time for the contiguous decode kernel's work on the H100:
    bytes (each live K/V row once, q, new_k/new_v, out, lens) over the HBM
    rate and operations (QK and PV over the live keys plus the active
    token) over the bf16 peak; returns (ms, "bytes"|"operations")."""
    q, kc = inputs["q"], inputs["k_cache"]
    b, hq, d = q.shape
    hkv = kc.shape[2]
    keys = sum(int(x) for x in inputs["lens"].tolist())
    nbytes = (2 * keys * hkv * d * kc.element_size()
              + (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
              + 4 * b)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * (keys + b) * hq * d / PEAK_FLOPS["bfloat16"] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def flash_bounds(q, k, window: int = 0):
    """Least time for the flash kernel's causal work: tensor-core
    operations 4 * B * Hq * D * sum_q min(q + 1, window) keys (the keys
    each query attends) over the bf16 peak, and bytes (q, k, v read once,
    out written once) over the HBM rate."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if 0 < window < s:
        keys = window * (window + 1) // 2 + (s - window) * window
    else:
        keys = s * (s + 1) // 2
    ops_ms = (4 * b * hq * d * keys / PEAK_FLOPS["bfloat16"] * 1e3)
    bytes_ms = ((2 * b * s * hq * d + 2 * b * s * hkv * d)
                * q.element_size() / HBM_BYTES_PER_S * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def phase_contiguous_timings(hf, device, app, ids, mask, counts):
    """Prefill and decode step times of the Mistral app, the decode
    profile, and each kernel at the main path's shapes: device time,
    bound, plain twin, and the PyTorch yardstick (SDPA)."""
    import torch
    import torch.nn.functional as F
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention, flash_attention)
    spec = app.spec
    b = len(MISTRAL_LENS)
    timing_app = make_contiguous_app(hf, device, "bfloat16", batch=b,
                                     seq_len=MISTRAL_SEQ)
    timing_app.params = app.params

    def gen(n):
        timing_app.generate(ids, attention_mask=mask, max_new_tokens=n)
        torch.cuda.synchronize()
    prefill_ms = time_host(lambda: gen(1), reps=3)
    k = 32
    decode_ms = (time_host(lambda: gen(1 + k), reps=3) - prefill_ms) / k
    emit({"phase": "contiguous_steps", "prefill_ms_per_prompt":
          prefill_ms / b, "prefill_ms_batch": prefill_ms,
          "prompt_lens": list(MISTRAL_LENS), "ctx_bucket": 2048,
          "decode_ms_per_step_batch4": decode_ms})
    profile_decode(lambda: gen(1), lambda: gen(1 + k), k)
    del timing_app
    torch.cuda.empty_cache()

    # contiguous decode kernel over the main path's own cache (positions
    # after its last decode step), last layer
    gen_t = torch.Generator(device=device).manual_seed(5)
    hq, hkv, d = spec.num_q_heads, spec.num_kv_heads, spec.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen_t,
                           device=device).to(torch.bfloat16)
    pos = [n + NEW_TOKENS - 1 for n in MISTRAL_LENS]
    dec = dict(q=rnd(b, hq, d), k_cache=app.cache["k"],
               v_cache=app.cache["v"], new_k=rnd(b, hkv, d),
               new_v=rnd(b, hkv, d),
               lens=torch.tensor(pos, dtype=torch.int32, device=device))
    layer = spec.num_layers - 1
    dkw = dict(scale=spec.scale, window=spec.sliding_window, layer=layer)
    dec_err = check_decode_against_twin(dec, dkw)
    if not dec_err <= TOL_KERNEL_BF16:
        raise AssertionError(f"decode kernel at main-path shapes: {dec_err}")
    args, kw = decode_args(dec, dkw)
    dec_ms = time_cuda(
        lambda: decode_attention.decode_attention_stacked(*args, **kw))
    dec_plain_ms = time_cuda(
        lambda: decode_attention.decode_attention_stacked_plain(*args, **kw),
        calls=10)
    # SDPA over D-contiguous copies of the layer, active token at lens[b]
    q4, kk, vv, smask = contiguous_sdpa_inputs(dec, layer,
                                               spec.sliding_window)
    dec_lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=smask, scale=spec.scale, enable_gqa=True))
    del kk, vv
    dec_bound, dec_by = decode_bounds(dec)

    # flash kernel at the main path's prefill shapes (batch 4, bucket 2048)
    s = 2048
    fq = torch.randn((b, s, hq, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fk = torch.randn((b, s, hkv, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fv = torch.randn((b, s, hkv, d), generator=gen_t,
                     device=device).to(torch.bfloat16)
    fkw = dict(scale=spec.scale, window=spec.sliding_window)
    fl_err = check_flash_against_twin(dict(q=fq, k=fk, v=fv), fkw)
    if not fl_err <= tol_flash_bf16(dict(v=fv)):
        raise AssertionError(f"flash kernel at main-path shapes: {fl_err}")
    fl_ms = time_cuda(lambda: flash_attention.flash_attention(fq, fk, fv,
                                                              **fkw),
                      calls=5, reps=5)
    fl_plain_ms = time_cuda(lambda: flash_attention.flash_attention_plain(
        fq, fk, fv, **fkw), calls=2, reps=3)
    tq, tk, tv = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    fl_lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True, scale=spec.scale, enable_gqa=True),
        calls=5, reps=5)
    fl_bound, fl_by = flash_bounds(fq, fk, spec.sliding_window)
    emit({"phase": "contiguous_timings",
          "decode": {"kernel_us": dec_ms * 1e3, "bound_us": dec_bound * 1e3,
                     "plain_us": dec_plain_ms * 1e3,
                     "library_us": dec_lib_ms * 1e3,
                     "splits": decode_attention.contiguous_num_splits(
                         b, hkv, MISTRAL_SEQ, d),
                     "launches_per_step": spec.num_layers,
                     "max_abs_err": dec_err, "shape": {
                         "B": b, "Hq": hq, "Hkv": hkv, "D": d,
                         "S": MISTRAL_SEQ, "lens": pos}},
          "flash": {"kernel_us": fl_ms * 1e3, "bound_us": fl_bound * 1e3,
                    "plain_us": fl_plain_ms * 1e3,
                    "library_us": fl_lib_ms * 1e3,
                    "launches_per_prefill": spec.num_layers,
                    "max_abs_err": fl_err, "shape": {
                        "B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d}}})
    src = "neuronx_distributed_inference_tpu_torch/csrc/"
    jax_ops = "neuronx_distributed_inference_tpu/ops/"
    return [
        {"name": "decode_attention_stacked", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": jax_ops + "decode_attention.py:41",
         "launches": counts["decode_attention_stacked"],
         "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms,
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_lib_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": jax_ops + "flash_attention.py:28",
         "launches": counts["flash_attention"], "max_abs_err": fl_err,
         "ms": fl_ms, "plain_ms": fl_plain_ms, "bound_ms": fl_bound,
         "bound_by": fl_by, "library_ms": fl_lib_ms}]


# ---------------------------------------------------------------------------
# Phases 9-10: the ragged engine
# ---------------------------------------------------------------------------

def make_ragged_app(hf, device, dtype, cfg, *, batch=8,
                    output_logits=False):
    """The paged app of phases 9-10: seq_len ``cfg["seq_len"]``, block
    ``cfg["block"]`` and a pool of every row's blocks plus one spare per
    row."""
    per_row = cfg["seq_len"] // cfg["block"] + 1
    return make_app(hf, device, dtype, batch=batch, seq_len=cfg["seq_len"],
                    output_logits=output_logits, num_blocks=batch * per_row)


def ragged_engine(app, ragged, cfg):
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    return ServingEngine(PagedEngineAdapter(
        app, ragged=ragged, prefill_chunk_tokens=cfg["chunk"]))


def serve_schedule(eng, prompts, new_tokens, sync, profile=None,
                   snapshot=None):
    """Submit prompts 0-3 at pass 0, then one more every 4 passes, and run
    passes until the engine drains. ``profile(p, expect_mixed)`` returns
    True to run pass ``p`` under ``device_kernels``; ``snapshot()`` runs
    before each pass. Returns (streams, per-pass records, seconds from
    submit to first token per request). The profiler's own start-up and
    trace processing around a traced pass are taken off the clock that
    times to first token are read on."""
    ad = eng.adapter
    streams, t_sub, ttft, recs = [], [], {}, []
    excluded = 0.0                  # seconds of profiler overhead so far
    p = 0
    while len(streams) < len(prompts) or eng.has_work:
        due = 4 if p == 0 else (1 if p % 4 == 0 else 0)
        for _ in range(min(due, len(prompts) - len(streams))):
            t_sub.append(time.perf_counter() - excluded)
            streams.append(eng.submit(prompts[len(streams)], new_tokens))
        expect_mixed = bool(ad.pending_prefill_ids) or eng.queue.depth > 0
        if snapshot is not None:
            snapshot()
        before = dict(ad.host_stats)
        traced = profile is not None and profile(p, expect_mixed)
        t0 = time.perf_counter()
        per = None
        if traced:
            wall, per = device_kernels(eng.run_pass)
            end = time.perf_counter()
            # the pass took ``wall``; the rest of the call was profiler
            overhead = (end - t0) - wall / 1e3
            now = end - excluded - overhead
            excluded += overhead
        else:
            eng.run_pass()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            now = time.perf_counter() - excluded
        d = {k: ad.host_stats[k] - before.get(k, 0)
             for k in ad.host_stats if isinstance(ad.host_stats[k], int)}
        if d.get("ragged_dispatches", d["dispatches"]) == 0:
            kind = "idle"
        elif d.get("ragged_rows_prefill", d["prefill_dispatches"]) > 0:
            kind = "mixed"
        else:
            kind = "decode"
        recs.append({"pass": p, "kind": kind, "ms": wall, "traced": traced,
                     "device": per, "delta": d})
        for i, st in enumerate(streams):
            if i not in ttft and st.n_tokens:
                ttft[i] = now - t_sub[i]
        p += 1
        if p > 100 * len(prompts):
            raise AssertionError("the engine made no progress")
    return streams, recs, ttft


def check_streams(phase, streams, new_tokens, vocab):
    """Gate: every stream holds exactly ``new_tokens`` in-vocab tokens and
    finished on length."""
    for i, st in enumerate(streams):
        toks = st.tokens
        if (len(toks) != new_tokens or st.finish_reason != "length"
                or not all(0 <= t < vocab for t in toks)):
            raise AssertionError(
                f"{phase}: stream {i} has {len(toks)} tokens, finish "
                f"{st.finish_reason!r}")


def check_ragged_passes(phase, recs, launches, layers):
    """Gates (a) and (b): at most one ragged dispatch and one blocking
    fetch a pass, no standalone prefill dispatch, and the paged kernel
    launched ``layers`` times per all-decode ragged step."""
    for r in recs:
        d = r["delta"]
        if (d["ragged_dispatches"] > 1 or d["blocking_fetches"] > 1
                or d["prefill_dispatches"] != 0):
            raise AssertionError(f"{phase}: pass {r['pass']} made {d}")
    decode_steps = sum(1 for r in recs if r["kind"] == "decode")
    return decode_steps, layers * decode_steps


def pass_summary(recs, kind):
    ms = [r["ms"] for r in recs if r["kind"] == kind and not r["traced"]]
    return {"passes": sum(1 for r in recs if r["kind"] == kind),
            "timed": len(ms),
            "median_ms": statistics.median(ms) if ms else None,
            "mean_ms": statistics.fmean(ms) if ms else None,
            "min_ms": min(ms) if ms else None,
            "max_ms": max(ms) if ms else None}


def profile_summary(recs, kind):
    """Device ms by kernel per pass and the device idle share over the
    traced passes of one kind."""
    traced = [r for r in recs if r["traced"] and r["kind"] == kind]
    if not traced:
        return {"passes": 0}
    per, wall = {}, 0.0
    for r in traced:
        wall += r["ms"]
        for n, ms in r["device"].items():
            per[n] = per.get(n, 0.0) + ms
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    n = len(traced)
    return {"passes": n, "measured": busy > 0,
            "host_ms_per_pass": wall / n,
            "device_busy_ms_per_pass": busy / n,
            "device_idle_share": (1 - busy / wall) if busy > 0 else None,
            "top_kernels_ms_per_pass": [[k[:80], ms / n] for k, ms in top]}


def phase_ragged_serving(hf, device, cfg=RAGGED, new_tokens=RAGGED_TOKENS,
                         on_card=True):
    """Phase 9: the ragged engine at full width and depth, bf16."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    app = make_ragged_app(hf, device, "bfloat16", cfg)
    app.init_random_weights(0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    eng = ragged_engine(app, True, cfg)
    ad = eng.adapter
    snap = {}

    def snapshot():
        # the served cache's decode shapes, while all 8 rows are live
        if len(ad.seqs) == len(prompts) and not ad.pending_prefill_ids:
            live = sorted(ad.seqs)
            snap["table"] = app.kv_mgr.block_table_array(
                live, app._bt_width_for(live))
            snap["pos"] = [ad.seqs[s].position for s in live]
    traced = {"mixed": 0, "decode": 0}

    def profile(p, expect_mixed):
        kind, cap, start = (("mixed", 4, 8) if expect_mixed
                            else ("decode", 8, 24))
        if not on_card or p < start or traced[kind] >= cap:
            return False
        traced[kind] += 1
        return True
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_launches()
    streams, recs, ttft = serve_schedule(eng, prompts, new_tokens, sync,
                                         profile, snapshot)
    launches = decode_attention.paged_decode_attention.launches
    layers = hf["num_hidden_layers"]
    decode_steps, want = check_ragged_passes("ragged_serving", recs,
                                             launches, layers)
    want = want if on_card else 0
    st = ad.host_stats
    emit({"phase": "ragged_serving", "layers": layers,
          "requests": len(prompts), "prompt_lens": list(cfg["lens"]),
          "new_tokens": new_tokens, "passes": len(recs),
          "passes_by_kind": {k: sum(1 for r in recs if r["kind"] == k)
                             for k in ("mixed", "decode", "idle")},
          "ragged_steps": st["ragged_steps"],
          "launches": launches, "expected_launches": want,
          "host_ms_mixed": pass_summary(recs, "mixed"),
          "host_ms_decode": pass_summary(recs, "decode"),
          "pass_log": [[r["pass"], r["kind"], round(r["ms"], 3),
                        r["traced"]] for r in recs],
          "ttft_s": [ttft.get(i) for i in range(len(prompts))],
          "ragged_pad_waste": 1 - st["ragged_real_tokens"]
          / max(st["ragged_padded_tokens"], 1),
          "host_stats": st})
    emit({"phase": "ragged_profile_decode", **profile_summary(recs,
                                                              "decode")})
    emit({"phase": "ragged_profile_mixed", **profile_summary(recs,
                                                             "mixed")})
    if launches != want:
        raise AssertionError(f"ragged_serving: paged kernel launches "
                             f"{launches} != {layers} x {decode_steps} "
                             "all-decode ragged steps")
    check_streams("ragged_serving", streams, new_tokens, hf["vocab_size"])
    if not on_card:
        return []
    t = time_paged_kernel(app, snap["table"], snap["pos"], device, seed=9)
    emit({"phase": "ragged_kernel_timings", **t["report"],
          "launches": launches})
    return [paged_kernel_entry(t, launches, "ragged_serving")]


def phase_ragged_fp32(hf, device, cfg=RAGGED,
                      new_tokens=RAGGED_CHECK_TOKENS, on_card=True):
    """Phase 10: ragged vs two-phase engine vs ``generate``, fp32."""
    import numpy as np
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    app = make_ragged_app(hf, device, "float32", cfg)
    app.init_random_weights(0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, hf["vocab_size"], size=n).tolist()
               for n in cfg["lens"]]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_launches()
    streams, recs, _ = serve_schedule(ragged_engine(app, True, cfg),
                                      prompts, new_tokens, sync)
    launches = decode_attention.paged_decode_attention.launches
    layers = hf["num_hidden_layers"]
    decode_steps, want = check_ragged_passes("ragged_fp32", recs, launches,
                                             layers)
    want = want if on_card else 0
    check_streams("ragged_fp32", streams, new_tokens, hf["vocab_size"])
    ragged = [np.asarray(s.tokens) for s in streams]
    two = make_ragged_app(hf, device, "float32", cfg)
    two.params = app.params
    two_streams, _, _ = serve_schedule(ragged_engine(two, False, cfg),
                                       prompts, new_tokens, sync)
    check_streams("ragged_fp32_two_phase", two_streams, new_tokens,
                  hf["vocab_size"])
    del two
    ref = make_ragged_app(hf, device, "float32", cfg, batch=1,
                          output_logits=True)
    ref.params = app.params
    near_ties = []
    for i, prompt in enumerate(prompts):
        want_i = ref.generate(np.asarray([prompt]),
                              max_new_tokens=new_tokens, return_logits=True)
        ref.reset()
        cases = [near_tie_check(f"ragged_fp32_{name}_near_tie", i, got,
                                want_i, len(prompt))
                 for name, got in (("ragged", ragged[i]), (
                     "two_phase", np.asarray(two_streams[i].tokens)))]
        # ragged vs two-phase: equal up to where one of them leaves
        # generate at a near-tie
        diff = np.nonzero(ragged[i] != np.asarray(two_streams[i].tokens))[0]
        first = [c["first_diff_step"] for c in cases if c]
        if diff.size and (not first or int(diff[0]) < min(first)):
            raise AssertionError(f"ragged_fp32: stream {i} ragged and "
                                 f"two-phase differ at step {int(diff[0])}")
        near_ties += [c for c in cases if c]
    emit({"phase": "ragged_fp32", "layers": layers,
          "requests": len(prompts), "new_tokens": new_tokens,
          "passes": len(recs), "launches": launches,
          "expected_launches": want, "all_decode_ragged_steps": decode_steps,
          "streams_identical_to_generate": 2 * len(prompts) - len(near_ties),
          "near_ties": near_ties})
    if launches != want:
        raise AssertionError(f"ragged_fp32: paged kernel launches "
                             f"{launches} != {layers} x {decode_steps}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    gpu = nvidia_smi()
    build_s = build_kernels()
    emit({"phase": "env", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s})
    phase_kernels(device)
    app, ids, mask, launches = phase_main_path(LLAMA_3_2_1B, device)
    phase_serving(LLAMA_3_2_1B, device)
    kernels = phase_timings(LLAMA_3_2_1B, device, app, ids, mask, launches)
    del app
    torch.cuda.empty_cache()
    app, ids, mask, counts = phase_contiguous(MISTRAL_7B, device,
                                              "contiguous_main_path")
    kernels += phase_contiguous_timings(MISTRAL_7B, device, app, ids, mask,
                                        counts)
    del app
    torch.cuda.empty_cache()
    phase_contiguous(dict(MISTRAL_7B, num_hidden_layers=4,
                          sliding_window=512), device, "window_bites")
    torch.cuda.empty_cache()
    phase_contiguous_serving(dict(MISTRAL_7B, num_hidden_layers=8), device)
    torch.cuda.empty_cache()
    kernels += phase_ragged_serving(LLAMA_3_1_8B, device)
    torch.cuda.empty_cache()
    phase_ragged_fp32(dict(LLAMA_3_1_8B, num_hidden_layers=4), device)
    emit({"kernels": kernels})
    emit({"gpu": gpu})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
