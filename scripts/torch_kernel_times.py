#!/usr/bin/env python3
"""Device times of the port's three CUDA kernels at the main paths' shapes,
for comparing two trees of the port on one card in one session.

    python3 scripts/torch_kernel_times.py [--repo DIR] [--label NAME]
                                          [--paged-splits 8,12,16,...]
                                          [--contig-splits 8,12,16,...]

``--repo`` names the checkout whose ``neuronx_distributed_inference_tpu_torch``
package is timed (default: this one); the timing helpers and input makers
come from this checkout's ``chip_smoke.py``. Each kernel is checked against
its plain twin, then timed by CUDA-graph replay (``chip_smoke.time_cuda``)
beside the same-run SDPA yardstick. Shapes (random inputs from fixed
seeds): paged decode B 4, Hq 32, Hkv 8, D 64, block 32, lens
100/363/963/1563, table width 64; contiguous decode B 4, Hq 32, Hkv 8, D
128, S 4096, lens 100/363/963/1963, window 4096; flash prefill B 4, S 2048,
Hq 32, Hkv 8, D 128, window 4096. ``--paged-splits`` also times the paged
kernel at each of the given split counts (the wrapper's ``num_splits``
overridden), ``--contig-splits`` the contiguous kernel (its
``contiguous_num_splits`` overridden). The contiguous SDPA yardstick runs
over D-contiguous copies of K and V (``chip_smoke.contiguous_sdpa_inputs``).
Prints one JSON line per kernel (and split count), then the card's name
and power limit. Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--paged-splits", default="",
                    help="comma-separated split counts to time the paged "
                         "kernel at")
    ap.add_argument("--contig-splits", default="",
                    help="comma-separated split counts to time the "
                         "contiguous decode kernel at")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs           # this checkout's helpers
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    import torch.nn.functional as F
    import neuronx_distributed_inference_tpu_torch as pkg
    from neuronx_distributed_inference_tpu_torch.ops import (
        decode_attention as da, flash_attention as fa)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    bf = torch.bfloat16

    def emit(name, ms, lib_ms, bound, err, **extra):
        print(json.dumps({"label": args.label, "repo": where, "kernel": name,
                          "us": ms * 1e3, "library_us": lib_ms * 1e3,
                          "bound_us": bound[0] * 1e3, "bound_by": bound[1],
                          "max_abs_err": err, **extra}), flush=True)

    def sweep(attr, counts, name, check, call, lib, bound):
        """``name``'s kernel timed at each of the comma-separated split
        ``counts`` (the wrapper's ``attr`` overridden)."""
        chosen = getattr(da, attr)
        try:
            for n in [int(v) for v in counts.split(",") if v]:
                setattr(da, attr, lambda *_, n=n: n)
                err = check()
                emit(name, cs.time_cuda(call), lib, bound, err, splits=n)
        finally:
            setattr(da, attr, chosen)

    g = torch.Generator(device=dev).manual_seed(2)
    x = cs.paged_inputs(g, dev, b=4, hq=32, hkv=8, d=64, bs=32, mb=64,
                        lens=[100, 363, 963, 1563], act_dtype=bf,
                        page_dtype=bf)
    kw = dict(scale=0.125)
    err = cs.check_kernel_against_twin(x, kw)
    a = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
         x["lens"], x["block_table"])
    ms = cs.time_cuda(lambda: da.paged_decode_attention(*a, **kw))
    q4, k4, v4, m4 = cs.sdpa_inputs(x, 0)
    lib = cs.time_cuda(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, scale=0.125, enable_gqa=True))
    emit("paged_decode_attention", ms, lib, cs.kernel_bounds(x), err,
         splits=da.num_splits(4, 8, 64, 32, 64))
    sweep("num_splits", args.paged_splits, "paged_decode_attention",
          lambda: cs.check_kernel_against_twin(x, kw),
          lambda: da.paged_decode_attention(*a, **kw), lib,
          cs.kernel_bounds(x))

    g = torch.Generator(device=dev).manual_seed(3)
    x = cs.contiguous_inputs(g, dev, b=4, hq=32, hkv=8, d=128,
                             s=cs.MISTRAL_SEQ, lens=[100, 363, 963, 1963],
                             act_dtype=bf, cache_dtype=bf)
    kw = dict(scale=128 ** -0.5, window=4096)
    err = cs.check_decode_against_twin(x, kw)
    a, kw2 = cs.decode_args(x, kw)
    ms = cs.time_cuda(lambda: da.decode_attention_stacked(*a, **kw2))
    q4, kk, vv, mask = cs.contiguous_sdpa_inputs(x, 0, kw["window"])
    lib = cs.time_cuda(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask, scale=kw["scale"], enable_gqa=True))
    emit("decode_attention_stacked", ms, lib, cs.decode_bounds(x), err,
         splits=da.contiguous_num_splits(4, 8, cs.MISTRAL_SEQ, 128))
    sweep("contiguous_num_splits", args.contig_splits,
          "decode_attention_stacked",
          lambda: cs.check_decode_against_twin(x, kw),
          lambda: da.decode_attention_stacked(*a, **kw2), lib,
          cs.decode_bounds(x))
    del kk, vv, x

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((4, 2048, h, 128), generator=g,
                           device=dev).to(bf) for h in (32, 8, 8))
    kw = dict(scale=128 ** -0.5, window=4096)
    err = cs.check_flash_against_twin(dict(q=q, k=k, v=v), kw)
    ms = cs.time_cuda(lambda: fa.flash_attention(q, k, v, **kw), calls=5,
                      reps=5)
    tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cs.time_cuda(lambda: F.scaled_dot_product_attention(
        tq, tk, tv, is_causal=True, scale=kw["scale"], enable_gqa=True),
        calls=5, reps=5)
    emit("flash_attention", ms, lib, cs.flash_bounds(q, k, kw["window"]),
         err)
    print(json.dumps({"gpu": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
