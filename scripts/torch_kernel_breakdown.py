#!/usr/bin/env python3
"""Where the contiguous decode kernel's device time goes, at the Mistral-7B
path's decode shapes (B 4, Hq 32, Hkv 8, D 128, S 4096, bf16, lens
100/363/963/1963, window 4096).

    python3 scripts/torch_kernel_breakdown.py [--splits 8,12,16]

Builds ``csrc/decode_attention.cu`` four times, each from a copy edited so
that its tensor-core kernel skips some of its work, and times each by
CUDA-graph replay (``chip_smoke.time_cuda``) at each split count:

  full       the kernel as it is (checked against the plain twin);
  no_tiles   every block's share has no tile (launch, prologue, the write
             of the split and the merge);
  no_merge   no block merges (launch, prologue, tiles, split write);
  neither    no tile and no merge (launch, prologue, split write).

Only ``full`` computes the function; the others exist to be subtracted.
Prints one JSON line per (variant, split count), then the card's name and
power limit. Needs a CUDA card and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_TILES = [("  const Share sh =\n      share_of<MK>",
             "  Share sh =\n      share_of<MK>"),
            ("  const Active<D, MAX_G> act =",
             "  sh.n_tiles = 0;\n  const Active<D, MAX_G> act =")]
NO_MERGE = [("  merge_tail<D, MAX_G>(act,",
             "  if (sh.n_part < 0) merge_tail<D, MAX_G>(act,")]
VARIANTS = {"full": [], "no_tiles": NO_TILES, "no_merge": NO_MERGE,
            "neither": NO_TILES + NO_MERGE}


def build(build_dir: str, name: str, edits) -> str:
    """csrc/ copied to build_dir/name with ``edits`` applied to
    decode_attention.cu (each must match exactly once), built by nvcc."""
    from neuronx_distributed_inference_tpu_torch import _build
    src = os.path.join(build_dir, name)
    shutil.copytree(_build.CSRC_DIR, src)
    path = os.path.join(src, "decode_attention.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit anchor not found once: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(build_dir, f"lib{name}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="8,12,16")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from neuronx_distributed_inference_tpu_torch import _build
    from neuronx_distributed_inference_tpu_torch.ops import \
        decode_attention as da
    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as ex:
            libs = dict(zip(VARIANTS, ex.map(
                lambda kv: build(tmp, *kv), VARIANTS.items())))
        g = torch.Generator(device=dev).manual_seed(3)
        x = cs.contiguous_inputs(g, dev, b=4, hq=32, hkv=8, d=128,
                                 s=cs.MISTRAL_SEQ,
                                 lens=[100, 363, 963, 1963],
                                 act_dtype=torch.bfloat16,
                                 cache_dtype=torch.bfloat16)
        kw = dict(scale=128 ** -0.5, window=4096)
        a, kw2 = cs.decode_args(x, kw)
        num_splits = da.contiguous_num_splits
        try:
            for name, lib in libs.items():
                _build._LOADED["decode_attention"] = ctypes.CDLL(lib)
                for n in [int(v) for v in args.splits.split(",") if v]:
                    da.contiguous_num_splits = lambda *_, n=n: n
                    err = cs.check_decode_against_twin(x, kw)
                    if name == "full" and not err <= cs.TOL_KERNEL_BF16:
                        raise AssertionError(f"full kernel: {err}")
                    us = cs.time_cuda(
                        lambda: da.decode_attention_stacked(*a, **kw2)) * 1e3
                    print(json.dumps({"variant": name, "splits": n,
                                      "us": us}), flush=True)
        finally:
            da.contiguous_num_splits = num_splits
            _build._LOADED.pop("decode_attention", None)
    print(json.dumps({"gpu": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
