#!/usr/bin/env python3
"""Three measurements behind chip_smoke.py phase 15 (gpt-oss-20b) that
the phase itself does not take, for reading its numbers.

    python3 scripts/torch_oss_probes.py [--only splits,mha,divergence]

  * ``splits``: the paged decode kernel at gpt-oss-20b's heads (B 8, Hq 64
    over Hkv 8, D 64, block 32, phase 9's lens mid-run, bf16, a sink) at
    window 128 and 0, timed by CUDA-graph replay at forced split counts
    1-16 (the wrapper's ``num_splits`` overridden), each held to the twin;
  * ``mha``: ``ops.attention.mha`` at a mixed pass's shapes (8 rows x 512
    queries over 4096 keys, 64 q / 8 kv heads, D 64, bf16, a causal tail
    mask) with and without a sink, in turns, eager between CUDA events,
    and the peak memory each call adds;
  * ``divergence``: phase 15 (c) (bf16 kernel and gather apps against an
    fp32 app, teacher-forced) at cuts where the MoE routing cannot flip
    (one expert, top 1, 8 layers) and at 2 layers with and without the
    seeded sinks and biases, to tell what drives the bf16-fp32 spread.

Random inputs and weights from fixed seeds. Prints one JSON line per
measurement, then the card's name and power limit. Needs a CUDA card."""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = ("splits", "mha", "divergence")


def probe_splits(cs, device):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import \
        decode_attention as da
    cfg = cs.GPT_OSS_20B
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    gen = torch.Generator(device=device).manual_seed(15)
    sink = torch.randn((hq,), generator=gen, device=device)
    lens = [n + cs.RAGGED_TOKENS // 2 for n in cs.RAGGED["lens"]]
    x = cs.paged_inputs(gen, device, b=8, hq=hq, hkv=hkv, d=d, bs=32, mb=64,
                        lens=lens, act_dtype=torch.bfloat16,
                        page_dtype=torch.bfloat16)
    args = (x["q"], x["k_pages"], x["v_pages"], x["new_k"], x["new_v"], 0,
            x["lens"], x["block_table"])
    orig = da.num_splits
    try:
        for window in (cfg["sliding_window"], 0):
            kw = dict(scale=d ** -0.5, window=window, sink=sink)
            want = da.paged_decode_attention_plain(*args, **kw)
            for splits in (1, 2, 4, 8, 16):
                da.num_splits = lambda *a, _s=splits: _s
                err = float((da.paged_decode_attention(*args, **kw).float()
                             - want.float()).abs().max())
                if not err <= cs.TOL_KERNEL_BF16:
                    raise AssertionError(f"splits {splits}: err {err}")
                us = cs.time_cuda(
                    lambda: da.paged_decode_attention(*args, **kw)) * 1e3
                cs.emit({"probe": "splits", "window": window,
                         "splits": splits, "kernel_us": us,
                         "max_abs_err": err,
                         "default_splits": orig(8, hkv, 64, 32, d)})
    finally:
        da.num_splits = orig


def probe_mha(cs, device):
    import torch
    from neuronx_distributed_inference_tpu_torch.ops import attention as ta
    g = torch.Generator(device=device).manual_seed(0)
    b, t, s, hq, hkv, d = 8, 512, 4096, 64, 8, 64
    q = torch.randn((b, t, hq, d), generator=g, device=device).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=g, device=device).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=g, device=device).bfloat16()
    sink = torch.randn((hq,), generator=g, device=device)
    pos = torch.arange(s, device=device)
    mask = (pos[None, -t:, None] >= pos[None, None, :]).expand(
        b, t, s).contiguous()
    for name, kw in (("no_sink", {}), ("sink", dict(sink=sink)),
                     ("sink", dict(sink=sink)), ("no_sink", {})):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cs.time_events(lambda: ta.mha(q, k, v, mask, d ** -0.5, **kw),
                            calls=3, reps=3)
        cs.emit({"probe": "mha", "case": name, "ms_per_call": ms,
                 "peak_extra_gb": (torch.cuda.max_memory_allocated()
                                   - base) / 1e9,
                 "fp32_scores_gb": b * hq * t * s * 4 / 1e9})


def probe_divergence(cs, device):
    for name, layers, over, extras in (
            ("one_expert_top1", 8, dict(num_local_experts=1,
                                        num_experts_per_tok=1), True),
            ("routed", 2, {}, True), ("routed_no_sinks_biases", 2, {},
                                      False)):
        orig = cs.init_weights
        if not extras:
            cs.init_weights = lambda app, seed: app.init_random_weights(seed)
        cs.emit({"probe": "divergence", "variant": name, "layers": layers})
        try:
            cs.phase_oss_kernel_vs_gather(dict(cs.oss_cut(layers), **over),
                                          device)
        finally:
            cs.init_weights = orig
        cs.free_card()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PROBES))
    only = ap.parse_args().only.split(",")
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch_oss_probes: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cs.build_kernels()
    for name in PROBES:
        if name in only:
            globals()["probe_" + name](cs, device)
    cs.emit({"gpu": cs.nvidia_smi()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
