"""Tensor, expert, attention-data and context parallelism over NCCL
across cards, one spawned rank a card: Qwen2.5-72B's widths
(``chip_smoke.QWEN25_72B``) cut to ``--layers`` layers, or with ``--ep
N`` Qwen3-235B-A22B's (``chip_smoke.QWEN3_235B_A22B``, experts cut over
ep N and their intermediate over the tp axis), served at each tp_degree
of ``--tp`` (the world's size; ``--dp`` and ``--cp`` group it as
``attention_dp_degree`` and ``cp_degree`` do: each dp replica runs its
rows of a step, every replica writes every row's K/V into its pages) by
phase 9's ragged engine and mix, the T = 1 steps
replayed from CUDA graphs that hold their NCCL collectives. Each world's
streams are held to the same weights at tp 1 on card 0 by
``chip_smoke``'s teacher-deficit gate with its shifted control (as
phases 28 (b) and 29 (a) hold their gloo ranks).

Prints one JSON line a measurement, each world's as soon as it returns:
each tp's rank 0 dispatch records
(count, schemas, host us each), all-decode and mixed host ms, TTFT, the
collectives each rank captured, each rank's weight bytes and paged
launches, and the paged kernel's time at a rank's heads (rank 0, the
other ranks idle between two barriers) against its bound and SDPA; then
the card's name and power limit.

    python3 scripts/torch_tp_nccl.py --tp 2,4          # on 4 cards
    python3 scripts/torch_tp_nccl.py --tp 4 --ep 2     # ep 2 x tp 2
    python3 scripts/torch_tp_nccl.py --tp 4 --dp 2     # dp 2 x tp 2
    python3 scripts/torch_tp_nccl.py --device cpu --tiny --tp 2,4 \
        [--ep 2] [--dp 2] [--cp 2]
                                                       # CPU rehearsal

The CPU rehearsal runs gloo ranks at tiny widths (no graphs, no kernel).
Exits 1 when a gate fails, 2 without enough cards.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = dict(cs.QWEN25_72B, hidden_size=256, num_attention_heads=8,
            num_key_value_heads=4, intermediate_size=512, vocab_size=1024,
            num_hidden_layers=2)
TINY_MOE = dict(cs.QWEN3_235B_A22B, hidden_size=256, num_attention_heads=8,
                num_key_value_heads=4, head_dim=32, moe_intermediate_size=64,
                num_experts=8, num_experts_per_tok=2, vocab_size=1024,
                num_hidden_layers=2)
TINY_CFG = dict(cs.RAGGED, lens=(37, 100, 60, 150), seq_len=256, chunk=64,
                block=32)
WORLD_TIMEOUT_S = 300         # a world of the 8-layer cut: ~1 min


def rank_serve(mesh, hf, cfg, prompts, new_tokens, ep=1, dp=1, cp=1):
    """One rank: the ragged app over the world's mesh cut into dp x cp x
    ep x (world / (dp·cp·ep)) (graphs on the card), the weights drawn
    whole and cut to the rank's slice; the mesh's rank 0 warms and serves
    phase 9's mix and times the paged kernel, the others follow. Returns
    the rank's numbers (rank 0's with the streams)."""
    import torch
    import torch.distributed as dist
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh)
    if ep * dp * cp > 1:
        mesh = build_mesh(MeshConfig(tp=mesh.tp // (ep * dp * cp), ep=ep,
                                     dp=dp, cp=cp), mesh.device,
                          ranks=range(mesh.tp))
    dev = mesh.device
    on_card = dev.type == "cuda"
    app = cs.make_ragged_app(hf, dev, "bfloat16", cfg, mesh=mesh,
                             graphs=on_card)
    cs.init_weights(app, 0)
    out = {"rank": mesh.index, "weight_bytes": cs.param_bytes(app.params),
           "heads": [app.spec.gqa.num_q_heads, app.spec.gqa.num_kv_heads]}
    with cs.CollectiveSpy() as spy:
        # the warm-up ends the followers' first loop, so every rank counts
        # the served launches only
        if mesh.leads:
            cs.warm(app, f"tp{mesh.size}_nccl", chunk_tokens=cfg["chunk"])
            app.stop_followers()
            snap = {}
            with cs.PagedArgsSpy() as pspy:
                streams, recs, ttft, launches, steps = cs.tp_serve(
                    app, prompts, cfg, new_tokens, f"tp{mesh.size}_nccl",
                    cs._sync(dev), snap=snap)
            app.stop_followers()
        else:
            app.follow()
            cs.reset_launches([app])
            app.follow()
            launches = cs.kernel_counts([app])["paged_decode_attention"]
    out.update(launches=launches, captured=spy.captured, eager=spy.eager)
    if on_card:
        torch.cuda.synchronize(dev)
    dist.barrier(group=mesh.world_group)
    if mesh.leads:
        out.update(streams=streams, steps=steps, groups=sorted(pspy.groups),
                   host_ms_decode=cs.pass_summary(recs, "decode"),
                   host_ms_mixed=cs.pass_summary(recs, "mixed"),
                   ttft_s=[ttft.get(i) for i in range(len(prompts))],
                   dispatch=dict(app.dispatch_stats,
                                 schemas=app._channel.schemas,
                                 broadcasts=app._channel.broadcasts))
        if on_card:
            out["kernel"] = cs.time_paged_kernel(app, snap["table"],
                                                 snap["pos"], dev, seed=9)
    dist.barrier(group=mesh.world_group)
    return out


def gate(phase, tp, ranks, teacher, prompts, layers, a_bytes, on_card):
    """Emit one world's numbers and hold them to the gates: launches =
    layers x the all-decode steps on every rank, each rank's steps holding
    the embedding's sum, two sums a layer and the logits' gather (captured
    on the card), the streams within the teacher-deficit bound with the
    control beyond it. Returns [phase] when a gate fails, else []."""
    lead = ranks[0]
    d = lead["dispatch"]
    want_launches = layers * lead["steps"] if on_card else 0
    cs.emit({"phase": phase, "backend": "nccl" if on_card else "gloo",
             "tp": tp, "layers": layers, "weight_gb_tp1": a_bytes / 1e9,
             "weight_gb_ranks": [r["weight_bytes"] / 1e9 for r in ranks],
             "heads_ranks": [r["heads"] for r in ranks],
             "launches_ranks": [r["launches"] for r in ranks],
             "expected_launches": want_launches, "groups": lead["groups"],
             "collectives_captured_ranks": [r["captured"] for r in ranks],
             "collectives_eager_ranks": [r["eager"] for r in ranks],
             "host_ms_decode": lead["host_ms_decode"],
             "host_ms_mixed": lead["host_ms_mixed"],
             "ttft_s": lead["ttft_s"], "dispatch_records": d["records"],
             "dispatch_schemas": d["schemas"],
             "dispatch_broadcasts": d["broadcasts"],
             "dispatch_broadcast_us_each":
                 1e6 * d["broadcast_s"] / max(d["records"], 1)})
    try:
        for r in ranks:
            if r["launches"] != want_launches:
                raise AssertionError(f"{phase}: rank {r['rank']} launched "
                                     f"{r['launches']}, want "
                                     f"{want_launches}")
            made = r["captured"] if on_card else r["eager"]
            if not (made["all_reduce"] >= 1 + 2 * layers
                    and made["all_gather"] >= 1):
                raise AssertionError(f"{phase}: rank {r['rank']} "
                                     f"collectives {made}")
        cs.deficit_gate(phase, cs.teacher_deficits(
            teacher, prompts, lead["streams"]), exact=False)
        if on_card:
            t = lead["kernel"]
            cs.emit({"phase": phase + "_kernel_timings", **t["report"],
                     "launches": lead["launches"]})
            cs.emit({"phase": phase + "_kernel_entry",
                     **cs.paged_kernel_entry(t, lead["launches"], phase)})
    except AssertionError as e:
        cs.emit({"phase": phase + "_failed", "error": str(e)})
        return [phase]
    return []


def main(argv=None) -> int:
    import torch
    from neuronx_distributed_inference_tpu_torch.parallel.mesh import \
        spawn_world
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tp", default="2,4")
    p.add_argument("--ep", type=int, default=1,
                   help="expert parallelism: Qwen3-235B-A22B's widths, "
                        "experts over ep, each world ep x (tp / ep)")
    p.add_argument("--dp", type=int, default=1,
                   help="attention data parallelism: each world dp x "
                        "(tp / dp), a step's rows over the dp replicas")
    p.add_argument("--cp", type=int, default=1,
                   help="context parallelism: each world cp x (tp / cp) "
                        "(the paged steps run whole on every cp rank)")
    p.add_argument("--layers", type=int, default=None,
                   help="depth cut (default: phase 28's, or phase 29's "
                        "with --ep)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true",
                   help="tiny widths (a CPU rehearsal)")
    args = p.parse_args(argv)
    tps = [int(t) for t in args.tp.split(",")]
    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < max(tps)):
        print(f"torch_tp_nccl: needs {max(tps)} cards", file=sys.stderr)
        return 2
    moe = args.ep > 1
    layers = args.layers or (cs.EP_SERVE_LAYERS if moe
                             else cs.TP_SERVE_LAYERS)
    if moe:
        hf = dict(TINY_MOE if args.tiny else cs.QWEN3_235B_A22B,
                  num_hidden_layers=layers)
    else:
        hf = dict(TINY if args.tiny else cs.QWEN25_72B,
                  num_hidden_layers=layers)
    cfg = TINY_CFG if args.tiny else cs.RAGGED
    new_tokens = 6 if args.tiny else cs.RAGGED_TOKENS
    if on_card:
        cs.emit({"phase": "env", "build_s": cs.build_kernels(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "cards": torch.cuda.device_count()})
    prompts = cs.tp_prompts(hf, cfg)
    tmpdir = tempfile.mkdtemp(prefix="nxdi-tp-nccl-")
    # tp 1 on card 0: the weights every world's streams are held to
    device = torch.device("cuda:0" if on_card else "cpu")
    ref = cs.make_ragged_app(hf, device, "bfloat16", cfg, graphs=False)
    # the vocabulary padded as the worlds pad it: the same draw as their
    # ranks' (every world here must pad alike)
    from neuronx_distributed_inference_tpu_torch.models.model_base import \
        pad_vocab
    mp = [tp // (args.ep * args.dp * args.cp) * args.ep for tp in tps]
    pads = {pad_vocab(hf["vocab_size"], m) for m in mp}
    if len(pads) != 1:
        print(f"torch_tp_nccl: the worlds pad the vocabulary to {pads}",
              file=sys.stderr)
        return 2
    cs.init_weights(cs.pad_vocab_to(ref, max(mp)), 0)
    a_bytes = cs.param_bytes(ref.params)
    teacher = cs.make_contiguous_app(hf, device, "bfloat16", batch=8,
                                     seq_len=cfg["seq_len"],
                                     output_logits=True, graphs=on_card)
    cs.pad_vocab_to(teacher, max(mp))
    teacher.params = ref.params
    failed = []
    for tp in tps:
        phase = (f"tp{tp}" + "".join(f"_{a}{n}" for a, n in (
            ("ep", args.ep), ("dp", args.dp), ("cp", args.cp)) if n > 1)
            + "_nccl")
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(rank_serve, tp,
                                "nccl" if on_card else "gloo", args.device,
                                tmpdir, WORLD_TIMEOUT_S,
                                (hf, cfg, prompts, new_tokens, args.ep,
                                 args.dp, args.cp))
        except RuntimeError as e:
            cs.emit({"phase": phase + "_failed", "error": str(e)[-4000:]})
            failed.append(phase)
            continue
        cs.emit({"phase": phase + "_world_seconds",
                 "seconds": time.perf_counter() - t0})
        failed += gate(phase, tp, ranks, teacher, prompts, layers, a_bytes,
                       on_card)
    if on_card:
        print(cs.nvidia_smi())
    print(json.dumps({"ok": not failed, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
