"""Rank functions of the expert-parallel tests: each runs in a process
spawned by ``parallel.mesh.spawn_world`` and imports only torch and the
port (never jax or the JAX package), so the reference runs in the test's
own process. Every function takes the world's mesh first and returns
numpy results from the world's rank 0 (None elsewhere)."""

import numpy as np

from neuronx_distributed_inference_tpu_torch.config import MoEConfig
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    MeshConfig, build_mesh)

import torch_tp_ranks


def mesh_of(mesh, tp_degree, ep_degree):
    """The ep x (tp_degree / ep) mesh over the world's first tp_degree
    ranks (every rank calls it; the others get None)."""
    return build_mesh(MeshConfig(tp=tp_degree // ep_degree, ep=ep_degree),
                      mesh.device, ranks=range(tp_degree))


def run_cases(mesh, cases, n):
    """Each case (checkpoint, model type, TpuConfig kwargs with its
    ``tp_degree`` / ``ep_degree``, prompts, kind) over the first
    tp_degree ranks: kind "generate" gives (tokens, every step's logits)
    of a contiguous ``generate``, "engine" the ragged engine's (streams,
    passes); ``moe_tkg_ep_degree`` in the kwargs becomes the MoEConfig's.
    Returns the list of results from rank 0."""
    out = []
    for ckpt, model_type, tcfg, prompts, kind in cases:
        tcfg = dict(tcfg)
        tkg = tcfg.pop("moe_tkg_ep_degree", None)
        if tkg is not None:
            tcfg["moe_config"] = MoEConfig(moe_tkg_ep_degree=tkg)
        sub = mesh_of(mesh, tcfg["tp_degree"], tcfg.get("ep_degree", 1))
        if sub is None:
            continue
        app = torch_tp_ranks.build_app(ckpt, model_type, tcfg, sub,
                                       paged=kind == "engine")
        if kind == "engine":
            def drive(a, prompts=prompts):
                return torch_tp_ranks.engine_streams(a, prompts, n)
        else:
            def drive(a, prompts=prompts):
                r = a.generate(prompts, max_new_tokens=n,
                               return_logits=True)
                return (np.asarray(r["generated"]),
                        [np.asarray(x) for x in r["logits"]])
        got = torch_tp_ranks._leader(sub, app, drive)
        if mesh.rank == 0:
            out.append(got)
    return out if mesh.rank == 0 else None
