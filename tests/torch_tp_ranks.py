"""Rank functions of the tensor-parallel tests: each runs in a process
spawned by ``parallel.mesh.spawn_world`` and imports only torch and the
port (never jax or the JAX package), so the reference runs in the test's
own process. Every function takes the rank's mesh first and returns
numpy results from the ranks that have them (None elsewhere)."""

import contextlib
import pickle

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import (
    TpuConfig, load_pretrained_config)
from neuronx_distributed_inference_tpu_torch.models.application import (
    CausalLMApplication, PagedCausalLMApplication)
from neuronx_distributed_inference_tpu_torch.models.family import get_family
from neuronx_distributed_inference_tpu_torch.parallel import (
    collectives, dispatch)
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    MeshConfig, build_mesh)


def sub_mesh(mesh, tp):
    """A tp-``tp`` mesh over the first ``tp`` ranks of ``mesh``'s world
    (every rank calls it; the others get None)."""
    return build_mesh(MeshConfig(tp=tp), mesh.device, ranks=range(tp))


def build_app(ckpt, model_type, tcfg, mesh=None, paged=False):
    """A port app from the checkpoint ``ckpt`` (its weights loaded, its
    cache made) on the CPU, over ``mesh`` when given."""
    fam = get_family(model_type)
    icfg = fam.config_cls(TpuConfig(**tcfg),
                          load_config=load_pretrained_config(ckpt))
    cls = PagedCausalLMApplication if paged else CausalLMApplication
    app = cls(ckpt, icfg, fam, device="cpu", mesh=mesh)
    return app.load_weights().init_cache()


def _leader(mesh, app, drive):
    """The mesh's rank 0 runs ``drive(app)`` and stops the followers; the
    others follow. Returns rank 0's result (None elsewhere)."""
    if mesh.leads:
        try:
            return drive(app)
        finally:
            app.stop_followers()
    app.follow()
    return None


def generate_at(mesh, ckpt, model_type, tcfg, prompts, n, tps):
    """Contiguous ``generate`` (greedy, with every step's logits) at each
    tp of ``tps`` over the first tp ranks. Returns {tp: (tokens, logits,
    dispatch records)} from the world's rank 0."""
    out = {}
    for tp in tps:
        sub = sub_mesh(mesh, tp)
        if sub is None:
            continue
        app = build_app(ckpt, model_type, dict(tcfg, tp_degree=tp), sub)

        def drive(a):
            r = a.generate(prompts, max_new_tokens=n, return_logits=True)
            return (r["generated"], [np.asarray(x) for x in r["logits"]],
                    a.dispatch_stats["records"])
        got = _leader(sub, app, drive)
        if sub.rank == 0:
            out[tp] = got
    return out if mesh.rank == 0 else None


def adapter_scenario(app, prompts, adapter_cls=None):
    """The continuous-batching scenario of the reference's
    tests/test_serving_mesh.py:40-78: two ragged prompts, three steps,
    release row 0, admit a third request into the freed slot, two more
    steps. Returns {seq id: tokens}. ``adapter_cls``: the port's
    ``PagedEngineAdapter`` by default (the test passes the JAX one)."""
    if adapter_cls is None:
        from neuronx_distributed_inference_tpu_torch.serving import \
            PagedEngineAdapter as adapter_cls
    eng = adapter_cls(app)
    toks = {sid: [] for sid in prompts}

    def collect(out):
        for sid, t in out.items():
            toks[sid].append(int(t))

    collect(eng.add_requests([0, 1], [prompts[0], prompts[1]]))
    for _ in range(3):
        collect(eng.step())
    eng.release([0])
    collect(eng.add_requests([2], [prompts[2]]))
    for _ in range(2):
        collect(eng.step())
    eng.release([1, 2])
    assert not app.kv_mgr.tables
    return toks


def engine_streams(app, prompts, n):
    """``ServingEngine.run_pass`` on the ragged engine until drained:
    each request's stream, in submission order."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    eng = ServingEngine(PagedEngineAdapter(app, ragged=True,
                                           prefill_chunk_tokens=16))
    streams = [eng.submit(p, n) for p in prompts]
    passes = 0
    while eng.has_work:
        eng.run_pass()
        passes += 1
    return [list(s.drain()) for s in streams], passes


def serving_at(mesh, ckpt, adapter_tcfg, adapter_prompts, engine_tcfg,
               engine_prompts, n):
    """The adapter scenario over the whole world, then the ragged engine
    over its first two ranks. Returns (adapter streams, (engine streams,
    passes)) from rank 0."""
    app = build_app(ckpt, "llama", dict(adapter_tcfg, tp_degree=mesh.tp),
                    mesh, paged=True)
    streams = _leader(mesh, app,
                      lambda a: adapter_scenario(a, adapter_prompts))
    sub = sub_mesh(mesh, 2)
    if sub is None:
        return None
    app = build_app(ckpt, "llama", dict(engine_tcfg, tp_degree=2), sub,
                    paged=True)
    engine = _leader(sub, app,
                     lambda a: engine_streams(a, engine_prompts, n))
    return (streams, engine) if mesh.rank == 0 else None


def rings_at(mesh, xs, cases):
    """The quantized ring of each (op, dtype, g) of ``cases`` on rank r's
    ``xs[case][r]`` over the first g ranks. Returns {case: rank results}
    from every rank of the case's group."""
    out = {}
    for op, dtype, g in cases:
        sub = sub_mesh(mesh, g)
        if sub is None:
            continue
        fn = (collectives.quantized_all_reduce if op == "all_reduce"
              else collectives.quantized_reduce_scatter)
        x = torch.from_numpy(xs[(op, dtype, g)][sub.rank])
        out[(op, dtype, g)] = fn(x, sub, dtype=dtype).numpy()
    return out


def plain_at(mesh, xs):
    """The plain all-reduce and all-gather of rank r's ``xs[r]``."""
    x = torch.from_numpy(xs[mesh.rank])
    return (collectives.all_reduce(x.clone(), mesh).numpy(),
            collectives.all_gather(x, mesh).numpy())


@contextlib.contextmanager
def equal_ring_copies():
    """While open, the port's quantized ring all-reduce hands every rank
    the same copy of the sum: the owner's chunk is dequantized from the
    codes it sends (the others receive exactly those), where the ring
    keeps it at full precision. The test's counterpart patches the JAX
    ring alike, so that no package's layout can consume unequal copies."""
    ring = collectives.quantized_all_reduce

    def equal(x, mesh, *, dtype="int8", block=collectives.DEFAULT_BLOCK):
        g, r = mesh.mp, mesh.rank
        blk = collectives._resolve_block(x.shape[-1] // g, block)
        cur = collectives._ring_reduce_scatter(x, mesh, dtype, blk)
        q, scale = collectives._quantize_wire(cur, dtype, blk)
        out = [None] * g
        out[r] = collectives._dequantize_wire(q, scale, blk, x.dtype)
        for step in range(g - 1):
            q, scale = collectives._ring_pass([q, scale], mesh)
            out[(r - step - 1) % g] = collectives._dequantize_wire(
                q, scale, blk, x.dtype)
        return torch.cat(out, dim=-1)
    collectives.quantized_all_reduce = equal
    try:
        yield
    finally:
        collectives.quantized_all_reduce = ring


def generate_cases(mesh, cases, n):
    """Contiguous ``generate`` of each (checkpoint, model type, TpuConfig
    kwargs, prompts[, equal ring copies]) over the whole world. Returns
    [(tokens, logits)] from rank 0."""
    out = []
    for ckpt, model_type, tcfg, prompts, *equal in cases:
        app = build_app(ckpt, model_type, dict(tcfg, tp_degree=mesh.tp),
                        mesh)

        def drive(a, prompts=prompts):
            r = a.generate(prompts, max_new_tokens=n, return_logits=True)
            return r["generated"], [np.asarray(x) for x in r["logits"]]
        with (equal_ring_copies() if equal and equal[0]
              else contextlib.nullcontext()):
            out.append(_leader(mesh, app, drive))
    return out if mesh.rank == 0 else None


def records_at(mesh, records):
    """Rank 0 sends each (name, args, kw) of ``records`` through a
    ``parallel.dispatch.Channel`` and then the stop; the others receive
    until the stop. Returns rank 0's counts of schemas sent and of
    broadcasts made, and each other rank's records as received (pickled
    here: the queue back to the parent would share a tensor's memory
    with a rank that has exited)."""
    ch = dispatch.Channel(mesh)
    if mesh.rank == 0:
        for name, args, kw in records:
            ch.send(name, args, kw)
        ch.stop()
        return ch.schemas, ch.broadcasts
    got = []
    rec = ch.recv()
    while rec is not None:
        got.append(rec)
        rec = ch.recv()
    return pickle.dumps(got)


def fail_at(mesh):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    collectives.all_reduce(torch.ones(1), mesh)


def linger_at(mesh, seconds):
    """Every rank hands back its rank, then keeps its process alive for
    ``seconds`` (a thread the interpreter waits for at exit)."""
    import threading
    import time
    threading.Thread(target=time.sleep, args=(seconds,)).start()
    return mesh.rank


def hang_at(mesh, seconds):
    """Rank 1 sleeps past the world's time limit."""
    import time
    if mesh.rank == 1:
        time.sleep(seconds)
    return mesh.rank
