"""Rank functions of the data- and context-parallel tests: each runs in a
process spawned by ``parallel.mesh.spawn_world`` and imports only torch
and the port (never jax or the JAX package), so the reference runs in the
test's own process. Every function takes the world's mesh first and
returns numpy results from the world's rank 0 (None elsewhere)."""

import contextlib

import numpy as np

from neuronx_distributed_inference_tpu_torch.config import MoEConfig
from neuronx_distributed_inference_tpu_torch.ops import (
    decode_attention, flash_attention)
from neuronx_distributed_inference_tpu_torch.parallel.mesh import (
    MeshConfig, build_mesh)

import torch_tp_ranks

# the three plain twins a kernel wrapper runs on the CPU
TWINS = ((flash_attention, "flash_attention_plain", "flash"),
         (decode_attention, "decode_attention_stacked_plain", "decode"),
         (decode_attention, "paged_decode_attention_plain", "paged"))


def mesh_for(mesh, tcfg):
    """The (dp, cp, ep, tp) mesh of a TpuConfig's degrees over the
    world's first ``tp_degree`` ranks, as ``mesh_from_config`` divides
    them (every rank calls it; the others get None)."""
    cp = tcfg.get("cp_degree", 1)
    dp = tcfg.get("attention_dp_degree", 1)
    ep = tcfg.get("ep_degree", 1)
    n = tcfg["tp_degree"]
    return build_mesh(MeshConfig(tp=n // (cp * dp * ep), cp=cp, dp=dp,
                                 ep=ep), mesh.device, ranks=range(n))


@contextlib.contextmanager
def twin_rows():
    """While open, every call of a kernel's plain twin is recorded as
    (twin, rows of its queries); yields the list."""
    calls = []
    saved = []
    for mod, name, tag in TWINS:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(q, *a, _fn=fn, _tag=tag, **kw):
            calls.append((_tag, int(q.shape[0])))
            return _fn(q, *a, **kw)
        setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _on(mesh, tcfg, build, drive):
    """Build an app over the sub-mesh of ``tcfg`` and run ``drive`` on its
    leader (the others follow). Returns (the leader's result, every rank's
    twin calls) on the world's rank 0's side: the leader's result, else
    None."""
    sub = mesh_for(mesh, tcfg)
    if sub is None:
        return None, None
    app = build(sub)
    with twin_rows() as calls:
        got = torch_tp_ranks._leader(sub, app, drive)
    return got, (sub.dp_rank, sub.cp_rank, sub.rank, list(calls))


def contiguous_at(mesh, ckpt, cases, prompts, n):
    """Contiguous ``generate`` (greedy, every step's logits) of each
    TpuConfig kwargs of ``cases`` (``tp_degree`` the ranks it takes).
    Returns {case index: (tokens, logits, every rank's twin calls)} from
    the world's rank 0; every other rank returns its own twin calls."""
    out, mine = {}, {}
    for i, tcfg in enumerate(cases):
        tcfg = dict(tcfg)
        moe = tcfg.pop("moe_tkg_ep_degree", None)
        if moe is not None:
            tcfg["moe_config"] = MoEConfig(moe_tkg_ep_degree=moe)
        model_type = tcfg.pop("model_type", "llama")

        def drive(a):
            r = a.generate(prompts, max_new_tokens=n, return_logits=True)
            return (np.asarray(r["generated"]),
                    [np.asarray(x) for x in r["logits"]])
        got, calls = _on(mesh, tcfg, lambda sub: torch_tp_ranks.build_app(
            ckpt, model_type, tcfg, sub), drive)
        if got is not None:
            out[i] = got
        if calls is not None:
            mine[i] = calls
    return (out, mine) if mesh.rank == 0 else (None, mine)


def adapter_scenario(app, prompts, make):
    """``torch_tp_ranks.adapter_scenario`` over the adapter ``make(app)``
    (a ragged adapter's step hands back each row's list of tokens).
    Returns {seq id: tokens}."""
    eng = make(app)
    toks = {sid: [] for sid in prompts}

    def collect(out):
        for sid, t in out.items():
            toks[sid] += [int(x) for x in np.atleast_1d(t)]

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


def prefix_streams(app, waves, n):
    """The ragged ``ServingEngine``: each wave of prompts submitted after
    the one before has drained (a later wave's rows reuse the earlier
    wave's prefix blocks). Returns (each request's stream, the prefix
    hits as (row, cached tokens) of every admission that hit)."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter
    from neuronx_distributed_inference_tpu_torch.serving.engine import \
        ServingEngine
    hits = []
    begin = app.kv_mgr.begin_sequence

    def spy(seq_id, *a, **kw):
        blocks, cached = begin(seq_id, *a, **kw)
        if cached:
            hits.append((int(seq_id), int(cached)))
        return blocks, cached
    app.kv_mgr.begin_sequence = spy
    eng = ServingEngine(PagedEngineAdapter(app, ragged=True,
                                           prefill_chunk_tokens=16))
    streams = []
    for wave in waves:
        streams += [eng.submit(p, n) for p in wave]
        while eng.has_work:
            eng.run_pass()
    return [list(s.drain()) for s in streams], hits


def serving_at(mesh, ckpt, tcfg, adapter_prompts, engine_tcfg,
               engine_prompts, n):
    """The reference's adapter scenario (:func:`adapter_scenario`) at
    ``tcfg`` in both of ``PagedEngineAdapter``'s
    modes, then the ragged ``ServingEngine`` at ``engine_tcfg`` over the
    waves of ``engine_prompts`` (:func:`prefix_streams`). Returns
    (two-phase streams, ragged-adapter streams, (engine streams, prefix
    hits), every rank's twin calls of the engine run) from rank 0."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        PagedEngineAdapter

    def ragged(app):
        return PagedEngineAdapter(app, ragged=True, prefill_chunk_tokens=8)
    res = []
    for cls in (PagedEngineAdapter, ragged):
        got, _ = _on(mesh, tcfg, lambda sub: torch_tp_ranks.build_app(
            ckpt, "llama", tcfg, sub, paged=True),
            lambda a, cls=cls: adapter_scenario(a, adapter_prompts, cls))
        res.append(got)
    got, calls = _on(mesh, engine_tcfg, lambda sub: torch_tp_ranks.build_app(
        ckpt, "llama", engine_tcfg, sub, paged=True),
        lambda a: prefix_streams(a, engine_prompts, n))
    res.append(got)
    return (tuple(res), calls) if mesh.rank == 0 else (None, calls)


def staggered(eng, p1, p2):
    """tests/test_torch_contiguous_app.py's continuous-batching scenario:
    rows 2 and 0 joining at different times, then only row 0 steps, then
    a fused ``step_many`` on row 2. At dp 2 over 4 cache rows the steps
    run on one replica, on both with a row each, and on the other."""
    got1 = [eng.add_requests([2], [p1])[2]]
    for _ in range(3):
        got1.append(eng.step()[2])
    got2 = [eng.add_requests([0], [p2])[0]]
    for _ in range(4):
        res = eng.step()
        got1.append(res[2])
        got2.append(res[0])
    for _ in range(3):
        got2.append(eng.step([0])[0])
    many = eng.step_many(3, [2])[2]
    eng.release([0, 2])
    return ([int(x) for x in got1], [int(x) for x in got2],
            [int(x) for x in np.atleast_1d(many)])


def continuous_at(mesh, ckpt, cases, p1, p2):
    """:func:`staggered` through the port's ``ContinuousBatchingAdapter``
    at each TpuConfig kwargs of ``cases``. Returns the list of streams
    from rank 0."""
    from neuronx_distributed_inference_tpu_torch.serving import \
        ContinuousBatchingAdapter
    out = []
    for tcfg in cases:
        got, _ = _on(mesh, tcfg, lambda sub: torch_tp_ranks.build_app(
            ckpt, "llama", tcfg, sub),
            lambda a: staggered(ContinuousBatchingAdapter(a), p1, p2))
        out.append(got)
    return out if mesh.rank == 0 else None


def world8_cases(mesh, cases, prompts, moe_prompts, n, cb_ckpt, cb_cases,
                 cb_prompts):
    """The world-8 scenarios: each (checkpoint, TpuConfig kwargs) of
    ``cases`` through :func:`contiguous_at` (Qwen3-MoE cases on
    ``moe_prompts``), then :func:`continuous_at`. Returns ({case: rank 0's
    result}, {case: this rank's twin calls}, the continuous-batching
    streams)."""
    outs, calls = {}, {}
    for i, (ckpt, tcfg) in enumerate(cases):
        p = moe_prompts if tcfg.get("model_type") == "qwen3_moe" else prompts
        out, mine = contiguous_at(mesh, ckpt, [tcfg], p, n)
        if out is not None and 0 in out:
            outs[i] = out[0]
        if 0 in mine:
            calls[i] = mine[0]
    cb = continuous_at(mesh, cb_ckpt, cb_cases, *cb_prompts)
    return outs, calls, cb


def world4_cases(mesh, ckpt, cases, adapter, waves, n):
    """The serving scenarios (:func:`serving_at`) of each (paged app
    TpuConfig kwargs, engine TpuConfig kwargs) of ``cases``. Returns the
    list of results from rank 0."""
    return [serving_at(mesh, ckpt, paged, adapter, engine, waves, n)[0]
            for paged, engine in cases]
