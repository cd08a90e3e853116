"""The tensor-parallel mesh as ``torch.distributed`` process groups
(counterpart: ``neuronx_distributed_inference_tpu/parallel/mesh.py`` —
``MeshConfig`` :58, ``Topology`` :73, ``topology_from_env`` :99,
``initialize_distributed`` :112, ``build_mesh`` :131,
``mesh_from_config`` :152).

The JAX package is a single controller: one process owns every device of
a ``jax.sharding.Mesh`` and XLA inserts the collectives. The port runs one
process per card (SPMD): each rank holds its slice of every sharded
weight and cache, runs the same step on it, and the model code calls the
collectives of :mod:`.collectives` where GSPMD inserted them. A
:class:`Mesh` is what a rank knows of that world: its rank, the world, the
tensor-parallel group, the group's backend and the rank's device.

The port runs the counterpart's four axes ``(dp, cp, ep, tp)`` in its
order: rank ``r`` of a world of ``dp·cp·ep·tp`` ranks is
``r = ((dp_rank·cp + cp_rank)·ep + ep_rank)·tp + tp_rank``, the JAX
package's device ``r`` of the same mesh (``jax.devices()`` reshaped
``(dp, cp, ep, tp)``). Attention, dense MLPs, the vocabulary and shared
experts are cut over the combined model-parallel axis (``AXIS_MP``, the
``mp = ep·tp`` ranks of one (dp, cp) replica, index ``ep_rank·tp +
tp_rank``: :attr:`Mesh.rank`); routed experts over ``ep`` (the expert
axis) and ``tp`` (their intermediate axis). Every weight is replicated
over ``dp`` and ``cp``. One process group spans each replica's mp ranks:
the MoE block's partial sums are reduced over all of it, as GSPMD's psum
over ``("ep", "tp")`` is. A dp group joins the ranks of one mp index and
one cp index across the replicas (the gathers of a step's rows), a cp
group those of one mp index and one dp index (the sequence gathers of
context-parallel prefill and the flash-decoding merge); the world group
carries rank 0's dispatch records.

A rank's device is ``cuda:{local_rank}`` unless the caller names another;
the backend is NCCL unless the caller names gloo. Nothing here picks the
CPU or gloo on its own: the tests ask for both, and so does the card's
two-process check, which runs two ranks on one card over gloo.

Launching: under ``torchrun`` each process calls
:func:`initialize_distributed` (it reads ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and torchrun's rendezvous) and then
:func:`mesh_from_config`; :func:`spawn_world` starts a world of processes
from one parent over a ``FileStore`` (the tests and ``chip_smoke.py``),
with time limits on the init and the join, so a rank that hangs fails its
caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..resilience.errors import ConfigurationError

AXIS_DP = "dp"
AXIS_CP = "cp"
AXIS_TP = "tp"
AXIS_EP = "ep"
MESH_AXES = (AXIS_DP, AXIS_CP, AXIS_EP, AXIS_TP)
# the combined model-parallel axis: heads, dense MLP columns, vocabulary
AXIS_MP = "mp"
# a hybrid decode copy's cut: the intermediate axis over (tp, ep),
# tp-major (the counterpart's moe.py:326-333)
AXIS_TP_EP = "tp_ep"

A13D = "ROADMAP A13d"


@dataclass(frozen=True)
class MeshConfig:
    tp: int = 1
    cp: int = 1
    dp: int = 1
    ep: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.cp * self.ep * self.tp


@dataclass(frozen=True)
class Topology:
    """Which mesh axes cross the data-center network (the observatory
    prices their traffic at ``dcn_gbps`` instead of ``ici_gbps``)."""

    dcn_axes: Tuple[str, ...] = ()

    def is_dcn(self, comm_axes) -> bool:
        return any(a in self.dcn_axes for a in comm_axes)


DP_OVER_DCN = Topology(dcn_axes=(AXIS_DP,))


def topology_from_env() -> Topology:
    """``NXDI_TPU_DCN_AXES`` (comma separated axis names; default "dp")."""
    raw = os.environ.get("NXDI_TPU_DCN_AXES", AXIS_DP)
    axes = tuple(a for a in (s.strip() for s in raw.split(",")) if a)
    bad = [a for a in axes if a not in MESH_AXES]
    if bad:
        raise ValueError(f"NXDI_TPU_DCN_AXES names unknown mesh axes {bad}; "
                         f"expected a subset of {MESH_AXES}")
    return Topology(dcn_axes=axes)


class Mesh:
    """One rank's view of the world.

    ``group`` is the process group of its replica's ``mp = ep·tp`` ranks
    (``None`` = the default group), ``rank`` this process's index in it
    (the index every weight cut reads), ``tp`` and ``ep`` the two axes'
    extents, ``backend`` "nccl" or "gloo", ``device`` the rank's device.
    ``dp`` / ``cp`` are the data- and context-parallel extents and
    ``dp_rank`` / ``cp_rank`` this rank's replica on each;
    ``dp_group`` / ``cp_group`` the groups across them (None where the
    axis is 1: nothing runs over it) and ``world_group`` the group of
    every rank of the mesh (None = the default group). ``src`` is the global rank of the mesh's
    rank 0, the host that plans every dispatch; ``index`` this rank's
    place in the mesh, ``((dp_rank·cp + cp_rank)·mp + rank)``."""

    def __init__(self, group, backend: str, device: torch.device,
                 rank: int, tp: int, src: int = 0, ep: int = 1,
                 dp: int = 1, cp: int = 1, dp_rank: int = 0,
                 cp_rank: int = 0, world_group=None, dp_group=None,
                 cp_group=None):
        self.group = group
        self.backend = backend
        self.device = torch.device(device)
        self.rank = rank
        self.tp = tp
        self.ep = ep
        self.dp = dp
        self.cp = cp
        self.dp_rank = dp_rank
        self.cp_rank = cp_rank
        self.src = src
        self.world_group = world_group
        self.dp_group = dp_group
        self.cp_group = cp_group

    @property
    def mp(self) -> int:
        """Ranks of the model-parallel group: heads, dense MLP columns and
        the vocabulary are cut over all of them."""
        return self.tp * self.ep

    @property
    def size(self) -> int:
        """Every rank of the mesh: dp·cp·ep·tp."""
        return self.dp * self.cp * self.mp

    @property
    def index(self) -> int:
        return (self.dp_rank * self.cp + self.cp_rank) * self.mp + self.rank

    @property
    def leads(self) -> bool:
        """True on the mesh's rank 0: the one that plans every step, owns
        the host allocator and prints (not the rank 0 of a replica's mp
        group)."""
        return self.index == 0

    @property
    def ep_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def cut(self, axis_name: str) -> Tuple[int, int]:
        """(degree, index) of this rank along a mesh axis: ``"mp"`` (the
        rank), ``"ep"``, ``"tp"``, ``"tp_ep"`` (the hybrid decode
        copy's index ``tp_rank·ep + ep_rank`` of ``mp``)."""
        if axis_name == AXIS_MP:
            return self.mp, self.rank
        if axis_name == AXIS_EP:
            return self.ep, self.ep_rank
        if axis_name == AXIS_TP:
            return self.tp, self.tp_rank
        if axis_name == AXIS_TP_EP:
            return self.mp, self.tp_rank * self.ep + self.ep_rank
        raise ValueError(f"unknown mesh axis {axis_name!r}")

    def axis_group(self, axis_name: str):
        """The process group of ``"mp"``, ``"dp"``, ``"cp"`` or
        ``"world"``."""
        return {AXIS_MP: self.group, AXIS_DP: self.dp_group,
                AXIS_CP: self.cp_group, "world": self.world_group}[axis_name]

    @property
    def host_route(self) -> bool:
        """True when a collective gloo cannot run on the device's tensors
        (all-gather, send and receive of CUDA tensors) moves them through
        the host: a gloo group over CUDA tensors, which the caller chose.
        An NCCL group never takes it."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def warm(self) -> None:
        """One collective on the device over each group of the rank, so
        every NCCL communicator exists before any CUDA graph captures the
        model's collectives."""
        for g, n in ((self.group, self.mp), (self.dp_group, self.dp),
                     (self.cp_group, self.cp)):
            if n > 1 or g is self.group:
                dist.all_reduce(torch.ones((1,), device=self.device),
                                group=g)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, cp={self.cp}, ep={self.ep}, "
                f"tp={self.tp}, dp_rank={self.dp_rank}, "
                f"cp_rank={self.cp_rank}, rank={self.rank}, "
                f"index={self.index}, backend={self.backend!r}, "
                f"device={self.device})")


def refuse_over_mesh(app, what: str) -> None:
    """Raise :class:`ConfigurationError` naming ROADMAP A13d when ``app``
    runs over a mesh of more than one rank (what the port does not serve
    at tp > 1 yet)."""
    m = getattr(app, "mesh", None)
    if m is not None and m.size > 1:
        raise ConfigurationError(f"{what} at tp > 1 waits for {A13D}")


def initialize_distributed(backend: str = "nccl", store=None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout_s: float = 600.0) -> Tuple[int, int, int]:
    """Join the process group once (a no-op when this process already
    has): torchrun's env (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) or the given ``store`` / ``rank`` /
    ``world_size``. Returns (rank, world size, local rank)."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    kw = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kw["store"] = store
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return rank, world_size, local


def rank_coords(cfg: MeshConfig, index: int) -> Tuple[int, int, int, int]:
    """(dp_rank, cp_rank, ep_rank, tp_rank) of mesh index ``index``: the
    position of the JAX package's device ``index`` in ``jax.devices()``
    reshaped ``(dp, cp, ep, tp)`` (mesh.py:144)."""
    coords = np.unravel_index(index, (cfg.dp, cfg.cp, cfg.ep, cfg.tp))
    return tuple(int(c) for c in coords)


def build_mesh(cfg: MeshConfig, device=None,
               ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The (dp, cp, ep, tp) mesh over the joined process group: ``ranks``
    (default 0 .. dp·cp·ep·tp - 1; a world larger than that leaves the
    rest out of it), ``ranks[i]`` the mesh's index ``i = ((dp_rank·cp +
    cp_rank)·ep + ep_rank)·tp + tp_rank``. Every process of the world must
    call it (a new group is a collective call, and every rank makes each
    in the same order: the mesh's group, then each replica's mp group,
    each dp group and each cp group); those outside ``ranks`` get None.
    ``device``: the rank's device (default ``cuda:{LOCAL_RANK}``)."""
    if not dist.is_initialized():
        raise RuntimeError("initialize_distributed() first")
    world = dist.get_world_size()
    n = cfg.world_size
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n or max(ranks) >= world:
        raise ConfigurationError(
            f"a dp={cfg.dp} x cp={cfg.cp} x ep={cfg.ep} x tp={cfg.tp} "
            f"mesh needs {n} of the world's {world} ranks, got {ranks}")
    whole = ranks == list(range(world))
    world_group = None if whole else dist.new_group(ranks)
    grid = np.asarray(ranks).reshape(cfg.dp, cfg.cp, cfg.ep * cfg.tp)
    me = dist.get_rank()
    mine = {}

    def groups(rows, key):
        # a dp or cp axis of extent 1 has no group (nothing runs over it);
        # the mp group always exists, of one rank too
        for row in rows:
            row = [int(r) for r in row]
            g = (world_group if len(row) == n
                 else dist.new_group(row) if len(row) > 1 or key == "mp"
                 else None)
            if me in row:
                mine[key] = g

    groups(grid.reshape(-1, cfg.ep * cfg.tp), "mp")
    groups(grid.transpose(1, 2, 0).reshape(-1, cfg.dp), "dp")
    groups(grid.transpose(0, 2, 1).reshape(-1, cfg.cp), "cp")
    if me not in ranks:
        return None
    dp_rank, cp_rank, ep_rank, tp_rank = rank_coords(cfg, ranks.index(me))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(mine["mp"], dist.get_backend(mine["mp"]), device,
                ep_rank * cfg.tp + tp_rank, cfg.tp, src=ranks[0],
                ep=cfg.ep, dp=cfg.dp, cp=cfg.cp, dp_rank=dp_rank,
                cp_rank=cp_rank, world_group=world_group,
                dp_group=mine["dp"], cp_group=mine["cp"])


def mesh_from_config(tpu_config, device=None) -> Mesh:
    """The mesh of a TpuConfig's parallelism degrees, as the counterpart
    reads them (mesh.py:152-167): ``tp_degree`` counts every rank, and
    ``cp_degree``, ``attention_dp_degree`` and ``ep_degree`` group them,
    so the tp axis is ``tp_degree / (cp·dp·ep)``."""
    tp = max(int(tpu_config.tp_degree), 1)
    cp = max(int(tpu_config.cp_degree), 1)
    dp = max(int(tpu_config.attention_dp_degree), 1)
    ep = max(int(tpu_config.ep_degree), 1)
    shrink = cp * dp * ep
    if tp % shrink:
        raise ConfigurationError(f"tp_degree {tp} is not divisible by "
                                 f"cp*dp*ep = {shrink}")
    return build_mesh(MeshConfig(tp=tp // shrink, cp=cp, dp=dp, ep=ep),
                      device)


# ---------------------------------------------------------------------------
# spawned worlds (tests and chip_smoke.py)
# ---------------------------------------------------------------------------

# seconds a rank that has handed back its result has to exit
EXIT_GRACE_S = 5.0


def _rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank}" if device == "cuda" else device


def _all_joined(store, world: int) -> None:
    """Wait until every rank has joined the group: a rank that is done
    first must not tear its group down while another is still connecting
    to it (gloo's full-mesh connect then fails on the closed peer). No
    limit of its own: the parent stops every rank at the world's."""
    store.add("nxdi-joined", 1)
    while store.add("nxdi-joined", 0) < world:
        time.sleep(0.01)


def _rank_main(fn, rank, world, backend, device, store_path, timeout_s,
               args, results, mesh_cfg=None):
    try:
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        initialize_distributed(backend, store=store, rank=rank,
                               world_size=world, timeout_s=timeout_s)
        _all_joined(store, world)
        try:
            mesh = build_mesh(mesh_cfg or MeshConfig(tp=world),
                              _rank_device(device, rank))
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:            # the parent re-raises it
        results.put((rank, False, traceback.format_exc()))


def _failures(results, world: int, rank: int, tb: str) -> str:
    """The first failed rank's traceback and those of the ranks that fail
    within a second after it (a rank's crash often shows first as a
    closed connection on another rank)."""
    fails = {rank: tb}
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            r, ok, val = results.get(timeout=0.2)
        except queue_mod.Empty:
            continue
        if not ok:
            fails[r] = val
    return "\n".join(f"rank {r} of {world} failed:\n{t}"
                     for r, t in sorted(fails.items()))


def spawn_world(fn: Callable[..., Any], world: int, backend: str,
                device: str, tmpdir: str, timeout_s: float = 120.0,
                args: tuple = (), mesh_cfg: Optional[MeshConfig] = None
                ) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks and return each
    rank's result, in rank order. ``mesh`` is the world's mesh:
    ``mesh_cfg`` (its ``world_size`` must be ``world``), by default tp over
    every rank. ``fn`` must be importable by name (a
    module-level function); ``device`` "cpu", "cuda" (``cuda:{rank}``) or
    one device for every rank ("cuda:0": two ranks on one card). The ranks
    meet over a ``FileStore`` under ``tmpdir``. Raises ``RuntimeError``
    with the rank's traceback when a rank fails, and when the world has
    not finished within ``timeout_s`` (init included). A rank that has
    handed back its result gets ``EXIT_GRACE_S`` to exit (an NCCL group's
    teardown can hang), then it is stopped; every rank is stopped before
    this returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(tmpdir, f"nxdi-store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, store_path,
                               timeout_s, args, results, mesh_cfg),
                         daemon=True)
             for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the world of {world} ranks did not finish "
                        f"within {timeout_s} s (results from ranks "
                        f"{sorted(out)})")
                continue
            if not ok:
                raise RuntimeError(_failures(results, world, rank, val))
            out[rank] = val
        grace = time.monotonic() + EXIT_GRACE_S
        for p in procs:
            p.join(timeout=max(grace - time.monotonic(), 0.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        if os.path.exists(store_path):
            os.remove(store_path)
