"""Applications: the contiguous-cache ``CausalLMApplication`` and the
paged ``PagedCausalLMApplication`` built on it (counterpart:
``neuronx_distributed_inference_tpu/models/application.py`` —
``CausalLMApplication`` :52-1080: ``__init__`` :55, ``load_weights``
:106, ``init_random_weights`` :115, ``_put_params`` :127,
``save_quantized_state_dict`` / ``load_quantized_state_dict`` :154-176,
``init_cache`` :203, ``_check_decode_fits`` :263, ``_kv_bucket`` :277,
``warmup`` :323,
``_default_sampling_params`` :508, ``_run_prefill`` :515,
``_run_prefill_windowed`` :557, ``_run_decode`` :613, ``_run_decode_loop``
:649, ``_generate_repadded`` :687,
``generate`` :780, ``reset`` :967; ``_flatten_tree`` /
``_unflatten_tree`` :1083-1102; ``_finalize_generation`` :1105;
``_tel_start`` / ``_tel_end`` :383-411;
``PagedCausalLMApplication`` :1120-1626, its ``_coupled_sampling`` /
``_stream_seeds`` :1163-1178, ``_run_spec_draft`` :1251,
``_run_spec_verify`` :1286, ``_run_ragged`` :1330; the
jit-cache accounting ``_note_jit`` / ``declare_steady_state`` /
``request_context`` / ``warmup_state`` :78-82, 373-381, 413-494; the
multi-LoRA methods ``load_lora_adapters`` / ``lora_adapter_arrays`` /
``write_lora_slot`` / ``set_lora_adapter`` :1004-1080 and
``_lora_adapter_ids`` :1180).

Same host contract as the JAX applications. The contiguous app:
``init_cache``, ``_run_prefill``, ``_run_decode``, ``_run_decode_loop``,
``generate``, ``reset`` and ``_run_prefill_windowed`` (windowed context
encoding, reference :557-599: a prompt longer than
``windowed_context_encoding`` is prefilled window by window through
``model_base.token_generation_multi``, eagerly); the paged app:
``_run_paged``, ``_run_paged_loop``, ``_run_ragged``, ``_run_spec_draft``,
``_run_spec_verify``, ``generate``, ``release``,
``reset``, with the host
owning the block allocator and tables. Step results are torch tensors
(read them with ``np.asarray(t.cpu())``). Images and M-RoPE positions of
the JAX ``generate`` are not ported.

Multi-LoRA (``TpuConfig.lora_config``): every step takes ``adapter_ids``
(B,), each row's slot of the stacked adapter factors; ``generate`` takes
them on both apps (the reference's paged ``generate`` does not). A step
with ids is a signature of its own (its ids ride the int32 staging buffer
of a captured graph); a step without them is the LoRA-free step. An id
at or past ``max_loras`` raises :class:`ConfigurationError` on the host
(XLA's gather clamps it). Adapter slots are written in place
(:meth:`~CausalLMApplication.write_lora_slot`), so the captured graphs
serve a swapped slot at their next replay.

The contiguous cache is full rows, the rolling cache or the mixed
per-layer cache, as ``model_base.cache_layout`` decides (``init_cache``,
reference :203-241). A rolling cache never overflows (slot = pos % w):
decode may run past ``seq_len`` there, and its gather path reads every
slot (no KV-view bucket).

The KV cache is updated IN PLACE by every step. The JAX application
donated the cache buffers to each step, which made every step a
destructive update already; the port just does it without the copy.

Every ``_run_*`` builds a signature — the kind, its bucket, the batch, the
table or KV-view width and every host-side decision that changes the op
sequence — and notes it (``_note_jit``). On the card a T = 1 step that
samples greedily, or with the seeded coupled draw of a ``stream_seed``
config at the config's sampling params, is captured once per signature
into a CUDA graph and replayed afterwards (``models/cuda_graphs.py``, the
counterpart of the JAX jit cache), and so is the self-draft loop; every
other step runs eagerly. A paged app with a ``stream_seed`` config samples
with the coupled draw (row seeds 0 unless the caller threads them), as
the reference's does; the contiguous app draws from its generator. After
:meth:`~CausalLMApplication.declare_steady_state` (``serving/warmup.py``'s
``precompile``), a first-seen graph signature is an incident: the
``nxdi_steady_state_recompiles_total`` counter, a ``compile.unexpected``
flight-recorder event with the request traces of the dispatch
(:meth:`~CausalLMApplication.request_context`), and an entry in
:meth:`~CausalLMApplication.warmup_state`. Eager signatures are never
incidents. Replacing ``params`` or ``cache`` drops the graphs, which read
the old tensors.

Every ``_run_*`` is timed as the reference's (``_tel_start`` /
``_tel_end``, :383-411): with the registry enabled, the host part and the
device part (a wait on a CUDA event recorded after the dispatch) into
``nxdi_run_seconds{kind,part}`` and the step's rows into
``nxdi_device_sampled_rows_total{kind}``; with the flight recorder live a
``run.<kind>`` slice of the host window. Both off, nothing is timed and
nothing waits.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed; a missing
card raises (``device.resolve_device``).

Tensor and expert parallelism (``mesh=``, reference ``mesh=`` :57-67 and
``_mesh_ctx`` :366-371): one process a rank (``parallel/mesh``). The app
builds the full spec at ``tp_degree = mesh.mp`` (:attr:`full_spec`, the
layout the converters and the JAX package's tree at that mesh use; heads
and vocabulary resolve against every rank, ep·tp) and runs on the rank's
own spec (:attr:`spec`: local heads, MLP columns, vocabulary rows, its
experts; ``model_base.local_spec``). Every rank loads or draws the full
weights and keeps its slice (``utils/checkpoint.device_put_params``,
``model_base.init_params``; a checkpoint's tensors of experts another
rank holds are not read), with ``moe_tkg_ep_degree=1`` also the hybrid
decode copy of its expert leaves (every expert, a slice of the
intermediate), and makes its own cache of local heads. Host
decisions are made once, on rank 0: the scheduler, the planner, the block
allocator and prefix cache, the SLO tracker and the degradation
controller run there only, and each ``_run_*`` step rank 0 makes sends its
record (the method and its inputs: one frame of a header and the host
arrays, and the device tensors device to device; ``parallel/dispatch``)
to the other ranks before it runs. The other ranks run :meth:`~CausalLMApplication.follow`,
which makes the same call with the same inputs, until rank 0's
:meth:`~CausalLMApplication.stop_followers`; every rank samples the same
token from the gathered logits (greedy, the seeded coupled draw, or the
app's generator, seeded from ``TpuConfig.seed`` alike on every rank and
drawn in the same order). A gloo group cannot be captured into CUDA
graphs (the app refuses ``cuda_graphs=True`` with one on the card); an
NCCL group's collectives are captured with the T = 1 steps, the
communicator made by one collective before the first capture.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..config import InferenceConfig, TpuConfig
from ..device import DeviceLike, resolve_device
from ..modules import autobucketing
from ..modules import kv_cache as kvc
from ..modules.block_kv_cache import (BlockKVCacheManager, BlockKVSpec,
                                      cut_cached_at_unwritten,
                                      slots_from_table)
from ..ops import decode_attention
from ..ops.sampling import prepare_sampling_params, sample, sampling_seed
from ..parallel import collectives, dispatch
from ..resilience.errors import CapacityError, ConfigurationError
from ..telemetry import get_registry
from ..telemetry import metrics as tmetrics
from ..telemetry import trace as trace_mod
from ..utils import checkpoint as ckpt
from . import model_base
from .model_base import rows_of
from .cuda_graphs import StepGraphs
from .family import DecoderFamily, family_for_config


def _finalize_generation(input_ids: np.ndarray, collected, eos_ids,
                         ttft: float, seq_lens: np.ndarray) -> Dict[str, Any]:
    """Concat steps, fill past the first eos per row, assemble the result."""
    gen = np.concatenate(collected, axis=1)
    if eos_ids is not None:
        for i in range(gen.shape[0]):
            hits = np.where(np.isin(gen[i], eos_ids))[0]
            if hits.size:
                gen[i, hits[0] + 1:] = eos_ids[0]
    return {"sequences": np.concatenate([input_ids, gen], axis=1),
            "generated": gen, "ttft_s": ttft, "seq_lens": seq_lens}


def _flatten_tree(tree: Dict[str, Any], prefix: str = ""
                  ) -> Dict[str, torch.Tensor]:
    """A nested parameter dict -> {dotted name: tensor} (reference
    :1083)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, dict):
            out.update(_flatten_tree(v, key + "."))
        else:
            out[key] = v
    return out


def _unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_flatten_tree` (reference :1094)."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _dispatched(fn):
    """A device step of the app. On rank 0 of a mesh over several ranks
    the outermost call first sends its record (name and inputs,
    ``parallel/dispatch``) to the other ranks, which run the same call in
    :meth:`follow`."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        m = self.mesh
        if (m is not None and m.size > 1 and m.leads
                and not self._dispatch_depth):
            t0 = time.perf_counter()
            self._channel.send(fn.__name__, args, kw)
            self.dispatch_stats["records"] += 1
            self.dispatch_stats["broadcast_s"] += time.perf_counter() - t0
        self._dispatch_depth += 1
        try:
            return fn(self, *args, **kw)
        finally:
            self._dispatch_depth -= 1
    _DISPATCHED.add(fn.__name__)
    return run


_DISPATCHED: set = set()


class CausalLMApplication:
    """Contiguous-KV causal LM on one card, or on one rank of a mesh: the
    cache holds ``kv_cache_batch_size`` rows of ``seq_len`` slots (of the
    rank's KV heads)."""

    # per-row keys of a generate() result (the repad shim slices them)
    _row_keys = ("sequences", "generated", "seq_lens")

    def __init__(self, model_path: Optional[str], config: InferenceConfig,
                 family: Optional[Type[DecoderFamily]] = None,
                 device: DeviceLike = None, cuda_graphs: bool = True,
                 mesh=None):
        if mesh is not None and (device is None or torch.device(
                device) == torch.device(mesh.device.type)):
            device = mesh.device          # "cuda": the rank's own card
        self.device = resolve_device(device)
        self.model_path = model_path
        self.config = config
        self.tpu_config: TpuConfig = config.tpu_config
        self.family = family or family_for_config(config)
        self.mesh = mesh
        if mesh is None and self.tpu_config.tp_degree > 1:
            raise ConfigurationError(
                f"tp_degree={self.tpu_config.tp_degree} needs mesh= "
                "(parallel.mesh.mesh_from_config on every rank)")
        if mesh is not None:
            if self.device != mesh.device:
                raise ConfigurationError(
                    f"device {self.device} is not the mesh's {mesh.device}")
            if (cuda_graphs and self.device.type == "cuda"
                    and mesh.backend != "nccl"):
                raise ConfigurationError(
                    f"a {mesh.backend} group cannot be captured into CUDA "
                    "graphs: pass cuda_graphs=False, or use an NCCL group")
        # the full layout at the mesh's degree (the rank's spec follows it)
        self.full_spec = self.family.build_spec(
            config, tp_degree=mesh.mp if mesh is not None else 1)
        # rank 0's dispatch records (tp > 1): count and host seconds
        self.dispatch_stats = {"records": 0, "broadcast_s": 0.0}
        self._channel = (dispatch.Channel(mesh)
                         if mesh is not None and mesh.size > 1 else None)
        self._dispatch_depth = 0
        # T = 1 steps replay captured CUDA graphs on the card
        # (``cuda_graphs=False``: every step eager)
        self.graphs: Optional[StepGraphs] = (
            StepGraphs(self.device)
            if cuda_graphs and self.device.type == "cuda" else None)
        self.params = None
        self.cache = None
        # LoRA slot -> writes so far: the prefix cache's salt of the rows
        # that gather the slot (lora_kv_salt)
        self._lora_writes: Dict[int, int] = {}
        # telemetry: None = follow the process-global registry; assign
        # app.telemetry = reg to pin one. _jit_seen tracks (kind, bucket,
        # sig) signatures; after declare_steady_state() a first-seen graph
        # signature is an incident, attributed to _trace_ctx
        self._telemetry_override = None
        self._jit_seen: set = set()
        self._steady_state = False
        self._steady_incidents: List[Dict[str, Any]] = []
        self._trace_ctx: Tuple[str, ...] = ()
        self._warmup_report: Optional[Dict[str, Any]] = None
        # each dp replica samples its own rows: its generator draws its own
        # noise (the counterpart folds the dp index into its key,
        # ops/sampling.py:198-237)
        self.generator = torch.Generator(device=self.device).manual_seed(
            sampling_seed(self.tpu_config.seed,
                          mesh.dp_rank if mesh is not None else 0))
        self.ctx_buckets = autobucketing.context_encoding_buckets(
            self.tpu_config)
        self.tkg_buckets = autobucketing.token_generation_buckets(
            self.tpu_config)
        self.batch_buckets = autobucketing.batch_buckets(self.tpu_config)
        self._inv_freq = model_base.rope_inv_freq(self.spec, self.device)

    @property
    def full_spec(self):
        """The spec of the whole model, laid out for the mesh's degree: the
        layout the converters and the weights' draw use, and the one place
        a caller replaces the model's spec. :attr:`spec` is derived from
        it."""
        return self._full_spec

    @full_spec.setter
    def full_spec(self, spec):
        self._full_spec = spec
        self._spec = (spec if self.mesh is None
                      else model_base.local_spec(spec, self.mesh))

    @property
    def spec(self):
        """The spec each step runs on: :attr:`full_spec` without a mesh,
        the rank's own cut of it (``model_base.local_spec``) with one.
        Assigning it assigns :attr:`full_spec`, which a rank's cut cannot
        stand for: over a mesh that raises."""
        return self._spec

    @spec.setter
    def spec(self, spec):
        if self.mesh is not None:
            raise ConfigurationError(
                "over a mesh replace full_spec (the rank's spec is cut "
                "from it)")
        self.full_spec = spec

    # -- tensors the captured graphs read ------------------------------------
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._drop_graphs()
        self._params = value

    @property
    def cache(self):
        return self._cache

    @cache.setter
    def cache(self, value):
        self._drop_graphs()
        self._cache = value

    def _drop_graphs(self):
        if self.graphs is not None:
            self.graphs.clear()

    # -- telemetry and the steady-state sentinel --------------------------
    @property
    def telemetry(self):
        return (self._telemetry_override
                if self._telemetry_override is not None else get_registry())

    @telemetry.setter
    def telemetry(self, reg):
        self._telemetry_override = reg

    def _tel_start(self):
        """``perf_counter()`` when telemetry or the flight recorder is
        live, else None: the disabled path does no timing work and no
        device wait in :meth:`_tel_end` (reference :383-389)."""
        if self.telemetry.enabled or trace_mod.get_recorder().enabled:
            return time.perf_counter()
        return None

    def _tel_end(self, kind: str, t0, out, n_rows: int) -> None:
        """Observe one ``_run_*`` call (reference :391-411): the host part
        (entry to dispatch return) and, only while the registry is
        enabled, the device part, a wait on a CUDA event recorded after
        the dispatch (the reference's ``block_until_ready``; on the CPU the
        step has run by its return) into ``nxdi_run_seconds{kind,part}``,
        and the rows into ``nxdi_device_sampled_rows_total{kind}``. The
        flight recorder's ``run.<kind>`` slice covers the host window only:
        recording never waits on the card."""
        if t0 is None:
            return
        t1 = time.perf_counter()
        rec = trace_mod.get_recorder()
        if rec.enabled:
            rec.complete(f"run.{kind}", t0, cat="app", t1=t1, rows=n_rows)
        tel = self.telemetry
        if not tel.enabled:
            return
        if out["tokens"].device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        t2 = time.perf_counter()
        hist = tmetrics.run_seconds_histogram(tel)
        hist.observe(t1 - t0, kind=kind, part="host")
        hist.observe(t2 - t1, kind=kind, part="device")
        tmetrics.device_sampled_rows_counter(tel).inc(n_rows, kind=kind)

    def _note_jit(self, kind: str, bucket, sig, graph: bool) -> None:
        """Signature accounting (reference ``_note_jit``): the first time a
        (kind, bucket, sig) runs it is a build — here a CUDA-graph capture
        when ``graph`` and the app captures — afterwards a cache hit. A
        first-seen ``graph`` signature after steady state is an incident;
        an eager one never is."""
        key = (kind, bucket, sig)
        new = key not in self._jit_seen
        if new:
            self._jit_seen.add(key)
            rec = trace_mod.get_recorder()
            if rec.enabled:
                rec.instant("compile", cat="app", kind=kind,
                            bucket=str(bucket), sig=str(sig))
            if self._steady_state and graph:
                self._note_steady_recompile(kind, bucket, sig, rec)
        tel = self.telemetry
        if tel.enabled:
            if self._steady_state:
                # a steady-state app serves its incident counter, at 0
                # until an incident
                tmetrics.steady_state_recompiles_counter(tel)
            if new and graph and self.graphs is not None:
                tmetrics.jit_compiles_counter(tel).inc(kind=kind,
                                                       bucket=str(bucket))
            else:
                tmetrics.jit_cache_hits_counter(tel).inc(kind=kind)

    _MAX_STEADY_INCIDENTS = 256

    def _note_steady_recompile(self, kind: str, bucket, sig, rec) -> None:
        """A first-seen graph signature after steady state: the counter,
        a ``compile.unexpected`` event and the request traces of the
        dispatch (reference ``_note_steady_recompile``)."""
        traces = [t for t in self._trace_ctx if t]
        incident = {"kind": kind, "bucket": str(bucket), "sig": str(sig),
                    "traces": traces}
        self._steady_incidents.append(incident)
        if len(self._steady_incidents) > self._MAX_STEADY_INCIDENTS:
            del self._steady_incidents[0]
        if rec.enabled:
            rec.instant("compile.unexpected", cat="app", kind=kind,
                        bucket=str(bucket), sig=str(sig), traces=traces)
        tel = self.telemetry
        if tel.enabled:
            tmetrics.steady_state_recompiles_counter(tel).inc(
                kind=kind, bucket=str(bucket))

    def declare_steady_state(self, on: bool = True):
        """After ``precompile()`` walked the ladder: every first-seen graph
        signature from now on is a tracked incident."""
        self._steady_state = bool(on)
        return self

    def request_context(self, traces):
        """Context manager attributing an incident inside the body to
        ``traces`` (the request trace ids of the dispatch)."""
        @contextlib.contextmanager
        def _ctx():
            prev = self._trace_ctx
            self._trace_ctx = tuple(traces)
            try:
                yield
            finally:
                self._trace_ctx = prev
        return _ctx()

    def warmup_state(self) -> Dict[str, Any]:
        """JSON-able cold-start account (``/v1/debug/state["warmup"]``):
        the precompile summary, the steady-state flag, every incident, and
        the captured graphs with their replays."""
        out: Dict[str, Any] = {
            "steady_state": self._steady_state,
            "graphs_seen": len(self._jit_seen),
            "incidents": list(self._steady_incidents),
        }
        if self._warmup_report is not None:
            out["precompile"] = {
                k: self._warmup_report[k]
                for k in ("n_graphs", "n_compiles", "n_cache_loads",
                          "n_warm_hits", "total_seconds")
                if k in self._warmup_report}
        if self.graphs is not None:
            out["cuda_graphs"] = {
                "captured": len(self.graphs),
                "replays": {str(k): n
                            for k, n in self.graphs.replays.items()}}
        return out

    def _greedy(self, sampling_params) -> bool:
        sc = self.tpu_config.on_device_sampling_config
        return sampling_params is None and (sc is None or not sc.do_sample)

    def _step(self, kind: str, bucket, sig, graph: bool, fn, inputs,
              rows: int, sampling_params=None):
        """Run one step: ``fn(tensors, sampling_params)`` over ``inputs``
        (numpy arrays or device tensors, all int32). A ``graph`` signature
        (a T = 1 step or the draft loop, greedy or coupled) replays its
        captured CUDA graph on the card, with the config's sampling params
        (``fn(tensors, None)``); everything else runs eagerly. ``rows``:
        the sampled rows :meth:`_tel_end` counts."""
        t0 = self._tel_start()
        self._note_jit(kind, bucket, sig, graph)
        if graph and self.graphs is not None:
            if not len(self.graphs):
                self._reserve_graphs()
            out = self.graphs.run((kind, bucket, sig),
                                  lambda t: fn(t, None), inputs)
        else:
            out = fn({k: self._t(v) for k, v in inputs.items()},
                     sampling_params)
        self._tel_end(kind, t0, out, rows)
        return out

    def _reserve_graphs(self):
        """Pin the decode kernels' merge counters at the largest batch
        bucket before the first capture; over an NCCL mesh, make its
        communicator first (a capture cannot)."""
        if self.mesh is not None and self.mesh.backend == "nccl":
            self.mesh.warm()
        if self.graphs is not None:
            self.graphs.reserve(
                max(self.batch_buckets
                    + [self.tpu_config.kv_cache_batch_size or 0]),
                decode_attention.counters_per_row(
                    self.spec.gqa.num_kv_heads, self.spec.gqa.q_per_kv))

    # -- weights -----------------------------------------------------------
    def load_weights(self, model_path: Optional[str] = None):
        """Load + convert a HF safetensors checkpoint onto the device (over
        a mesh: the rank's slice of each converted leaf; the tensors of
        experts another rank holds are not read, unless the hybrid decode
        copy needs every expert)."""
        spec = self.full_spec
        skip = (ckpt.expert_skip(spec.moe.num_experts, self.mesh)
                if spec.moe is not None
                and not model_base.wants_tkg_copy(spec, self.mesh)
                else None)
        sd = ckpt.load_state_dict(model_path or self.model_path, skip=skip)
        self._put_params(self.family.convert_hf_state_dict(sd,
                                                           self.full_spec))
        return self

    def init_random_weights(self, seed: int = 0):
        """Synthetic weights made on the device from ``seed``, each leaf in
        its spec's dtype (an MoE router in fp32), factorized and quantized
        on the device as the config asks (``model_base.init_params``);
        over a mesh each rank keeps its slice of every full leaf."""
        self.params = model_base.init_params(self.full_spec, seed,
                                             self.device, self.mesh)
        return self

    def _put_params(self, host: Dict[str, Any]):
        """A host tree (laid out for :attr:`full_spec`) onto the device in
        the reference's order (reference :127-151): fuse q/k/v, stack the
        zero adapter factors a checkpoint never carries
        (``stack_lora_host``, :135), then ``utils/checkpoint.
        device_put_params`` (cast, factorize and quantize leaf by leaf;
        over a mesh, keep the rank's slice)."""
        host = model_base.fuse_qkv_host(host)
        host = model_base.stack_lora_host(self.full_spec, host)
        self.params = ckpt.device_put_params(host, self.full_spec,
                                             self.device, self.mesh)

    def save_quantized_state_dict(self, path: str):
        """Save the quantized (and factorized) weights flat, under the
        reference's dotted names (``layers.o_proj.qweight``, ...), with the
        config (reference :154-167). Reload with
        :meth:`load_quantized_state_dict`; the JAX application's reads the
        same files."""
        if self.spec.quant is None:
            raise ValueError("config.tpu_config.quantized must be set")
        if self.mesh is not None and self.mesh.size > 1:
            raise ConfigurationError(
                "a rank holds a slice of the tree: save the quantized "
                "checkpoint from a tp = 1 app (ROADMAP A13d)")
        if self.params is None:
            raise RuntimeError("load_weights() first")
        ckpt.save_state_dict_safetensors(_flatten_tree(self.params), path)
        self.config.save(path + os.sep)

    def load_quantized_state_dict(self, path: str):
        """Load a :meth:`save_quantized_state_dict` checkpoint (the port's
        or the JAX application's) onto the device, every tensor in its
        stored dtype (reference :169-176)."""
        sd = ckpt.load_state_dict(path, keep_dtypes=True)
        params = _unflatten_tree({name: t.to(self.device)
                                  for name, t in sd.items()})
        if self.mesh is not None:
            params = model_base.shard_params(self.full_spec, params,
                                             self.mesh)
        self.params = params
        return self

    # -- cache -------------------------------------------------------------
    def init_cache(self):
        """Zeroed KV cache: full rows, the rolling cache (``sliding_window``
        slots a row) or the mixed per-layer cache (``k``/``v`` for the
        global layers, ``k_l``/``v_l`` for the local ones)."""
        cfg = self.tpu_config
        spec = self.spec
        rows, slots = self._cache_cut()
        kspec = kvc.KVCacheSpec(
            num_layers=spec.num_layers,
            batch_size=rows,
            max_seq_len=slots,
            num_kv_heads=spec.gqa.num_kv_heads,
            head_dim=spec.head_dim,
            dtype=spec.kv_dtype,
            window=spec.sliding_window if spec.rolling_window else 0,
            # MLA: V heads narrower than K (reference application.py:217)
            v_head_dim=spec.v_head_dim)
        if spec.mixed_kv:
            self.cache = kvc.init_mixed_cache(kspec, spec.layer_pattern,
                                              spec.sliding_window,
                                              self.device)
        else:
            self.cache = kvc.init_cache(kspec, self.device)
        return self

    def _cache_cut(self) -> Tuple[int, int]:
        """(rows, slots) of this rank's contiguous cache: the rows over dp
        (``kv_cache.py:91-101``, ``P(dp)`` on the batch) and, under flash
        decoding over cp, the slots over cp; the whole cache otherwise."""
        cfg, m = self.tpu_config, self.mesh
        rows, slots = cfg.kv_cache_batch_size, cfg.seq_len
        if m is None:
            return rows, slots
        if rows % m.dp:
            raise ConfigurationError(
                f"kv_cache_batch_size {rows} is not divisible by "
                f"attention_dp_degree {m.dp}")
        rows //= m.dp
        if self.spec.flash_decoding and m.cp > 1:
            if slots % m.cp:
                raise ConfigurationError(
                    f"flash decoding cuts seq_len {slots} over cp_degree "
                    f"{m.cp}: it must divide")
            slots //= m.cp
        return rows, slots

    # -- the dp replicas' rows of a contiguous step ------------------------
    def _dp_plan(self, sid: np.ndarray):
        """None without a dp axis; else (each replica's indices into the
        step's rows, this replica's indices, their local cache rows): a
        row runs on the replica that holds its cache row, ``seq_id //
        (B / dp)``, at cache row ``seq_id % (B / dp)`` there. Every rank
        computes the same plan from the record's host ``seq_ids``."""
        m = self.mesh
        if m is None or m.dp == 1:
            return None
        sid = np.asarray(sid, np.int64)
        per = self.cache["k"].shape[1]
        owner = sid // per
        idx = [np.nonzero(owner == i)[0] for i in range(m.dp)]
        mine = idx[m.dp_rank]
        return idx, mine, (sid[mine] - m.dp_rank * per).astype(np.int32)

    def _dp_run(self, plan, fn):
        """Run ``fn(mine, local cache rows)`` on this replica's rows (none:
        nothing runs) and gather every replica's outputs over dp, back in
        the step's row order: one all-gather a tensor when the replicas
        ran the same row count, padded to the largest otherwise."""
        idx, mine, local = plan
        counts = [len(i) for i in idx]
        out = fn(mine, local) if len(mine) else None
        if len(set(counts)) == 1:
            out = {k: collectives.gather_dim(v, self.mesh, "dp", 0)
                   for k, v in out.items()}
        else:
            out = collectives.gather_rows_uneven(out, counts, self.mesh,
                                                 self.device)
        order = np.concatenate(idx)
        if (order != np.arange(len(order))).any():
            inv = torch.as_tensor(np.argsort(order), device=self.device)
            out = {k: v[inv] for k, v in out.items()}
        return out

    # -- helpers -----------------------------------------------------------
    def _check_decode_fits(self, needed: int):
        """Decode writing KV slots up to ``needed - 1`` must stay inside
        the configured seq_len; a rolling cache (slot = pos % w) never
        overflows."""
        if self.spec.rolling_window:
            return
        limit = self.tpu_config.seq_len
        if needed > limit:
            raise CapacityError(
                f"decode would write KV at position {needed - 1} past the "
                f"configured seq_len {limit}")

    def _kv_bucket(self, needed: int) -> Optional[int]:
        """Smallest decode bucket covering ``needed`` cache slots: the
        gather path reads cache[:bucket] only. None = the whole cache (and
        always on a rolling cache, whose slots are not positions)."""
        if self.spec.rolling_window or len(self.tkg_buckets) <= 1:
            return None
        return autobucketing.get_target_bucket(self.tkg_buckets, needed)

    def _default_sampling_params(self, batch: int):
        sc = self.tpu_config.on_device_sampling_config
        if sc is None:
            return None
        return torch.as_tensor(prepare_sampling_params(
            batch, sc.top_k, sc.top_p, sc.temperature), device=self.device)

    def _t(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _seq_ids(self, b: int, seq_ids) -> torch.Tensor:
        """Cache rows of a step on the device."""
        if seq_ids is None:
            return torch.arange(b, dtype=torch.int32, device=self.device)
        return self._t(self._host_seq_ids(b, seq_ids))

    def _host_seq_ids(self, b: int, seq_ids) -> np.ndarray:
        """Cache rows of a step on the host; non-identity rows need
        continuous batching (the static steps skip the row gather)."""
        if seq_ids is None:
            return np.arange(b, dtype=np.int32)
        if (not self.tpu_config.is_continuous_batching
                and not np.array_equal(np.asarray(seq_ids), np.arange(b))):
            raise ValueError("non-identity seq_ids require "
                             "is_continuous_batching=True")
        return np.asarray(seq_ids, np.int32)

    def _lora_adapter_ids(self, adapter_ids) -> Optional[np.ndarray]:
        """The per-row LoRA slot input of a step (reference :1180-1192):
        None (no adapters) keeps the step LoRA-free; negative ids are slot
        0, the zero adapter. Raises :class:`ConfigurationError` for ids
        without ``lora_config`` and for an id at or past ``max_loras``
        (the reference's gather clamps it; a deliberate difference)."""
        if adapter_ids is None:
            return None
        if self.spec.lora is None:
            raise ConfigurationError(
                "adapter_ids passed but the model was built without "
                "lora_config; set TpuConfig.lora_config")
        if isinstance(adapter_ids, torch.Tensor):
            adapter_ids = adapter_ids.cpu().numpy()
        aids = np.maximum(np.asarray(adapter_ids, np.int32), 0)
        if aids.size and int(aids.max()) >= self.spec.lora.max_loras:
            raise ConfigurationError(
                f"adapter id {int(aids.max())} is past the "
                f"{self.spec.lora.max_loras} LoRA slots (max_loras)")
        return aids

    @staticmethod
    def _with_aids(inputs, aids):
        if aids is not None:
            inputs["aids"] = aids
        return inputs

    # -- device steps ------------------------------------------------------
    @_dispatched
    def _run_prefill(self, input_ids, seq_lens, seq_ids=None,
                     sampling_params=None, adapter_ids=None,
                     _local: bool = False):
        """Prefill of a (B, bucket) right-padded window
        (``model_base.context_encoding_step``, eager); the cache is
        written in place. ``adapter_ids`` (B,): the rows' LoRA slots.
        Returns {"tokens", "last_hidden", ["logits"], ["hidden_states"]}
        on the device. Over dp each replica prefills the rows whose cache
        rows it holds (:meth:`_dp_plan`)."""
        b, s = np.shape(input_ids)
        plan = None if _local else self._dp_plan(
            self._host_seq_ids(b, seq_ids))
        if plan is not None:
            return self._dp_run(plan, lambda mine, local: self._run_prefill(
                rows_of(np.asarray(input_ids), mine, b),
                rows_of(np.asarray(seq_lens), mine, b), local,
                rows_of(sampling_params, mine, b),
                rows_of(adapter_ids, mine, b), _local=True))
        t0 = self._tel_start()
        sid = self._seq_ids(b, seq_ids)
        aids = self._lora_adapter_ids(adapter_ids)
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None, :].expand(b, s)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        self._note_jit("prefill", s, (b, s, aids is not None), graph=False)
        out = model_base.context_encoding_step(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(input_ids), pos, sid, self._t(seq_lens),
            sampling_params, self.generator, self._inv_freq,
            None if aids is None else self._t(aids))
        self._tel_end("prefill", t0, out, b)
        return out

    @_dispatched
    def _run_prefill_windowed(self, input_ids, seq_lens, window: int,
                              sampling_params=None, _local: bool = False):
        """Windowed context encoding (reference application.py:557-599): a
        (B, n x window) right-padded prompt walks the cache in fixed
        windows through ``model_base.token_generation_multi`` (eager), so
        attention holds (window, seq_len) scores instead of (S, S). Padded
        positions are pushed to ``seq_len`` (their writes drop). Each row
        keeps the logits of its last real position, sampled once at the
        end. Returns {"tokens"} on the device."""
        if self.spec.rolling_window or self.spec.mixed_kv:
            raise NotImplementedError(
                "windowed_context_encoding is incompatible with rolling / "
                "mixed per-layer KV caches (slot != position)")
        b, s = np.shape(input_ids)
        plan = None if _local else self._dp_plan(np.arange(b))
        if plan is not None:
            return self._dp_run(plan, lambda mine, local: (
                self._run_prefill_windowed(
                    rows_of(np.asarray(input_ids), mine, b),
                    rows_of(np.asarray(seq_lens), mine, b), window,
                    rows_of(sampling_params, mine, b), _local=True)))
        t0 = self._tel_start()
        lens = np.asarray(seq_lens, np.int64)
        sid = self._seq_ids(b, None)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        last = torch.zeros((b, self.spec.vocab_size), dtype=torch.float32,
                           device=self.device)
        limit = self.tpu_config.seq_len
        for off in range(0, s, window):
            pos = off + np.arange(window)[None, :]
            pos = np.where(pos < lens[:, None], pos, limit)
            self._note_jit("windowed_cte", window, (b,), graph=False)
            lg = model_base.token_generation_multi(
                self.spec, self.tpu_config, self.params, self.cache,
                self._t(input_ids[:, off:off + window]), self._t(pos), sid,
                self._inv_freq)["logits_all"]
            idx = self._t(np.clip(lens - 1 - off, 0, window - 1), torch.long)
            lg = torch.gather(lg, 1, idx[:, None, None].expand(
                -1, 1, lg.shape[-1]))[:, 0]
            hit = (lens - 1 >= off) & (lens - 1 < off + window)
            last = torch.where(self._t(hit, torch.bool)[:, None],
                               lg.float(), last)
        sc = self.tpu_config.on_device_sampling_config
        out = {"tokens": sample(last, sc, sampling_params, self.generator)}
        self._tel_end("prefill", t0, out, b)
        return out

    @_dispatched
    def _run_decode(self, input_ids, position_ids, seq_ids=None,
                    sampling_params=None, adapter_ids=None):
        """One decode step (``model_base.token_generation_step``):
        ``input_ids`` numpy or a device tensor, ``position_ids`` numpy."""
        b, t = tuple(input_ids.shape)
        needed = int(np.max(np.asarray(position_ids))) + t
        self._check_decode_fits(needed)
        return self._decode_call(input_ids, position_ids, seq_ids,
                                 self._kv_bucket(needed), sampling_params,
                                 adapter_ids)

    @_dispatched
    def _decode_call(self, input_ids, position_ids, seq_ids, kv_view,
                     sampling_params=None, adapter_ids=None,
                     _local: bool = False):
        """The decode step at an explicit ``kv_view`` bucket (the warm-up
        plane reaches every bucket with positions past the cache, which
        write nothing). Its signature: batch, width, identity rows,
        kernel or gather path (the view only matters to the gather),
        greedy, logits, LoRA ids."""
        b, t = tuple(input_ids.shape)
        sid = self._host_seq_ids(b, seq_ids)
        plan = None if _local else self._dp_plan(sid)
        if plan is not None:
            return self._dp_run(plan, lambda mine, local: self._decode_call(
                rows_of(input_ids, mine, b),
                rows_of(np.asarray(position_ids), mine, b), local,
                kv_view, rows_of(sampling_params, mine, b),
                rows_of(adapter_ids, mine, b), _local=True))
        aids = self._lora_adapter_ids(adapter_ids)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        identity = self._identity_rows(sid, t)
        kernel = model_base.use_contiguous_decode_kernel(
            self.spec, t, b, self.cache, identity)
        view = None if kernel else kv_view
        greedy = self._greedy(sampling_params)
        sig = (b, t, identity, kernel, greedy,
               bool(self.tpu_config.output_logits), aids is not None)

        def fn(x, sp):
            return model_base.token_generation_step(
                self.spec, self.tpu_config, self.params, self.cache,
                x["ids"], x["pos"], x["sid"], sp, self.generator, view,
                self._inv_freq, x.get("aids"), identity=identity)
        return self._step("decode", view, sig, t == 1 and greedy, fn,
                          self._with_aids({"ids": input_ids,
                                           "pos": position_ids,
                                           "sid": sid}, aids),
                          b * t, sampling_params)

    def _identity_rows(self, sid: np.ndarray, t: int = 1) -> bool:
        """Whether a decode step of width ``t`` over cache rows ``sid``
        runs as over the identity rows (cache row b for batch row b):
        always on a static batch. Under continuous batching only where that
        admits the contiguous decode kernel: the step holds every cache
        row in order (a full batch of running rows, as the adapters sort
        them) and the kernel takes the geometry; every other step keeps
        the gather path. (A deliberate difference: the reference decides
        from the config alone, so its continuous batching never takes the
        kernel. On the H100 the kernel's full-batch step beat the gather's:
        PERF.md, phase 25 (c).)"""
        if not self.tpu_config.is_continuous_batching:
            return True
        b = len(sid)
        return (b == self.cache["k"].shape[1]
                and bool((sid == np.arange(b)).all())
                and model_base.use_contiguous_decode_kernel(
                    self.spec, t, b, self.cache, True))

    @_dispatched
    def _run_decode_loop(self, first_tokens, positions, num_steps: int,
                         seq_ids=None, sampling_params=None,
                         adapter_ids=None, _local: bool = False):
        """``num_steps`` decode steps with the tokens on the device
        (``model_base.decode_loop``, eager)."""
        b = np.shape(first_tokens)[0]
        plan = None if _local else self._dp_plan(
            self._host_seq_ids(b, seq_ids))
        if plan is not None:
            return self._dp_run(plan, lambda mine, local: (
                self._run_decode_loop(
                    rows_of(first_tokens, mine, b),
                    rows_of(np.asarray(positions), mine, b),
                    num_steps, local,
                    rows_of(sampling_params, mine, b),
                    rows_of(adapter_ids, mine, b), _local=True)))
        t0 = self._tel_start()
        sid = self._seq_ids(b, seq_ids)
        aids = self._lora_adapter_ids(adapter_ids)
        needed = int(np.max(np.asarray(positions))) + num_steps
        self._check_decode_fits(needed)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        self._note_jit("decode_loop", num_steps, (b, aids is not None),
                       graph=False)
        out = model_base.decode_loop(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(first_tokens), self._t(positions), sid, sampling_params,
            self.generator, num_steps=num_steps,
            kv_view=self._kv_bucket(needed), inv_freq=self._inv_freq,
            adapter_ids=None if aids is None else self._t(aids))
        self._tel_end("decode_loop", t0, out, b * num_steps)
        return out

    def warmup(self):
        """Walk the warm-up plan of ``serving/warmup.py`` (every graph
        signature the app serves is captured; eager steps need no warm-up)
        without declaring steady state."""
        from ..serving.warmup import precompile
        precompile(self, declare_steady=False)
        return self

    # -- generation --------------------------------------------------------
    def _generate_repadded(self, input_ids: np.ndarray, **kw
                           ) -> Dict[str, Any]:
        """Batch-mismatch shim: b below a batch bucket pads by REPEATING
        ROW 0 (pad rows recompute row 0 and rewrite its cache rows with the
        same values); b above the compiled batch splits into batch-sized
        chunks run one after the other."""
        b_in = input_ids.shape[0]
        cfg = self.tpu_config
        per_row = ("attention_mask", "sampling_params", "teacher_tokens",
                   "adapter_ids")

        def _batchful(k, x):
            return k in per_row and x is not None

        if b_in > cfg.batch_size:
            outs = []
            for lo in range(0, b_in, cfg.batch_size):
                hi = min(lo + cfg.batch_size, b_in)
                sub = {k: (np.asarray(v)[lo:hi] if _batchful(k, v) else v)
                       for k, v in kw.items()}
                outs.append(self.generate(input_ids[lo:hi], **sub))

            def _cat(key):
                arrs = [np.asarray(o[key]) for o in outs]
                if arrs[0].ndim == 1:
                    return np.concatenate(arrs)
                w = max(a.shape[1] for a in arrs)
                return np.concatenate(
                    [np.pad(a, ((0, 0), (0, w - a.shape[1]))) for a in arrs])

            merged = {key: _cat(key) for key in self._row_keys}
            merged["ttft_s"] = outs[0]["ttft_s"]
            if kw.get("return_logits") and "logits" in outs[0]:
                n_steps = max(len(o["logits"]) for o in outs)
                merged["logits"] = [
                    np.concatenate([np.asarray(
                        o["logits"][min(si, len(o["logits"]) - 1)])
                        for o in outs], axis=0)
                    for si in range(n_steps)]
            return merged

        pad = autobucketing.get_target_bucket(self.batch_buckets,
                                              b_in) - b_in

        def _pad0(k, x):
            if not _batchful(k, x):
                return x
            a = np.asarray(x)
            return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])

        kw2 = {k: _pad0(k, v) for k, v in kw.items()}
        padded_ids = np.concatenate(
            [input_ids, np.repeat(input_ids[:1], pad, axis=0)])
        out = self.generate(padded_ids, **kw2)
        res = dict(out)
        for key in self._row_keys:
            res[key] = np.asarray(out[key])[:b_in]
        if "logits" in out:
            res["logits"] = [np.asarray(lg)[:b_in] for lg in out["logits"]]
        return res

    def generate(self, input_ids: np.ndarray,
                 attention_mask: Optional[np.ndarray] = None,
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 sampling_params: Optional[np.ndarray] = None,
                 return_logits: bool = False,
                 teacher_tokens: Optional[np.ndarray] = None,
                 adapter_ids: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        """Greedy/sampled generation. input_ids (B, S) right-padded;
        attention_mask (B, S) marks real tokens. Returns sequences
        including the prompt (HF convention), ``generated``, ``seq_lens``,
        ``ttft_s`` and, with ``return_logits`` (and ``output_logits`` in
        the config), the logits of every step.

        ``teacher_tokens`` (B, T): feed these instead of the sampled tokens
        at decode steps 1..T (teacher forcing, for logit matching).
        ``adapter_ids`` (B,): each row's LoRA slot (reference :787-826).

        Tokens stay on the device between steps; the eos check runs one
        chunk late, as the JAX app's overlapped fetch does."""
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if b not in self.batch_buckets:
            return self._generate_repadded(
                input_ids, attention_mask=attention_mask,
                max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                sampling_params=sampling_params, return_logits=return_logits,
                teacher_tokens=teacher_tokens, adapter_ids=adapter_ids)
        aids = self._lora_adapter_ids(adapter_ids)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        seq_lens = attention_mask.astype(np.int32).sum(axis=1)
        if self.cache is None:
            self.init_cache()
        if self.params is None:
            raise RuntimeError("load_weights() or init_random_weights() "
                               "first")
        if sampling_params is not None:
            sampling_params = torch.as_tensor(np.asarray(sampling_params),
                                              device=self.device)
        if teacher_tokens is not None:
            teacher_tokens = np.asarray(teacher_tokens)
            max_new_tokens = min(max_new_tokens,
                                 teacher_tokens.shape[1] + 1)
        wcte = self.tpu_config.windowed_context_encoding
        if wcte and s > wcte:
            # windowed context encoding pads to a window multiple
            bucket = -(-s // wcte) * wcte
        else:
            wcte = None
            bucket = autobucketing.get_target_bucket(self.ctx_buckets, s)
        padded = np.zeros((b, bucket), input_ids.dtype)
        padded[:, :s] = input_ids
        if int(seq_lens.max()) + max_new_tokens > self.tpu_config.seq_len:
            max_new_tokens = self.tpu_config.seq_len - int(seq_lens.max())
            if max_new_tokens <= 0:
                raise ValueError("prompt exceeds seq_len")

        t0 = time.perf_counter()
        if wcte:
            if return_logits or aids is not None:
                raise NotImplementedError(
                    "windowed context encoding supports plain text prompts "
                    "without logits output")
            out = self._run_prefill_windowed(padded, seq_lens, wcte,
                                             sampling_params=sampling_params)
        else:
            out = self._run_prefill(padded, seq_lens,
                                    sampling_params=sampling_params,
                                    adapter_ids=aids)
        first = out["tokens"]
        logits_trace: List[np.ndarray] = (
            [out["logits"].cpu().numpy()]
            if return_logits and "logits" in out else [])
        eos_ids = (None if eos_token_id is None
                   else np.atleast_1d(np.asarray(eos_token_id, np.int64)))
        collected = [first[:, None]]
        pending = first[:, None]          # tokens not yet eos-checked
        ttft = None
        positions = seq_lens.astype(np.int32)
        n_generated = 1
        eos_seen = np.zeros((b,), bool) if eos_ids is not None else None
        chunk = max(self.tpu_config.decode_chunk_tokens, 1)
        while n_generated < max_new_tokens:
            remaining = max_new_tokens - n_generated
            n = chunk if remaining >= chunk else 1
            cur = collected[-1][:, -1]
            if teacher_tokens is not None:
                cur = teacher_tokens[:, n_generated - 1].astype(np.int32)
                n = 1
            if n == 1 or return_logits:
                o = self._run_decode(cur[:, None], positions[:, None],
                                     sampling_params=sampling_params,
                                     adapter_ids=aids)
                new = o["tokens"].reshape(b, 1)
                if return_logits and "logits" in o:
                    logits_trace.append(o["logits"].cpu().numpy())
                positions = positions + 1
                n_generated += 1
            else:
                new = self._run_decode_loop(
                    cur, positions, n, sampling_params=sampling_params,
                    adapter_ids=aids)["tokens"]
                positions = positions + n
                n_generated += n
            collected.append(new)
            if ttft is None:
                first.cpu()
                ttft = time.perf_counter() - t0
            if eos_seen is not None:
                eos_seen |= np.isin(pending.cpu().numpy(),
                                    eos_ids).any(axis=1)
                pending = new
                if eos_seen.all():
                    break
        if ttft is None:
            first.cpu()
            ttft = time.perf_counter() - t0
        collected = [np.asarray(c.cpu().numpy()) for c in collected]
        result = _finalize_generation(input_ids, collected, eos_ids, ttft,
                                      seq_lens)
        if return_logits:
            result["logits"] = logits_trace
        return result

    # -- multi-LoRA serving ------------------------------------------------
    def load_lora_adapters(self, ckpt_paths: Optional[Dict[str, str]] = None
                           ) -> Dict[str, int]:
        """Load PEFT adapter directories into slots 1..N (slot 0 stays the
        zero adapter), ``ckpt_paths`` {name: dir} defaulting to
        ``lora_config.lora_ckpt_paths`` (reference :1006-1025). Returns
        {name: slot}."""
        lc = self.tpu_config.lora_config
        if self.spec.lora is None or lc is None:
            raise ConfigurationError("lora_config must be set on the "
                                     "TpuConfig")
        ckpt_paths = ckpt_paths or lc.lora_ckpt_paths or {}
        if self.params is None:
            raise RuntimeError("load_weights() first")
        slots: Dict[str, int] = {}
        for slot, (name, path) in enumerate(ckpt_paths.items(), start=1):
            if slot >= self.spec.lora.max_loras:
                raise ConfigurationError(
                    f"adapter {name!r}: slot {slot} exceeds max_loras "
                    f"{self.spec.lora.max_loras}")
            self.set_lora_adapter(slot, path)
            slots[name] = slot
        self.lora_slots = slots
        return slots

    def lora_adapter_arrays(self, path: str) -> Dict[str, Any]:
        """One PEFT adapter directory as host arrays in the stacked layout,
        ``{module: (A (L, in, r), B (L, r, out))}``, with the base
        weights' head transforms (``parallel.layers.place_q_weight`` /
        ``replicate_kv_weight``, identities at tp 1), so they are
        slot-writable as they are (reference :1027-1064)."""
        from ..modules import lora as lora_mod
        from ..parallel.layers import place_q_weight, replicate_kv_weight
        sd, acfg = lora_mod.load_peft_adapter(path)
        spec = self.spec
        g, D, H = spec.gqa, spec.head_dim, spec.hidden_size
        I = spec.intermediate_size
        dims = {"q_proj": (H, spec.q_size), "k_proj": (H, spec.kv_size),
                "v_proj": (H, spec.kv_size), "o_proj": (spec.q_size, H),
                "gate_proj": (H, I), "up_proj": (H, I),
                "down_proj": (I, H)}
        outs = {"q_proj": lambda b: place_q_weight(b, g, D, -1),
                "k_proj": lambda b: replicate_kv_weight(b, g, D, -1),
                "v_proj": lambda b: replicate_kv_weight(b, g, D, -1)}
        arrays: Dict[str, Any] = {}
        for mod in spec.lora.target_modules:
            d_in, d_out = dims[mod]
            # o_proj's A reads the padded head layout on its input side
            ins = ((lambda a: place_q_weight(a, g, D, 0))
                   if mod == "o_proj" else None)
            arrays[mod] = lora_mod.adapter_layer_arrays(
                sd, acfg, spec.num_layers, mod, d_in, d_out, spec.lora.rank,
                out_transform=outs.get(mod), in_transform=ins)
        return arrays

    def write_lora_slot(self, slot: int, arrays: Dict[str, Any]):
        """Write adapter ``arrays`` ({module: (A (L, in, r), B (L, r,
        out))}, numpy or tensors) into ``slot`` of the stacked factors, IN
        PLACE (reference :1066-1075 rebinds fresh arrays): a captured
        graph holds the tensors' addresses and serves the new factors at
        its next replay. Each layer stack (:func:`model_base.layer_plan`)
        takes its own layers' rows; an MoE stack has no MLP factors."""
        from ..modules import lora as lora_mod
        if not 0 <= slot < self.spec.lora.max_loras:
            raise ConfigurationError(
                f"LoRA slot {slot} is outside [0, "
                f"{self.spec.lora.max_loras})")
        # before the write: even a write that fails half-way retires the
        # prefix-cache blocks computed under the slot's old factors
        self._lora_writes[slot] = self._lora_writes.get(slot, 0) + 1
        for key, rows in self._lora_stack_rows().items():
            lw = self.params[key]
            for mod, (a, b) in arrays.items():
                if f"lora_A_{mod}" in lw:
                    lora_mod.set_adapter_slot(self.params, key, slot, mod,
                                              a[rows], b[rows])
        return self

    def _lora_stack_rows(self) -> Dict[str, Any]:
        """{stack key: the absolute layers it holds} (a slice when the
        stack holds every layer)."""
        plan = model_base.layer_plan(self.spec)
        out: Dict[str, Any] = {}
        for key in dict.fromkeys(k for k, *_ in plan):
            rows = [i for k, i, _, _ in plan if k == key]
            out[key] = (slice(None) if len(rows) == self.spec.num_layers
                        else rows)
        return out

    def lora_kv_salt(self, slot: int) -> bytes:
        """The prefix cache's salt for a row that gathers LoRA ``slot``:
        KV written under one adapter is never served to a row under
        another, nor to a base row (a deliberate difference: the
        reference keys its prefix cache on the tokens only). Slot 0 as
        loaded (the zero adapter) salts nothing, so base rows share
        blocks as before; every write to a slot gives it a new salt."""
        n = self._lora_writes.get(int(slot), 0)
        if int(slot) == 0 and n == 0:
            return b""
        return b"lora:%d:%d" % (int(slot), n)

    def set_lora_adapter(self, slot: int, path: str):
        """Dynamic multi-LoRA: (re)load one adapter directory into
        ``slot`` (reference :1077-1080)."""
        return self.write_lora_slot(slot, self.lora_adapter_arrays(path))

    def follow(self):
        """The loop of a rank > 0 of a mesh: receive each step rank 0
        dispatches and make the same call with the same host inputs, until
        rank 0's :meth:`stop_followers`. Set-up (weights, cache) is each
        rank's own, made before it."""
        m = self.mesh
        if m is None or m.leads:
            raise ConfigurationError("follow() runs on the ranks > 0 of a "
                                     "mesh; rank 0 plans the steps")
        while True:
            rec = self._channel.recv()
            if rec is None:
                return self
            name, args, kw = rec
            if name not in _DISPATCHED:
                raise ConfigurationError(f"not a dispatched step: {name!r}")
            getattr(self, name)(*args, **kw)

    def stop_followers(self):
        """Rank 0: end the other ranks' :meth:`follow` loops."""
        m = self.mesh
        if m is not None and m.size > 1 and m.leads:
            self._channel.stop()
        return self

    @_dispatched
    def reset(self):
        """Clear the KV cache between requests (zeroed in place, so the
        captured graphs stay valid)."""
        if self.cache is None:
            return self.init_cache()
        for t in self.cache.values():
            t.zero_()
        return self


class PagedCausalLMApplication(CausalLMApplication):
    """Paged-KV (block layout) causal LM with prefix caching on one card,
    or on one rank of a mesh (the pages hold the rank's KV heads; the block
    allocator and the prefix cache that rank 0 uses plan every rank's
    writes)."""

    _row_keys = CausalLMApplication._row_keys + ("cached_tokens",)

    def __init__(self, model_path: Optional[str], config: InferenceConfig,
                 family: Optional[Type[DecoderFamily]] = None,
                 device: DeviceLike = None, cuda_graphs: bool = True,
                 mesh=None):
        if not config.tpu_config.is_block_kv_layout:
            raise ConfigurationError("the paged application needs "
                                     "is_block_kv_layout=True")
        super().__init__(model_path, config, family, device, cuda_graphs,
                         mesh)
        if self.spec.mla is not None:
            # the block cache holds one head width; MLA's K and V differ
            # (the reference would fail inside its first write)
            raise ConfigurationError(
                "multi-head latent attention runs on the contiguous "
                "CausalLMApplication only: the paged block cache holds one "
                "head width for K and V")

    # -- cache -------------------------------------------------------------
    def init_cache(self):
        cfg = self.tpu_config
        bspec = BlockKVSpec(
            num_layers=self.spec.num_layers,
            num_blocks=cfg.pa_num_blocks + 1,    # +1: reserved null block 0
            block_size=cfg.pa_block_size,
            num_kv_heads=self.spec.gqa.num_kv_heads,
            head_dim=self.spec.head_dim,
            dtype=self.spec.kv_dtype,
        )
        self.kv_mgr = BlockKVCacheManager(
            bspec, self.device, enable_prefix_caching=cfg.is_prefix_caching)
        # the application owns the live cache tensors; the manager keeps the
        # allocator and the tables
        self.cache = self.kv_mgr.cache
        self.kv_mgr.cache = None
        self.max_blocks = bspec.blocks_for(cfg.seq_len)
        self._bt_buckets = autobucketing.block_table_buckets(
            cfg, self.max_blocks)
        return self

    # -- helpers -----------------------------------------------------------
    def _bt_width(self, b: int) -> int:
        return self._bt_width_for(range(b))

    def _bt_width_for(self, seq_ids) -> int:
        """Smallest block-table width bucket covering every live row."""
        live = max((len(self.kv_mgr.tables.get(i, ())) for i in seq_ids),
                   default=1)
        return autobucketing.get_target_bucket(self._bt_buckets,
                                               max(live, 1))

    # -- positionally coupled sampling (ops/sampling.coupled_sample) -------
    def _coupled_sampling(self) -> bool:
        sc = self.tpu_config.on_device_sampling_config
        return (sc is not None and sc.do_sample
                and sc.stream_seed is not None)

    def _stream_seeds(self, row_seeds, batch: int) -> Optional[np.ndarray]:
        """The per-row seed input of the paged steps (reference
        application.py:1168): None unless the coupled stream is on; zeros
        when the caller threads none."""
        if not self._coupled_sampling():
            return None
        if row_seeds is None:
            return np.zeros((batch,), np.int32)
        return np.asarray(row_seeds, np.int32)

    def _sampling_mode(self, sampling_params):
        """(mode, graphable) of a step from the caller's sampling params:
        ``greedy``; ``coupled`` (the seeded draw, a pure function of the
        step's inputs, so a T = 1 step with the config's params replays a
        graph); or ``sampled`` (a ``torch.Generator`` draw, always eager)."""
        if self._greedy(sampling_params):
            return "greedy", True
        if self._coupled_sampling():
            return "coupled", sampling_params is None
        return "sampled", False

    def _paged_inputs(self, inputs, seeds, aids=None):
        if seeds is not None:
            inputs["seeds"] = seeds
        return self._with_aids(inputs, aids)

    # -- device steps ------------------------------------------------------
    @_dispatched
    def _run_paged(self, input_ids, position_ids, slot_mapping, block_table,
                   last_idx, sampling_params=None, row_seeds=None,
                   adapter_ids=None):
        """One paged step (``model_base.paged_forward_step``); the cache is
        written in place. Signature: width, batch, table width, sampling
        mode, logits, LoRA ids; a greedy or coupled T = 1 step replays its
        graph. Returns {"tokens", ["logits"]} on the device."""
        b, t = np.shape(input_ids)
        mode, graphable = self._sampling_mode(sampling_params)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        seeds = self._stream_seeds(row_seeds, b)
        aids = self._lora_adapter_ids(adapter_ids)
        sig = (b, int(np.shape(block_table)[1]), mode,
               bool(self.tpu_config.output_logits), aids is not None)

        def fn(x, sp):
            return model_base.paged_forward_step(
                self.spec, self.tpu_config, self.params, self.cache,
                x["ids"], x["pos"], x["slots"], x["bt"], x["last"], sp,
                self.generator, self._inv_freq, x.get("seeds"),
                x.get("aids"))
        return self._step("paged", t, sig, t == 1 and graphable, fn,
                          self._paged_inputs(
                              {"ids": input_ids, "pos": position_ids,
                               "slots": slot_mapping, "bt": block_table,
                               "last": last_idx}, seeds, aids),
                          b, sampling_params)

    @_dispatched
    def _run_ragged(self, input_ids, position_ids, slot_mapping,
                    block_table, widths, emit_modes, sampling_params=None,
                    row_seeds=None, want_hidden: bool = False,
                    adapter_ids=None):
        """ONE ragged mixed step (``model_base.paged_ragged_step``): rows
        mix decode steps, prefill chunks and verify windows, each at its
        own offset over its own block table. ``input_ids`` may be a device
        tensor (verify rows' drafts); the other host arrays are numpy: the
        capacity check, the verify test and the signature (grid width,
        batch, table width, verify, sampling mode, ``want_hidden``, LoRA
        ids) read them without touching the device. A greedy or coupled
        all-decode step (W = 1, no verify row) replays its graph, the
        rows' ``adapter_ids`` riding its staging buffer. The cache is
        written in place. Returns {"tokens", "num_emitted"} on the device,
        and {"hidden"} (B, W, H) with ``want_hidden`` (the Medusa and EAGLE
        proposers' features; reference :1325-1345 keys its jit on it)."""
        pos = np.asarray(position_ids)
        wid = np.asarray(widths)
        emit = np.asarray(emit_modes)
        self._check_decode_fits(int(np.max(pos[:, 0] + wid)))
        b, w = pos.shape
        mode, graphable = self._sampling_mode(sampling_params)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        seeds = self._stream_seeds(row_seeds, b)
        aids = self._lora_adapter_ids(adapter_ids)
        verify = bool((emit == model_base.EMIT_VERIFY).any())
        sig = (b, int(np.shape(block_table)[1]), verify, mode,
               bool(want_hidden), aids is not None)

        def fn(x, sp):
            return model_base.paged_ragged_step(
                self.spec, self.tpu_config, self.params, self.cache,
                x["ids"], x["pos"], x["slots"], x["bt"], x["wid"],
                x["emit"], sp, self.generator, self._inv_freq,
                verify=verify, row_seeds=x.get("seeds"),
                want_hidden=want_hidden, adapter_ids=x.get("aids"))
        return self._step("ragged", w, sig,
                          w == 1 and not verify and graphable, fn,
                          self._paged_inputs(
                              {"ids": input_ids, "pos": pos,
                               "slots": slot_mapping, "bt": block_table,
                               "wid": wid, "emit": emit}, seeds, aids),
                          b, sampling_params)

    @_dispatched
    def _run_paged_loop(self, first_tokens, positions, block_table,
                        num_steps: int, sampling_params=None,
                        row_seeds=None, adapter_ids=None):
        """``num_steps`` decode steps with in-device slot advance
        (``model_base.paged_decode_loop``, eager); blocks for the horizon
        must be allocated already."""
        self._check_decode_fits(
            int(np.max(np.asarray(positions))) + num_steps)
        t0 = self._tel_start()
        b = np.shape(first_tokens)[0]
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        seeds = self._stream_seeds(row_seeds, b)
        aids = self._lora_adapter_ids(adapter_ids)
        self._note_jit("paged_loop", num_steps,
                       (b, int(np.shape(block_table)[1]), aids is not None),
                       graph=False)
        out = model_base.paged_decode_loop(
            self.spec, self.tpu_config, self.params, self.cache,
            self._t(first_tokens), self._t(positions),
            self._t(block_table), sampling_params, self.generator,
            num_steps=num_steps, inv_freq=self._inv_freq,
            row_seeds=None if seeds is None else self._t(seeds),
            adapter_ids=None if aids is None else self._t(aids))
        self._tel_end("paged_loop", t0, out, b * num_steps)
        return out

    # -- speculative serving steps (serving/speculation/) ------------------
    @_dispatched
    def _run_spec_draft(self, first_tokens, positions, block_table, widths,
                        num_steps: int, sampling_params=None,
                        row_seeds=None, adapter_ids=None):
        """The masked self-draft pass (``model_base.paged_spec_draft_loop``:
        ``num_steps`` T = 1 steps on the paged kernel). Frozen rows write
        nothing, so the per-row ``widths`` bound every KV write. The loop
        is one captured graph per (draft count, batch, table width,
        sampling mode) — the counterpart of the reference's one scan
        dispatch. Returns {"tokens": (B, num_steps)} on the device."""
        pos = np.asarray(positions)
        wid = np.asarray(widths)
        self._check_decode_fits(int(np.max(pos + wid - 1)))
        b = pos.shape[0]
        mode, graphable = self._sampling_mode(sampling_params)
        if sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        seeds = self._stream_seeds(row_seeds, b)
        aids = self._lora_adapter_ids(adapter_ids)
        sig = (b, int(np.shape(block_table)[1]), mode, aids is not None)

        def fn(x, sp):
            return model_base.paged_spec_draft_loop(
                self.spec, self.tpu_config, self.params, self.cache,
                x["first"], x["pos"], x["bt"], x["wid"], sp, self.generator,
                num_steps=num_steps, inv_freq=self._inv_freq,
                row_seeds=x.get("seeds"), adapter_ids=x.get("aids"))
        return self._step("spec_draft", num_steps, sig, graphable, fn,
                          self._paged_inputs(
                              {"first": first_tokens, "pos": pos,
                               "bt": block_table, "wid": wid}, seeds, aids),
                          b * num_steps, sampling_params)

    @_dispatched
    def _run_spec_verify(self, input_ids, position_ids, slot_mapping,
                         block_table, widths, sampling_params=None,
                         row_seeds=None, want_hidden: bool = False,
                         adapter_ids=None):
        """The speculative verify step (``model_base.paged_spec_verify``):
        one W-wide paged forward with exact-match acceptance, greedy or
        coupled. ``input_ids`` may be a device tensor (the drafts never
        visit the host). Wide grids run eagerly. Returns {"tokens",
        "num_emitted"} on the device, and {"hidden"} (B, W, H) with
        ``want_hidden`` (a part of the signature, as reference
        :1287-1301 keys its jit on it)."""
        pos = np.asarray(position_ids)
        wid = np.asarray(widths)
        self._check_decode_fits(int(np.max(pos[:, 0] + wid)))
        b, w = pos.shape
        mode, _ = self._sampling_mode(sampling_params)
        seeds = self._stream_seeds(row_seeds, b)
        if seeds is not None and sampling_params is None:
            sampling_params = self._default_sampling_params(b)
        aids = self._lora_adapter_ids(adapter_ids)
        sig = (b, int(np.shape(block_table)[1]), mode, bool(want_hidden),
               aids is not None)

        def fn(x, sp):
            return model_base.paged_spec_verify(
                self.spec, self.tpu_config, self.params, self.cache,
                x["ids"], x["pos"], x["slots"], x["bt"], x["wid"], sp,
                x.get("seeds"), self._inv_freq, want_hidden=want_hidden,
                adapter_ids=x.get("aids"))
        return self._step("spec_verify", w, sig, False, fn,
                          self._paged_inputs(
                              {"ids": input_ids, "pos": pos,
                               "slots": slot_mapping, "bt": block_table,
                               "wid": wid}, seeds, aids), b, sampling_params)

    # -- generation --------------------------------------------------------
    def generate(self, input_ids: np.ndarray,
                 attention_mask: Optional[np.ndarray] = None,
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 sampling_params: Optional[np.ndarray] = None,
                 return_logits: bool = False,
                 teacher_tokens: Optional[np.ndarray] = None,
                 adapter_ids: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]:
        """Paged generation. input_ids (B, S) right-padded; attention_mask
        (B, S) marks real tokens. Prefix-cached prompt blocks are not
        recomputed. Returns sequences including the prompt (HF convention),
        ``generated``, ``cached_tokens`` and, with ``return_logits`` (and
        ``output_logits`` in the config), the per-step logits.

        ``teacher_tokens`` (B, T): feed these instead of the sampled tokens
        at decode steps 1..T (the contract of the JAX contiguous app's
        teacher forcing, for logit matching; the JAX paged app does not
        take it). ``adapter_ids`` (B,): each row's LoRA slot (a port-only
        argument: the JAX paged ``generate`` takes none)."""
        if teacher_tokens is not None:
            teacher_tokens = np.asarray(teacher_tokens)
            max_new_tokens = min(max_new_tokens,
                                 teacher_tokens.shape[1] + 1)
        logits_trace: List[np.ndarray] = []
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if b not in self.batch_buckets:
            return self._generate_repadded(
                input_ids, attention_mask=attention_mask,
                max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                sampling_params=sampling_params, return_logits=return_logits,
                teacher_tokens=teacher_tokens, adapter_ids=adapter_ids)
        aids = self._lora_adapter_ids(adapter_ids)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        seq_lens = attention_mask.astype(np.int32).sum(axis=1)
        if self.params is None:
            raise RuntimeError("load_weights() or init_random_weights() "
                               "first")
        if self.cache is None:
            self.init_cache()
        if sampling_params is not None:
            sampling_params = torch.as_tensor(np.asarray(sampling_params),
                                              device=self.device)
        eos_ids = (None if eos_token_id is None
                   else np.atleast_1d(np.asarray(eos_token_id, np.int64)))

        # --- allocate blocks; discover the cached prefix per row ---
        cfg = self.tpu_config
        chunked = (cfg.is_chunked_prefill
                   and cfg.chunked_prefill_config is not None)
        cached = np.zeros((b,), np.int32)
        bsz = self.kv_mgr.spec.block_size
        batch_fresh: set = set()      # blocks first written by THIS call
        for i in range(b):
            toks = input_ids[i, :seq_lens[i]].tolist()
            salt = b"" if aids is None else self.lora_kv_salt(aids[i])
            blocks, c = self.kv_mgr.begin_sequence(i, toks, salt=salt)
            if chunked:
                c = cut_cached_at_unwritten(blocks, c, bsz, batch_fresh)
            batch_fresh.update(blocks[c // bsz:])
            # always recompute >= 1 token so there are logits to sample
            cached[i] = min(c, seq_lens[i] - 1)
        bt = self.kv_mgr.block_table_array(range(b), self._bt_width(b))

        # --- prefill the uncached suffixes ---
        suffix_lens = seq_lens - cached
        t_max = int(suffix_lens.max())
        chunk_w = (cfg.chunked_prefill_config.kernel_q_tile_size
                   if chunked else 0)

        def _prefill_window(off_w, width, last_idx):
            ids_w = np.zeros((b, width), np.int32)
            pos_w = np.zeros((b, width), np.int32)
            for i in range(b):
                lo = cached[i] + off_w[i]
                n = int(np.clip(seq_lens[i] - lo, 0, width))
                ids_w[i, :n] = input_ids[i, lo:lo + n]
                pos_w[i] = lo + np.arange(width, dtype=np.int32)
            valid = (np.arange(width)[None, :]
                     < (seq_lens - cached - off_w)[:, None])
            # padded tail positions: negative slots write nothing
            slot_pos = np.where(valid, pos_w, -1)
            slots = slots_from_table(bt, slot_pos, bsz)
            return self._run_paged(ids_w, pos_w, slots, bt, last_idx,
                                   sampling_params, adapter_ids=aids)

        t0 = time.perf_counter()
        if chunk_w and t_max > chunk_w:
            n_chunks = -(-t_max // chunk_w)
            tokens = np.zeros((b, 1), np.int32)
            off = np.zeros((b,), np.int32)
            for _ in range(n_chunks):
                last_idx = np.clip(suffix_lens - 1 - off, 0, chunk_w - 1)
                out = _prefill_window(off, chunk_w, last_idx)
                toks = out["tokens"].cpu().numpy().reshape(b)
                final_here = ((suffix_lens - 1 >= off)
                              & (suffix_lens - 1 < off + chunk_w))
                tokens[final_here, 0] = toks[final_here]
                off = off + chunk_w
        else:
            bucket = autobucketing.get_target_bucket(self.ctx_buckets, t_max)
            out = _prefill_window(np.zeros((b,), np.int32), bucket,
                                  np.maximum(suffix_lens - 1, 0))
            tokens = out["tokens"].cpu().numpy().reshape(b, 1)
        ttft = time.perf_counter() - t0
        if return_logits and "logits" in out:
            logits_trace.append(out["logits"].cpu().numpy())

        collected = [tokens]
        positions = seq_lens.astype(np.int32)
        n_generated = 1
        eos_seen = np.zeros((b,), bool) if eos_ids is not None else None
        if eos_seen is not None:
            eos_seen |= np.isin(tokens[:, 0], eos_ids)
        # chunked paged decode: blocks for the whole chunk are allocated on
        # the host, then decode_chunk_tokens steps run with slots computed
        # on the device; return_logits / teacher forcing keep single steps
        chunk = (1 if (return_logits or teacher_tokens is not None)
                 else max(cfg.decode_chunk_tokens, 1))
        while n_generated < max_new_tokens:
            room = cfg.seq_len - int(positions.max())
            remaining = min(max_new_tokens - n_generated, room)
            steps = chunk if remaining >= chunk else 1
            steps = min(steps, remaining)
            if steps <= 0:
                break
            for i in range(b):
                self.kv_mgr.grow(i, steps)
            bt = self.kv_mgr.block_table_array(range(b), self._bt_width(b))
            cur = (teacher_tokens[:, n_generated - 1].astype(np.int32)
                   if teacher_tokens is not None
                   else collected[-1][:, -1].astype(np.int32))
            if steps == 1:
                pos = positions[:, None]
                slots = slots_from_table(bt, pos, bsz)
                o = self._run_paged(cur[:, None], pos, slots, bt,
                                    np.zeros((b,), np.int32),
                                    sampling_params, adapter_ids=aids)
                new = o["tokens"].cpu().numpy().reshape(b, 1)
                if return_logits and "logits" in o:
                    logits_trace.append(o["logits"].cpu().numpy())
            else:
                o = self._run_paged_loop(cur, positions, bt, steps,
                                         sampling_params, adapter_ids=aids)
                new = o["tokens"].cpu().numpy()
            collected.append(new)
            positions = positions + steps
            n_generated += steps
            if eos_seen is not None:
                eos_seen |= np.isin(new, eos_ids).any(axis=1)
                if eos_seen.all():
                    break

        result = _finalize_generation(input_ids, collected, eos_ids, ttft,
                                      seq_lens)
        result["cached_tokens"] = cached.copy()
        if return_logits:
            result["logits"] = logits_trace
        return result

    def release(self, seq_ids=None):
        """Return sequences' blocks to the allocator (prefix-cached blocks
        stay resident for reuse)."""
        ids = list(self.kv_mgr.tables) if seq_ids is None else list(seq_ids)
        for sid in ids:
            if sid in self.kv_mgr.tables:
                self.kv_mgr.end_sequence(sid)
        return self

    def reset(self):
        self.release()
        return self
