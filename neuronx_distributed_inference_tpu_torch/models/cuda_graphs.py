"""One captured CUDA graph per T = 1 step signature (port-only: the
counterpart of the JAX application's jit cache — ``_compiled`` /
``_jit_seen`` and ``_note_jit``, ``neuronx_distributed_inference_tpu/
models/application.py:70-82, 413-440``, where every new (kind, bucket,
shape) signature is a trace + XLA compile and every later call replays the
executable).

PyTorch runs eagerly, so a decode step pays the host for every one of its
hundreds of small launches; on the card that leaves the device idle most
of the step. :class:`StepGraphs` captures a step once per signature into a
``torch.cuda.CUDAGraph`` (all of an application's graphs share one memory
pool) and afterwards replays it:

  * inputs live in static device buffers, all int32, packed into one
    buffer that a pinned host staging buffer fills with one host-to-device
    copy per replay (tensors already on the card, such as the tokens a
    pipelined decode step feeds back from the step before it, are copied
    into their views on the device). Two staging buffers alternate, each
    with the event of its last copy, so the host never waits for the card
    before it fills the next one: with one step in flight (the adapters'
    ``pipeline_depth=1``) the buffer a fill reuses was read by a step the
    host has already fetched. ``StepGraphs.staging_waits`` counts the
    fills that found their buffer's copy not yet done (each such fill
    waits for it);
  * the outputs are the graph's static tensors, copied out on the device
    at each replay, so a caller may keep them across replays (the
    contiguous ``generate`` keeps its tokens on the card);
  * a capture first runs the step twice eagerly on a side stream with the
    same inputs (kernel builds, library handles and lazy allocations happen
    there, never inside the capture), then captures it; a step's cache
    writes depend only on its inputs, so the repeats write the same values.
    A failed capture raises (there is no eager fall back).

Each signature keeps its capture's wall time (the warm-up calls and the
capture, :meth:`StepGraphs.capture_seconds`) and the growth of
``torch.cuda.memory_allocated`` over it (:meth:`StepGraphs.pool_bytes`),
which the compiled-graph observatory (``telemetry/observatory.py``)
reports as the signature's build time and memory.

Kernel launches inside a capture are recorded into the graph, not made:
the kernel wrappers count them as ``<wrapper>.captured``
(``ops.decode_attention.count_launch``), each graph keeps its per-kernel
count, and :meth:`StepGraphs.replayed_launches` adds them up over the
replays. ``replays`` counts replays per signature.

Only T = 1 steps are captured (``paged_ragged_step`` at W = 1,
``paged_forward_step`` at T = 1, ``token_generation_step``), plus the
self-draft loop (``paged_spec_draft_loop``: k T = 1 steps in one graph per
(k, batch, table width), the counterpart of the reference's one scan
dispatch), and only when they sample greedily or with the seeded coupled
draw (``ops/sampling.coupled_sample``): that draw is a pure function of
the step's inputs, and its row seeds ride the int32 staging buffer with
the other inputs. So do the rows' LoRA slots (``aids``) of a multi-LoRA
step: the app's signature tells a step with ids from one without (the
reference's jit signature, serving/warmup.py:116-122), and each replay
gathers the factors from the stacked tensors it captured, which an
adapter swap writes in place. A T = 1 step's input tokens may be device
tensors (a pipelined step's fed-back tokens, int64 as sampled): the
replay copies them into the int32 static input on the card, with no host
round trip. A step reads every tensor of the app's cache, so the
decode graph of a rolling or mixed-cache app holds all of its stacks
(``k``/``v`` and ``k_l``/``v_l``); the rolling write slot (``pos % w``)
and the masks are computed on the device from the static position input,
so each replay takes its own positions. Wider grids (prefill, windowed
context encoding, mixed and verify passes) run
eagerly by design (PyTorch eager has no per-shape build to save), and a
``torch.Generator`` draw (do_sample without a ``stream_seed``) stays eager:
a replay would repeat the captured draw.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops import decode_attention, flash_attention

#: kernel wrappers whose launches a graph may hold (name -> wrapper)
KERNELS = {
    "paged_decode_attention": decode_attention.paged_decode_attention,
    "decode_attention_stacked": decode_attention.decode_attention_stacked,
    "flash_attention": flash_attention.flash_attention,
}

_WARMUP_CALLS = 2


class _Graph:
    """One captured step: its static input views (one int32 device buffer
    filled from one of two alternating pinned host buffers), the graph,
    its static outputs, the kernel launches it holds, and its capture's
    seconds and memory growth."""

    def __init__(self, device: torch.device,
                 shapes: Mapping[str, tuple]):
        self.shapes = dict(shapes)
        self._offsets: Dict[str, tuple] = {}
        n = 0
        for name, shape in self.shapes.items():
            size = int(np.prod(shape, dtype=np.int64))
            self._offsets[name] = (n, size)
            n += size
        self._staging = [torch.empty(max(n, 1), dtype=torch.int32,
                                     pin_memory=True) for _ in range(2)]
        self._staging_np = [h.numpy() for h in self._staging]
        self._copied: list = [None, None]
        self._next = 0
        self.dev = torch.empty(max(n, 1), dtype=torch.int32, device=device)
        self.static = {name: self.dev[o:o + size].view(self.shapes[name])
                       for name, (o, size) in self._offsets.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Dict[str, torch.Tensor] = {}
        self.kernel_launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    def load(self, inputs: Mapping[str, Any]) -> bool:
        """Fill the static inputs: numpy arrays through the next pinned
        staging buffer (one copy), device tensors by a copy on the card.
        Returns True when the buffer's previous copy was still running (the
        fill then waited for it)."""
        i = self._next
        self._next ^= 1
        waited = False
        ev = self._copied[i]
        if ev is not None and not ev.query():
            # the card has not yet read this buffer's previous fill
            ev.synchronize()
            waited = True
        on_card = []
        host = self._staging_np[i]
        for name, x in inputs.items():
            if isinstance(x, torch.Tensor):
                on_card.append((name, x))
                continue
            o, size = self._offsets[name]
            host[o:o + size] = np.asarray(x).reshape(-1)
        self.dev.copy_(self._staging[i], non_blocking=True)
        ev = self._copied[i] = torch.cuda.Event()
        ev.record()
        for name, x in on_card:
            self.static[name].copy_(x.reshape(self.shapes[name]))
        return waited


class StepGraphs:
    """The per-application graph cache: ``run(sig, fn, inputs)`` captures
    ``fn`` at the first sight of ``sig`` and replays it afterwards.

    ``fn(static)`` takes the dict of static int32 input tensors (shaped as
    ``inputs``) and returns a dict of output tensors. The caller drops the
    cache (:meth:`clear`) whenever a tensor the graphs read is replaced
    (the parameters, the KV cache)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Any, _Graph] = {}
        self._pool = None
        self.replays: Dict[Any, int] = {}
        self._replayed: Dict[str, int] = {k: 0 for k in KERNELS}
        self.staging_waits = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def signatures(self):
        return list(self._graphs)

    def kernel_launches(self, sig) -> Dict[str, int]:
        """Kernel launches one replay of ``sig``'s graph makes."""
        return dict(self._graphs[sig].kernel_launches)

    def capture_seconds(self, sig) -> float:
        """Wall seconds of ``sig``'s capture: its warm-up calls and the
        capture itself."""
        return self._graphs[sig].capture_s

    def pool_bytes(self, sig) -> int:
        """Growth of ``torch.cuda.memory_allocated`` over ``sig``'s
        capture: the memory its graph holds (outputs, staging and the
        pool blocks it keeps)."""
        return self._graphs[sig].pool_bytes

    def replayed_launches(self, name: str) -> int:
        """Launches of kernel ``name`` made by replays since the last
        :meth:`reset_counts` (graphs dropped since included)."""
        return self._replayed[name]

    def reset_counts(self) -> None:
        self.replays = {}
        self._replayed = {k: 0 for k in KERNELS}
        self.staging_waits = 0

    def clear(self) -> None:
        """Drop every graph (their inputs, outputs and pool memory go with
        the last reference)."""
        self._graphs = {}
        self._pool = None

    def reserve(self, max_rows: int, per_row: int) -> None:
        """Pin the decode kernels' merge counters for ``max_rows`` rows
        (the largest batch bucket) of ``per_row`` counters each
        (``decode_attention.counters_per_row``) before the first
        capture."""
        decode_attention.pin_merge_counters(self.device, max_rows * per_row)

    def run(self, sig, fn: Callable[[Dict[str, torch.Tensor]],
                                    Dict[str, torch.Tensor]],
            inputs: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        g = self._graphs.get(sig)
        if g is None:
            g = self._capture(fn, inputs)
            self._graphs[sig] = g
        elif g.load(inputs):
            self.staging_waits += 1
        g.graph.replay()
        self.replays[sig] = self.replays.get(sig, 0) + 1
        for name, n in g.kernel_launches.items():
            self._replayed[name] += n
        return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, fn, inputs: Mapping[str, Any]) -> _Graph:
        shapes = {k: tuple(np.shape(v)) if not isinstance(v, torch.Tensor)
                  else tuple(v.shape) for k, v in inputs.items()}
        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated(self.device)
        g = _Graph(self.device, shapes)
        g.load(inputs)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_CALLS):
                fn(g.static)
        cur.wait_stream(side)
        before = {k: w.captured for k, w in KERNELS.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            out = fn(g.static)
        g.graph = graph
        g.outputs = dict(out)
        g.kernel_launches = {k: w.captured - before[k]
                             for k, w in KERNELS.items()
                             if w.captured != before[k]}
        g.capture_s = time.perf_counter() - t0
        g.pool_bytes = torch.cuda.memory_allocated(self.device) - mem0
        return g
