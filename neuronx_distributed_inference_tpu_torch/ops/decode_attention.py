"""One-token decode attention over the KV cache (counterpart:
``neuronx_distributed_inference_tpu/ops/decode_attention.py`` — the Pallas
kernels ``_decode_kernel`` with its wrappers ``decode_attention`` :135 and
``decode_attention_stacked`` :162-261, and ``_paged_kernel`` with its
wrapper ``paged_decode_attention`` :336-518; ``supports`` :588,
``quantized_cache_ok`` :599).

One query token per row: each KV head's GQA group attends over the row's
prior tokens ``[0, lens[b])`` plus the active token (``new_k``/``new_v``,
never read from the cache — the caller has already written it there, and
the strict ``kpos < lens`` mask keeps it out). Two cache layouts:

  * the contiguous cache, K transposed ``(L, B, Hkv, D, S)`` and V
    ``(L, B, Hkv, S, D)``: :func:`decode_attention_stacked`;
  * the stacked page cache ``(L, N, Bs, Hkv, D)`` read through
    ``block_table[b, j]``: :func:`paged_decode_attention`.

Options: a dynamic sliding ``window`` (0 = none), tanh ``soft_cap``, a
per-head ``sink`` entering the softmax denominator only, and ``kv_scale``
dequantisation of the cache on load.

On CUDA tensors each wrapper launches its hand-written Hopper kernel
(``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu``; each
header says what bounds it on the H100 and what the design does about
that); on CPU tensors it runs its plain-PyTorch twin
(``decode_attention_stacked_plain``, ``paged_decode_attention_plain``).
There is no fall back from one to the other.

A wrapper called while its stream is being captured into a CUDA graph
(``models/cuda_graphs.py``) records the launch into the graph: it adds one
to ``<wrapper>.captured`` instead of ``<wrapper>.launches``, and the graph
cache counts the launches of its replays.

Given fake tensors (``torch._subclasses.FakeTensor``: a FakeTensorMode
trace, such as the compiled-graph observatory's, ``telemetry/
observatory.py``) a wrapper returns an empty output of its shape, as a
fake registration of the kernel would: nothing launches, no twin runs, no
launch is counted. Each listener opened by :func:`kernel_work_listener`
hears the call's work, by the kernel's own formula
(:func:`paged_decode_work`, :func:`stacked_decode_work`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import _build

NEG_INF = -2.3819763e38      # finite: the online softmax never sees inf-inf

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_ACT_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)
# query heads a block serves: a KV head's larger group is cut in chunks of
# at most this many, each its own block (group_chunks)
MAX_GROUP = 16
# paged split-K blocks: four per H100 SM, rounded down. On the H100 at the
# paged path's decode shapes the fused kernel took 10.7-11.0 us at 16
# splits, 11.2-11.3 at 12, 12.6-12.8 at 20 and 13.5-13.6 at 32
# (scripts/torch_kernel_times.py --paged-splits, PERF.md): fewer, longer
# shares keep their tiles in flight and leave the merge fewer splits.
_PAGED_TARGET_BLOCKS = 4 * 132
# contiguous split-K blocks: two per H100 SM, rounded down, the most its
# tensor-core kernel keeps resident (202 registers a thread, a 96 KB ring):
# one wave. The sweep at the Mistral-7B path's decode shapes is in PERF.md
# (scripts/torch_kernel_times.py --contig-splits).
_CONTIG_TARGET_BLOCKS = 2 * 132
_MAX_SPLITS = 64             # the fused merge's bound: two splits a lane


# ---------------------------------------------------------------------------
# Shared by both layouts
# ---------------------------------------------------------------------------

def _plain(q, k, v, new_k, new_v, lens, *, scale, window, soft_cap, sink,
           kv_scale):
    """The twins' math over one layer's prior keys k/v (B, Hkv, S, D) (any
    strides): mask ``kpos < lens[b]`` and ``lens[b] - kpos < window``
    (window > 0), fold in the active token, soft-cap and sink, softmax in
    fp32."""
    b, hq, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    g = hq // hkv
    k, v = k.float(), v.float()
    if kv_scale is not None:
        k = k * kv_scale
        v = v * kv_scale
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k) * scale
    sa = torch.einsum("bhgd,bhd->bhg", qf, new_k.float())[..., None] * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
        sa = soft_cap * torch.tanh(sa / soft_cap)
    kpos = torch.arange(n, device=q.device)[None, :]
    pos = lens.long()[:, None]
    valid = kpos < pos
    if window > 0:
        valid &= (pos - kpos) < window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    cols = [s, sa]
    if sink is not None:
        cols.append(sink.float().reshape(1, hkv, g, 1).expand(b, hkv, g, 1))
    scores = torch.cat(cols, dim=-1)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p[..., :n], v)
    out = out + p[..., n:n + 1] * new_v.float()[:, :, None, :]
    return out.reshape(b, hq, d).to(q.dtype)


def _check_common(q, hkv, cache_d, cache_dtype, n_layers, new_k, new_v,
                  layer, lens, sink, tensors):
    """Raise on anything either kernel (and so its twin's contract) does
    not take: dtype, shape, device or layout of the inputs both share."""
    b, hq, d = q.shape
    if cache_d != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS} and match "
                         f"the cache (q {d}, cache {cache_d})")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in _ACT_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {_ACT_DTYPES}")
    if cache_dtype not in _PAGE_DTYPES:
        raise ValueError(f"cache dtype {cache_dtype} not in "
                         f"{tuple(_PAGE_DTYPES)}")
    for name, t in (("new_k", new_k), ("new_v", new_v)):
        if t.shape != (b, hkv, d) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be (B, Hkv, D) = {(b, hkv, d)} "
                             f"in q's dtype {q.dtype}")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError("lens must be (B,) int32")
    if sink is not None and (sink.shape != (hq,)
                             or sink.dtype != torch.float32):
        raise ValueError("sink must be (Hq,) float32")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"layer {layer} outside the {n_layers} cached "
                         "layers")
    tensors = [q, new_k, new_v, lens, *tensors]
    if sink is not None:
        tensors.append(sink)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _kernel_fn(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load(name), "nxdi_" + name)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * n_ptrs + [i] * n_ints + [f] * 3 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def group_chunks(g: int) -> int:
    """Blocks a KV head's group of ``g`` query heads takes in both
    kernels: chunks of at most ``MAX_GROUP`` heads (the rows of one mma
    tile), on the grid's second axis beside the KV heads."""
    return -(-g // MAX_GROUP)


def counters_per_row(hkv: int, g: int) -> int:
    """Merge counters (:func:`merge_counters`) a row takes in both
    kernels: one per (KV head, chunk of its group of ``g``)."""
    return hkv * group_chunks(g)


def scratch_layout(batch: int, hkv: int, g: int, head_dim: int,
                   splits: int):
    """Sizes, in fp32 elements, of the split-K scratch of both kernels: the
    accumulators (B, Hkv, splits, G, D), then (m, l) per head (B, Hkv,
    splits, G, 2). Returns (n_acc, n_ml)."""
    n_acc = batch * hkv * splits * g * head_dim
    return n_acc, 2 * n_acc // head_dim


_COUNTERS = {}
_MIN_COUNTERS = 4096         # (row, KV head, chunk): batch 512 at Hkv 8
_PINNED = set()              # devices whose buffer a captured graph holds


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches``, or
    ``wrapper.captured`` while the current stream is being captured into
    a CUDA graph (the graph launches it at each replay)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def pin_merge_counters(device, n: int) -> None:
    """Allocate the merge counters for ``n`` (row, KV head, chunk) and pin
    them: a captured CUDA graph keeps the buffer's address, so a later
    call that needs a larger buffer raises instead of moving it. The graph
    cache pins at the largest batch bucket before its first capture."""
    merge_counters(_device_key(device), n)
    _PINNED.add(_device_key(device))


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """The fused decode kernels' arrival counters, one int32 per (row, KV
    head, group chunk): a zeroed buffer cached per device, at least ``n``
    long, shared by the paged and the contiguous kernel. A kernel's
    merging block puts
    each counter back to 0, so the buffer stays zeroed from launch to
    launch (CUDA-graph replays included) and a call launches no memset.
    Both kernels run on one stream, one launch after the other, and each
    leaves the buffer zeroed, so sharing it is safe; one stream at a time
    may run them on a device. Allocated once at the first call (before any
    graph capture, which has warm-up calls) and grown only for a larger
    batch."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if device in _PINNED or (device.type == "cuda" and
                                 torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"the decode kernels' merge counters on {device} would grow "
                f"to {n} entries after a CUDA-graph capture pinned them at "
                f"{0 if buf is None else buf.numel()}: capture after a call "
                "at the largest batch (pin_merge_counters)")
        buf = torch.zeros(max(n, _MIN_COUNTERS), dtype=torch.int32,
                          device=device)
        _COUNTERS[device] = buf
    return buf


def _split_k(wrapper, fn, q, hkv, splits, cache_ptrs, ints, sink, cache,
             *, scale, soft_cap, kv_scale):
    """Allocate the output and the split-K scratch (:func:`scratch_layout`),
    launch on the current stream, raise on a non-zero return, count the
    launch on ``wrapper``. The merge counters (:func:`merge_counters`,
    :func:`counters_per_row` a row) go to the kernel right after the
    scratch."""
    if cache[0].data_ptr() % 16 or cache[1].data_ptr() % 16:
        raise ValueError("the kernel reads the cache in 16-byte vectors: "
                         "the K and V caches must be 16-byte aligned")
    b, hq, d = q.shape
    out = torch.empty_like(q)
    n_acc, n_ml = scratch_layout(b, hkv, hq // hkv, d, splits)
    scratch = torch.empty(n_acc + n_ml, dtype=torch.float32, device=q.device)
    counters = merge_counters(q.device,
                              b * counters_per_row(hkv, hq // hkv))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), *cache_ptrs,
                sink.data_ptr() if sink is not None else None,
                scratch.data_ptr(), scratch.data_ptr() + 4 * n_acc,
                counters.data_ptr(),
                out.data_ptr(), *ints, float(scale),
                float(soft_cap) if soft_cap is not None else 0.0,
                float(kv_scale) if kv_scale is not None else 1.0,
                _PAGE_DTYPES[cache[0].dtype], int(q.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed "
                           f"(cudaError {rc})")
    count_launch(wrapper)
    return out


def _splits(want: int, keys: int, head_dim: int) -> int:
    """Blocks per (row, KV head) of a split-K kernel: ``want``, but no more
    than a row of ``keys`` has key tiles (4096 / head_dim keys each), nor
    than 64, nor fewer than 1. From shapes only, so a wrapper never waits
    on the device for ``lens``."""
    tiles = -(-keys // (4096 // head_dim))
    return max(1, min(want, tiles, _MAX_SPLITS))


# -- fake tensors ----------------------------------------------------------

_work_listeners: List[Callable[[str, int, int], None]] = []


@contextlib.contextmanager
def kernel_work_listener(fn: Callable[[str, int, int], None]):
    """While open, ``fn(kernel name, flops, bytes)`` hears every wrapper
    call on fake tensors (this module's and ``flash_attention``'s)."""
    _work_listeners.append(fn)
    try:
        yield
    finally:
        _work_listeners.remove(fn)


def fake_result(name: str, work: Callable[..., Tuple[int, int]],
                out_like: torch.Tensor, *args, **kw) -> torch.Tensor:
    """A kernel wrapper's call on fake tensors: an empty (fake) output
    shaped like ``out_like``, contiguous; ``work(*args, **kw)`` (flops,
    bytes) goes to every open :func:`kernel_work_listener`."""
    if _work_listeners:
        flops, nbytes = work(*args, **kw)
        for fn in _work_listeners:
            fn(name, flops, nbytes)
    return torch.empty_like(out_like, memory_format=torch.contiguous_format)


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def _live_keys(capacity: int, window: int) -> int:
    return min(capacity, window - 1) if window > 0 else capacity


def paged_decode_work(q, k_pages, v_pages, new_k, new_v, layer, lens,
                      block_table, *, window=0, sink=None, **_
                      ) -> Tuple[int, int]:
    """(flops, bytes) of one :func:`paged_decode_attention` call, the
    formula of its bound in PERF.md, at the call's capacity (a static
    graph knows no lengths): every row reads the keys its block table
    holds, inside the window; QK and PV over them and the active token."""
    b, hq, d = q.shape
    bs, hkv = k_pages.shape[2], k_pages.shape[3]
    live = _live_keys(block_table.shape[1] * bs, int(window))
    flops = 4 * (b * live + b) * hq * d
    nbytes = (2 * b * live * hkv * d * k_pages.element_size()
              + (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
              + 4 * b + 4 * b * -(-live // bs)
              + (4 * hq if sink is not None else 0))
    return flops, nbytes


def stacked_decode_work(q, k_cache, v_cache, new_k, new_v, layer, lens, *,
                        window=0, sink=None, **_) -> Tuple[int, int]:
    """(flops, bytes) of one :func:`decode_attention_stacked` call, as
    :func:`paged_decode_work`: every row reads its whole cache row, inside
    the window."""
    b, hq, d = q.shape
    hkv, s_len = k_cache.shape[2], k_cache.shape[4]
    live = _live_keys(s_len, int(window))
    flops = 4 * (b * live + b) * hq * d
    nbytes = (2 * b * live * hkv * d * k_cache.element_size()
              + (2 * b * hq * d + 2 * b * hkv * d) * q.element_size()
              + 4 * b + (4 * hq if sink is not None else 0))
    return flops, nbytes


def _device_check(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, new_k: torch.Tensor,
                                 new_v: torch.Tensor, layer: int,
                                 lens: torch.Tensor,
                                 block_table: torch.Tensor, *, scale: float,
                                 window: int = 0,
                                 soft_cap: Optional[float] = None,
                                 sink: Optional[torch.Tensor] = None,
                                 kv_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain-PyTorch twin of the paged kernel: gather the row's pages, then
    the shared math (mask ``kpos < lens[b]`` and the window, fold in the
    active token, soft-cap and sink, softmax in fp32)."""
    b = q.shape[0]
    _, _, bs, hkv, d = k_pages.shape
    mb = block_table.shape[1]
    tbl = block_table.long()

    def rows(pages):                    # (B, Hkv, mb * Bs, D)
        return pages[layer][tbl].reshape(b, mb * bs, hkv, d).transpose(1, 2)
    return _plain(q, rows(k_pages), rows(v_pages), new_k, new_v, lens,
                  scale=scale, window=window, soft_cap=soft_cap, sink=sink,
                  kv_scale=kv_scale)


def num_splits(batch: int, hkv: int, max_blocks: int, block_size: int,
               head_dim: int, group: int = 1) -> int:
    """Blocks per (row, KV head, group chunk) of the paged kernel: about
    four blocks on each of the H100's 132 SMs (rounded down), a chunk
    counted as a head, within :func:`_splits`'s bounds over the table's
    ``max_blocks * block_size`` keys."""
    return _splits(_PAGED_TARGET_BLOCKS
                   // (batch * hkv * group_chunks(group)),
                   max_blocks * block_size, head_dim)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, layer: int,
                           lens: torch.Tensor, block_table: torch.Tensor, *,
                           scale: float, window: int = 0,
                           soft_cap: Optional[float] = None,
                           sink: Optional[torch.Tensor] = None,
                           kv_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k_pages/v_pages (L, N, Bs, Hkv, D); new_k/new_v
    (B, Hkv, D); ``layer`` python int; lens (B,) int32 prior lengths;
    block_table (B, max_blocks) int32 (entry 0 = null page). Returns
    (B, Hq, D) in q's dtype.

    CUDA tensors launch ``csrc/paged_decode_attention.cu`` (one launch:
    the split-K partials and their merge, through the counters of
    :func:`merge_counters`) on the current stream and add one to
    ``paged_decode_attention.launches`` (``.captured`` inside a CUDA-graph
    capture); CPU tensors
    run the plain twin. The caller keeps ``lens[b]`` within the row's table
    (the kernel indexes ``block_table[b, kpos // Bs]`` for every live
    ``kpos``)."""
    if q.dim() != 3 or k_pages.dim() != 5:
        raise ValueError("q must be (B, Hq, D) and pages (L, N, Bs, Hkv, D)")
    b = q.shape[0]
    L, n_pages, bs, hkv, d = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.dtype != torch.int32):
        raise ValueError("block_table must be (B, max_blocks) int32")
    _check_common(q, hkv, d, k_pages.dtype, L, new_k, new_v, layer, lens,
                  sink, [k_pages, v_pages, block_table])
    kw = dict(scale=scale, soft_cap=soft_cap, kv_scale=kv_scale)
    if is_fake(q):
        return fake_result("paged_decode_attention", paged_decode_work, q,
                           q, k_pages, v_pages, new_k, new_v, layer, lens,
                           block_table, window=window, sink=sink)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, new_k, new_v, int(layer), lens, block_table,
            window=int(window), sink=sink, **kw)
    _device_check(q)
    g, mb = q.shape[1] // hkv, block_table.shape[1]
    splits = num_splits(b, hkv, mb, bs, d, g)
    return _split_k(
        paged_decode_attention, _kernel_fn("paged_decode_attention", 12, 10),
        q, hkv, splits,
        [k_pages.data_ptr(), v_pages.data_ptr(), new_k.data_ptr(),
         new_v.data_ptr(), lens.data_ptr(), block_table.data_ptr()],
        [b, int(layer), n_pages, bs, hkv, g, d, mb, splits, int(window)],
        sink, (k_pages, v_pages), **kw)


paged_decode_attention.launches = 0
paged_decode_attention.captured = 0


# ---------------------------------------------------------------------------
# Contiguous cache
# ---------------------------------------------------------------------------

def decode_attention_stacked_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, new_k: torch.Tensor,
                                   new_v: torch.Tensor, layer: int,
                                   lens: torch.Tensor, *, scale: float,
                                   window: int = 0,
                                   soft_cap: Optional[float] = None,
                                   sink: Optional[torch.Tensor] = None,
                                   kv_scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain-PyTorch twin of the contiguous kernel: the shared math over
    layer ``layer`` of the cache (K read through a transposed view)."""
    return _plain(q, k_cache[layer].transpose(2, 3), v_cache[layer], new_k,
                  new_v, lens, scale=scale, window=window, soft_cap=soft_cap,
                  sink=sink, kv_scale=kv_scale)


def contiguous_num_splits(batch: int, hkv: int, seq_len: int,
                          head_dim: int, group: int = 1) -> int:
    """Blocks per (row, KV head, group chunk) of the contiguous kernel:
    about two blocks on each of the H100's 132 SMs (rounded down, one
    resident wave), a chunk counted as a head, within :func:`_splits`'s
    bounds over a cache row's ``seq_len`` keys."""
    return _splits(_CONTIG_TARGET_BLOCKS
                   // (batch * hkv * group_chunks(group)), seq_len,
                   head_dim)


def decode_attention_stacked(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, new_k: torch.Tensor,
                             new_v: torch.Tensor, layer: int,
                             lens: torch.Tensor, *, scale: float,
                             window: int = 0,
                             soft_cap: Optional[float] = None,
                             sink: Optional[torch.Tensor] = None,
                             kv_scale: Optional[float] = None
                             ) -> torch.Tensor:
    """q (B, Hq, D); k_cache (L, B, Hkv, D, S) transposed, v_cache (L, B,
    Hkv, S, D); new_k/new_v (B, Hkv, D); ``layer`` python int; lens (B,)
    int32 prior lengths, each at most S. Returns (B, Hq, D) in q's dtype.

    CUDA tensors launch ``csrc/decode_attention.cu`` (one launch: the
    split-K partials and their merge, through the counters of
    :func:`merge_counters`) on the current stream and add one to
    ``decode_attention_stacked.launches``; CPU tensors run
    :func:`decode_attention_stacked_plain`."""
    if q.dim() != 3 or k_cache.dim() != 5:
        raise ValueError("q must be (B, Hq, D) and k_cache (L, B, Hkv, D, S)")
    b = q.shape[0]
    L, bc, hkv, d, s_len = k_cache.shape
    if bc != b:
        raise ValueError(f"the query batch {b} must equal the cache batch "
                         f"{bc} (rows are addressed by index)")
    if (v_cache.shape != (L, b, hkv, s_len, d)
            or v_cache.dtype != k_cache.dtype):
        raise ValueError("v_cache must be (L, B, Hkv, S, D) in k_cache's "
                         "dtype")
    _check_common(q, hkv, d, k_cache.dtype, L, new_k, new_v, layer, lens,
                  sink, [k_cache, v_cache])
    kw = dict(scale=scale, soft_cap=soft_cap, kv_scale=kv_scale)
    if is_fake(q):
        return fake_result("decode_attention_stacked", stacked_decode_work,
                           q, q, k_cache, v_cache, new_k, new_v, layer,
                           lens, window=window, sink=sink)
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(
            q, k_cache, v_cache, new_k, new_v, int(layer), lens,
            window=int(window), sink=sink, **kw)
    _device_check(q)
    splits = contiguous_num_splits(b, hkv, s_len, d, q.shape[1] // hkv)
    return _split_k(
        decode_attention_stacked, _kernel_fn("decode_attention", 11, 8),
        q, hkv, splits,
        [k_cache.data_ptr(), v_cache.data_ptr(), new_k.data_ptr(),
         new_v.data_ptr(), lens.data_ptr()],
        [b, int(layer), hkv, q.shape[1] // hkv, d, s_len, splits,
         int(window)],
        sink, (k_cache, v_cache), **kw)


decode_attention_stacked.launches = 0
decode_attention_stacked.captured = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, lens: torch.Tensor, *,
                     scale: float, window: int = 0,
                     soft_cap: Optional[float] = None,
                     sink: Optional[torch.Tensor] = None,
                     kv_scale: Optional[float] = None) -> torch.Tensor:
    """Single-layer entry: k_cache (B, Hkv, D, S) transposed, v_cache (B,
    Hkv, S, D); otherwise as :func:`decode_attention_stacked`."""
    return decode_attention_stacked(
        q, k_cache[None], v_cache[None], new_k, new_v, 0, lens, scale=scale,
        window=window, soft_cap=soft_cap, sink=sink, kv_scale=kv_scale)


def supports(spec, phase_t: int) -> bool:
    """Kernel admission for both kernels (counterpart:
    decode_attention.py:588-595): a single active token, no MLA (its K
    and V heads differ in width; both kernels stream them at one), no
    chunked attention (the kernels mask by window, not by chunk; the
    counterpart's ``attn_chunk == 0``), no ALiBi (the kernels add no
    position bias; the counterpart keeps ``not spec.alibi`` beside each
    call of its gate, model_base.py:1072, :1177) and head_dim 64 or 128.
    Any GQA group, as the counterpart's gate: a group over ``MAX_GROUP``
    query heads takes :func:`group_chunks` blocks per KV head and split,
    in the same one launch."""
    return (phase_t == 1 and spec.mla is None
            and spec.attn_chunk == 0 and not spec.alibi
            and spec.head_dim in _HEAD_DIMS)


def quantized_cache_ok(cache_dtype: torch.dtype) -> bool:
    """Cache dtypes the kernels stream (counterpart: the Mosaic probe at
    decode_attention.py:599; on sm_90 it is a plain dtype check)."""
    return cache_dtype in _PAGE_DTYPES
