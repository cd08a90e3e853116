"""Rank 0's dispatch records over a mesh: one fixed frame a step, a
header of int64s with the step's host arrays inline, broadcast into each
follower's static buffer (the applications' ``_dispatched`` steps and
``follow()`` loop).

A record is a step's name and its arguments. Its *schema* is everything
but the numbers that change from step to step: the name, the argument
tree with its other Python values in place, and each array's kind (numpy
array or scalar, host tensor, device tensor), dtype and rank. Rank 0
numbers a schema the first time it sends one, and only then pickles it
(one ``broadcast_object_list``). A record then costs one broadcast of the
frame, ``FRAME`` int64s:

  * the header, its first ``HEADER``: the code, the schema's number, the
    host and device payloads' byte counts, each array's dims, then each
    int and float argument (a float by its bits);
  * the host arrays' bytes (numpy and host tensors), inline after the
    header; a host payload over the frame's room goes in a second
    broadcast;
  * and, when the record has device tensors, their bytes in one more
    broadcast on the rank's device: a device tensor goes from device to
    device, never through the host.

Over NCCL the frame travels through the rank's device (NCCL moves device
memory only), and the followers copy it back once; over gloo it stays on
the host. Followers receive into buffers they keep (``Channel``) and hand
the step copies of their slices, so that no step holds a buffer the next
record overwrites. A record whose dims and numbers do not fit the header,
or that holds an array torch cannot view as bytes, raises
:class:`ConfigurationError`.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..resilience.errors import ConfigurationError
from . import collectives

HEADER = 256
FRAME = 2048                  # 16 KiB: the header and 14 KiB of host bytes
ROOM = (FRAME - HEADER) * 8   # the frame's bytes for the host arrays
# header codes
RECORD, NEW_SCHEMA, STOP = 0, 1, 2
_ALIGN = 8


class _Leaf:
    """The place of the record's ``index``-th array or number in its
    schema's argument tree."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def _split(obj, leaves: List[Any], meta: List[Tuple]):
    """``obj`` with every array and number replaced by a :class:`_Leaf`;
    the arrays and numbers go to ``leaves``, their (kind, dtype, ndim) to
    ``meta``."""
    if isinstance(obj, torch.Tensor):
        kind = "h" if obj.device.type == "cpu" else "d"
        meta.append((kind, str(obj.dtype), obj.dim()))
    elif isinstance(obj, np.ndarray):
        meta.append(("n", obj.dtype.str, obj.ndim))
    elif isinstance(obj, np.generic):
        meta.append(("s", obj.dtype.str, 0))
    elif isinstance(obj, bool) or obj is None:
        return obj
    elif isinstance(obj, int):
        meta.append(("i", None, 0))
    elif isinstance(obj, float):
        meta.append(("f", None, 0))
    elif isinstance(obj, (list, tuple)):
        return type(obj)(_split(v, leaves, meta) for v in obj)
    elif isinstance(obj, dict):
        return {k: _split(v, leaves, meta) for k, v in obj.items()}
    else:
        return obj
    leaves.append(obj)
    return _Leaf(len(leaves) - 1)


def _join(obj, leaves: List[Any]):
    if isinstance(obj, _Leaf):
        return leaves[obj.index]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_join(v, leaves) for v in obj)
    if isinstance(obj, dict):
        return {k: _join(v, leaves) for k, v in obj.items()}
    return obj


def _bytes_of(x) -> torch.Tensor:
    """A flat uint8 view of an array's bytes, padded to ``_ALIGN``."""
    if isinstance(x, (np.ndarray, np.generic)):
        try:
            x = torch.from_numpy(np.ascontiguousarray(x))
        except TypeError as e:
            raise ConfigurationError(
                f"a dispatch record cannot carry a {x.dtype} array") from e
    flat = x.detach().contiguous().reshape(-1)
    if flat.numel() and flat.stride(0) != 1:
        # a one-element view keeps a broadcast stride through
        # ``contiguous()``: a byte view needs stride 1
        flat = flat.clone(memory_format=torch.contiguous_format)
    b = flat.view(torch.uint8)
    pad = -b.numel() % _ALIGN
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b


def _np_dtype_to_torch(dtype_str: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype_str))).dtype


class Channel:
    """One rank's end of the dispatch records over every rank of
    ``mesh`` (its world group: every dp and cp replica receives rank 0's
    frame, and takes its own rows from the record): rank 0 sends
    (:meth:`send`, :meth:`stop`), the others receive (:meth:`recv`).
    ``schemas`` counts the schemas sent (each pickled once),
    ``broadcasts`` the frames and payloads."""

    def __init__(self, mesh):
        self.mesh = mesh
        # the frame's device: NCCL moves device memory only
        self.wire = (mesh.device if mesh.backend == "nccl"
                     else torch.device("cpu"))
        self.frame = torch.zeros(FRAME, dtype=torch.int64, device=self.wire)
        self._ids: dict = {}
        self._schemas: List[Tuple] = []
        self._bufs: dict = {}
        self.schemas = 0
        self.broadcasts = 0

    # -- the wire ----------------------------------------------------------
    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=self.mesh.src, group=self.mesh.world_group)
        self.broadcasts += 1
        return t

    def _buffer(self, key: str, n: int, device) -> torch.Tensor:
        """A receive buffer of at least ``n`` bytes (grown, never
        shrunk)."""
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 2 * (0 if buf is None
                                          else buf.numel())),
                              dtype=torch.uint8, device=device)
            self._bufs[key] = buf
        return buf[:n]

    def _send_frame(self, head, host_b=None) -> None:
        """Broadcast the frame: ``head`` (code first) and, when they fit,
        the host bytes ``host_b``."""
        frame = torch.zeros(FRAME, dtype=torch.int64)
        frame[:len(head)] = torch.tensor(head, dtype=torch.int64)
        if host_b is not None and host_b.numel() <= ROOM:
            frame.view(torch.uint8)[HEADER * 8:HEADER * 8
                                    + host_b.numel()] = host_b
        self._bcast(self.frame.copy_(frame))

    # -- rank 0 -------------------------------------------------------------
    def send(self, name: str, args: tuple, kw: dict) -> None:
        """Rank 0: send the record of ``name(*args, **kw)``."""
        leaves: List[Any] = []
        meta: List[Tuple] = []
        tree = _split((args, kw), leaves, meta)
        schema = (name, tree, tuple(meta))
        key = pickle.dumps(schema)
        vals: List[int] = []
        host, devs = [], []
        for x, (kind, _, _) in zip(leaves, meta):
            if kind == "i":
                if not -2 ** 63 <= x < 2 ** 63:
                    raise ConfigurationError(
                        f"a dispatch record cannot carry the int {x}")
                vals.append(int(x))
            elif kind == "f":
                vals.append(struct.unpack("<q", struct.pack("<d", x))[0])
            else:
                vals.extend(int(d) for d in np.shape(x))
                (devs if kind == "d" else host).append(_bytes_of(x))
        host_b = torch.cat(host) if host else None
        dev_b = torch.cat(devs) if devs else None
        n_host = 0 if host_b is None else host_b.numel()
        head = [RECORD, self._ids.get(key, len(self._ids)), n_host,
                0 if dev_b is None else dev_b.numel(), *vals]
        if len(head) > HEADER:
            raise ConfigurationError(
                f"{name}'s record needs {len(head)} header values, over "
                f"{HEADER}")
        if key not in self._ids:
            self._ids[key] = head[1]
            head[0] = NEW_SCHEMA
        self._send_frame(head, host_b)
        if head[0] == NEW_SCHEMA:
            collectives.broadcast_object(schema, self.mesh)
            self.schemas += 1
        if n_host > ROOM:
            self._bcast(host_b.to(self.wire))
        if dev_b is not None:
            self._bcast(dev_b)

    def stop(self) -> None:
        """Rank 0: end the followers' loops."""
        self._send_frame([STOP])

    # -- ranks > 0 ----------------------------------------------------------
    def recv(self) -> Optional[Tuple[str, tuple, dict]]:
        """A follower: the next record as (name, args, kw), None at the
        stop."""
        frame = self._bcast(self.frame).cpu()
        head = frame[:HEADER].tolist()
        code = head[0]
        if code == STOP:
            return None
        if code == NEW_SCHEMA:
            self._schemas.append(collectives.broadcast_object(None,
                                                              self.mesh))
        sid, n_host, n_dev = head[1:4]
        name, tree, meta = self._schemas[sid]
        vals = iter(head[4:])
        if n_host > ROOM:
            host = self._bcast(self._buffer("host", n_host, self.wire)).cpu()
        else:
            host = frame.view(torch.uint8)[HEADER * 8:HEADER * 8 + n_host]
        dev = (self._bcast(self._buffer("dev", n_dev, self.mesh.device))
               if n_dev else None)
        leaves, offs = [], {"h": 0, "d": 0}
        for kind, dtype, ndim in meta:
            if kind == "i":
                leaves.append(next(vals))
                continue
            if kind == "f":
                leaves.append(struct.unpack(
                    "<d", struct.pack("<q", next(vals)))[0])
                continue
            shape = [next(vals) for _ in range(ndim)]
            tdt = (_np_dtype_to_torch(dtype) if kind in ("n", "s")
                   else _torch_dtype(dtype))
            side = "d" if kind == "d" else "h"
            buf = dev if side == "d" else host
            size = int(np.prod(shape, dtype=np.int64)) * torch.empty(
                (), dtype=tdt).element_size()
            raw = buf[offs[side]:offs[side] + size]
            offs[side] += size + (-size % _ALIGN)
            t = raw.view(tdt).reshape(shape).clone()
            if kind == "n":
                leaves.append(t.numpy().astype(np.dtype(dtype), copy=False))
            elif kind == "s":
                leaves.append(t.numpy().astype(np.dtype(dtype))[()])
            else:
                leaves.append(t)
        args, kw = _join(tree, leaves)
        return name, args, kw


__all__ = ["Channel", "HEADER", "FRAME", "ROOM", "RECORD", "NEW_SCHEMA",
           "STOP"]
