"""Asyncio HTTP/SSE front door for the serving engine — stdlib only (a
port of ``neuronx_distributed_inference_tpu/serving/engine/frontend.py``;
the fleet router it can front is not ported yet, so ``fleet=`` raises
:class:`ConfigurationError`).

A deliberately small HTTP/1.1 server (``asyncio.start_server``; no
framework dependencies, mirroring the repo-wide no-deps rule) exposing the
engine's submit / stream / cancel / metrics surface:

  ``POST /v1/generate``
      Body: ``{"prompt": [ints], "max_new_tokens": n, "tenant": "...",
      "priority": 0, "deadline_s": null, "stop_tokens": [],
      "stream": true}``. With ``"stream": true`` (default) the response is
      ``text/event-stream``: one ``data: {"token": t, "index": i}`` event
      per token, then a terminal
      ``data: {"done": true, "reason": "...", "request_id": "..."}``
      event. With ``"stream": false`` the connection blocks and returns
      one JSON body with the full token list.
  ``POST /v1/submit``
      Same body (sans "stream"); returns ``{"request_id": ...}``
      immediately. Attach later via ``GET /v1/stream/<id>``.
  ``GET /v1/stream/<id>``
      SSE attach to a submitted request (replays from token 0, then
      follows live).
  ``POST /v1/cancel/<id>``
      Returns ``{"cancelled": bool}``. Cancelling a queued request costs
      no device work; a running one is released and its blocks reclaimed.
  ``GET /v1/metrics`` (alias ``GET /metrics``)
      Prometheus text exposition of the process-global registry. An
      engine SLO tracker exports its gauges at scrape time.
  ``GET /healthz``
      ``{"ok": true, "queue_depth": n, "running": m}``.
  ``GET /v1/debug/state``
      Post-mortem JSON (schema ``nxdi-debug-state-v1``): engine/adapter
      snapshot (per-tenant queue depths, running/pending ids, block
      occupancy, pipeline depth) plus the flight-recorder tail with its
      drop count. Works with the recorder disabled (empty trace).
  ``GET /v1/debug/trace``
      The flight recorder as Chrome trace-event JSON — save the body and
      open it in ``chrome://tracing`` / Perfetto.
  ``GET /v1/debug/trace/<id>``
      ONE request's trace (``<id>`` = request id or trace id): the
      events carrying its ``trace_id`` — queue, admission, dispatch
      rows, requeues, emission — as Chrome trace JSON; 404 with a typed
      JSON body (``"type": "trace_not_found"``) when nothing matches
      (unknown id / recorder disabled).
  ``GET /v1/debug/memory``
      The live device-memory ledger (schema ``nxdi-memory-ledger-v1``,
      serving/warmup.py): model parameter bytes, the KV pool split by
      block state (reconciling exactly with the adapter's block
      accounting), fragmentation ratio and the admission-headroom
      estimate.

Client-gone behaviour: when an SSE write fails (peer reset / closed), the
front end cancels the request through the engine — blocks are reclaimed
and the stream finishes "cancelled" — so a dead client can never pin KV.

Errors map onto the typed taxonomy: QueueOverflow -> 429,
AdmissionError -> 400, unknown ids -> 404, closed engine -> 503.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

from ...parallel.mesh import refuse_over_mesh
from ...resilience.errors import (AdmissionError, ConfigurationError,
                                  QueueOverflow, ServingError)
from ...telemetry import get_registry
from ...telemetry.trace import get_recorder
from .scheduler import ServingEngine
from .streams import TokenStream

__all__ = ["ServingFrontend"]

_MAX_BODY = 1 << 20                      # 1 MiB request-body cap


class _HttpError(Exception):
    """Typed HTTP failure: every error response body is
    ``{"error": <message>, "type": <stable machine tag>, "status": n}``
    so clients can dispatch on ``type`` instead of parsing prose.
    ``type_`` defaults to the status's generic tag (``not_found``,
    ``bad_request``, ...); raisers pass a more specific one when they
    have it (e.g. ``trace_not_found``)."""

    def __init__(self, status: int, message: str,
                 type_: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.type = type_ or _STATUS_TYPE.get(status, "error")


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 413: "Payload Too Large",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable"}

_STATUS_TYPE = {400: "bad_request", 404: "not_found",
                405: "method_not_allowed", 413: "payload_too_large",
                429: "queue_overflow", 500: "internal_error",
                503: "unavailable"}


class ServingFrontend:
    """Owns the listener socket, the engine's ``run_forever`` task, and
    the per-connection request handlers.

    ``max_retained_streams`` bounds the ``/v1/submit`` stream registry
    (oldest FINISHED streams beyond it are dropped; default 256).
    ``fleet`` (an engine router) raises
    :class:`ConfigurationError`: the fleet layer is not ported yet
    (ROADMAP queue item 12)."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, max_retained_streams: int = 256,
                 fleet=None):
        if max_retained_streams < 1:
            raise ConfigurationError("max_retained_streams must be >= 1")
        if fleet is not None:
            raise ConfigurationError(
                "the PyTorch port does not run a fleet router yet: "
                "fleet= (ROADMAP queue item 12)")
        refuse_over_mesh(getattr(engine.adapter, "app", None),
                         "the HTTP front door")
        self.engine = engine
        self.host = host
        self.port = port
        self.max_retained_streams = max_retained_streams
        self._server: Optional[asyncio.base_events.Server] = None
        self._engine_task: Optional[asyncio.Task] = None
        self._streams: Dict[str, TokenStream] = {}   # submitted via HTTP

    async def start(self) -> Tuple[str, int]:
        """Bind, start serving connections and the engine loop; returns
        the bound (host, port) — port 0 resolves to an ephemeral one."""
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._engine_task = asyncio.ensure_future(self.engine.run_forever())
        return self.host, self.port

    async def stop(self) -> None:
        """Close the listener, stop the engine loop (cancelling all
        outstanding requests), and wait for both to wind down."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.engine.close()
        if self._engine_task is not None:
            await self._engine_task
        self._streams.clear()

    # -- connection handling ----------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, body = await self._read_request(reader)
                await self._route(method, path, body, writer)
            except _HttpError as e:
                await self._send_json(writer, e.status,
                                      {"error": str(e), "type": e.type,
                                       "status": e.status})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                      # client went away mid-exchange
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            raise _HttpError(400, "malformed request line")
        method, path = parts[0].upper(), parts[1]
        length = 0
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                try:
                    length = int(value.strip())
                except ValueError:
                    raise _HttpError(400, "bad Content-Length")
                if length < 0:
                    raise _HttpError(400, "bad Content-Length")
        if length > _MAX_BODY:
            raise _HttpError(413, "request body too large")
        body = await reader.readexactly(length) if length else b""
        return method, path, body

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/healthz" and method == "GET":
            await self._send_json(writer, 200, {
                "ok": not self.engine.closed,
                "queue_depth": self.engine.queue.depth,
                "running": len(self.engine._active)})
        elif path in ("/metrics", "/v1/metrics") and method == "GET":
            # /v1/metrics is the served exposition surface (the bare
            # /metrics alias stays for compatibility): Prometheus text of
            # the process registry
            await self._send_raw(writer, 200, self._metrics_text().encode(),
                                 "text/plain; version=0.0.4")
        elif path == "/v1/debug/state" and method == "GET":
            # live post-mortem: engine/adapter snapshot + flight-recorder
            # tail (events empty while the recorder is disabled)
            await self._send_json(writer, 200, self._debug_payload())
        elif path == "/v1/debug/memory" and method == "GET":
            # live device-memory ledger (serving/warmup.py): model bytes,
            # KV pool by block state, fragmentation, headroom
            await self._send_json(writer, 200, self._memory_payload())
        elif path.startswith("/v1/debug/trace/") and method == "GET":
            # per-request trace: <id> is a request id (resolved through
            # the engine's trace map) or a raw trace id; returns
            # Chrome trace-event JSON filtered to that one request
            await self._send_json(
                writer, 200,
                self._trace_payload(path[len("/v1/debug/trace/"):]))
        elif path == "/v1/debug/trace" and method == "GET":
            # Chrome trace-event JSON — save the body and load it in
            # chrome://tracing or Perfetto
            await self._send_json(writer, 200, get_recorder().to_chrome())
        elif path == "/v1/generate" and method == "POST":
            spec = self._parse_spec(body)
            stream = self._submit(spec)
            if spec.get("stream", True):
                await self._sse(writer, stream)
            else:
                # consume while waiting (not wait_finished + .tokens):
                # under max_unread_tokens backpressure an unconsumed
                # stream would stall its own decode forever
                toks = [tok async for tok in stream]
                await self._send_json(writer, 200, {
                    "request_id": stream.request_id,
                    "tokens": toks, "reason": stream.finish_reason})
        elif path == "/v1/submit" and method == "POST":
            stream = self._submit(self._parse_spec(body))
            self._prune_streams()
            self._streams[stream.request_id] = stream
            await self._send_json(writer, 200,
                                  {"request_id": stream.request_id})
        elif path.startswith("/v1/stream/") and method == "GET":
            stream = self._streams.get(path[len("/v1/stream/"):])
            if stream is None:
                raise _HttpError(404, "unknown request id")
            await self._sse(writer, stream, replay=True)
        elif path.startswith("/v1/cancel/") and method == "POST":
            rid = path[len("/v1/cancel/"):]
            await self._send_json(writer, 200,
                                  {"cancelled": self.engine.cancel(rid)})
        else:
            raise _HttpError(404 if method in ("GET", "POST") else 405,
                             f"no route for {method} {path}")

    # -- engine glue -------------------------------------------------------
    def _metrics_text(self) -> str:
        """The ``GET /v1/metrics`` body: the process-global registry, with
        this engine's SLO gauges exported into it at scrape time."""
        if self.engine.slo is not None:
            self.engine.slo.export(get_registry())
        return get_registry().render_prometheus()

    def _trace_payload(self, key: str) -> Dict[str, Any]:
        """Chrome trace JSON of ONE request's events: ``key`` is a
        request id known to the engine or a literal trace id. 404 when no
        events match — an unknown id and a disabled recorder look the same
        on purpose (neither has a story to tell)."""
        from ...telemetry.request_trace import trace_events
        tid = self.engine.trace_id_of(key) or key
        rec = get_recorder()
        events = trace_events(rec.events(), tid)
        if not events:
            raise _HttpError(404, f"no trace events for {key!r} (unknown "
                                  "id, aged out, or recorder disabled)",
                             type_="trace_not_found")
        payload = rec.to_chrome(events)
        payload["otherData"]["trace_id"] = tid
        return payload

    def _memory_payload(self) -> Dict[str, Any]:
        """The ``GET /v1/debug/memory`` body: this engine's device-memory
        ledger (reconciling exactly with the adapter's block accounting),
        with the gauges refreshed into the global registry at read
        time."""
        from ..warmup import memory_ledger
        return memory_ledger(self.engine.adapter, registry=get_registry())

    def _debug_payload(self) -> Dict[str, Any]:
        """The ``GET /v1/debug/state`` body: the engine post-mortem dump
        (engine/adapter snapshot, warm-up plane, SLO and degradation
        state, flight-recorder tail)."""
        return self.engine.dump_debug_state()

    def _prune_streams(self) -> None:
        """Bound the /v1/submit registry: drop the oldest FINISHED streams
        beyond the cap (dict preserves insertion order), so a long-lived
        server does not retain one token list per request forever.
        Unfinished streams are never dropped — their requests are live."""
        excess = len(self._streams) - self.max_retained_streams + 1
        if excess <= 0:
            return
        for rid in [r for r, s in self._streams.items()
                    if s.finished][:excess]:
            del self._streams[rid]

    def _parse_spec(self, body: bytes) -> Dict[str, Any]:
        try:
            spec = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        if not isinstance(spec, dict):
            raise _HttpError(400, "body must be a JSON object")
        return spec

    def _submit(self, spec: Dict[str, Any]) -> TokenStream:
        try:
            return self.engine.submit(
                spec.get("prompt", ()),
                int(spec.get("max_new_tokens", 16)),
                tenant=str(spec.get("tenant", "default")),
                priority=int(spec.get("priority", 0)),
                deadline_s=spec.get("deadline_s"),
                stop_tokens=spec.get("stop_tokens", ()),
                request_id=spec.get("request_id"))
        except QueueOverflow as e:
            raise _HttpError(429, str(e))
        except AdmissionError as e:
            raise _HttpError(400, str(e))
        except (TypeError, ValueError) as e:
            raise _HttpError(400, f"bad request spec: {e}")
        except ServingError as e:
            raise _HttpError(503, str(e))

    # -- wire formats ------------------------------------------------------
    async def _sse(self, writer: asyncio.StreamWriter, stream: TokenStream,
                   replay: bool = False) -> None:
        """Server-sent events: data-only JSON events, one per token, then
        one terminal done event. A failed write cancels the request."""
        head = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-store\r\n"
                b"Connection: close\r\n\r\n")
        writer.write(head)
        try:
            await writer.drain()
            idx = 0
            # replay attaches iterate a PRIVATE cursor from token 0, so
            # concurrent consumers of one stream each see the full stream
            source = stream.iter_from(0) if replay else stream
            async for tok in source:
                writer.write(self._sse_event(
                    {"token": tok, "index": idx}))
                idx += 1
                await writer.drain()
            done: Dict[str, Any] = {"done": True,
                                    "reason": stream.finish_reason,
                                    "request_id": stream.request_id}
            if stream.error is not None:
                done["error"] = str(stream.error)
            writer.write(self._sse_event(done))
            await writer.drain()
        except (ConnectionError, OSError):
            # client is gone: reclaim the sequence's blocks
            self.engine.cancel(stream.request_id)

    @staticmethod
    def _sse_event(payload: Dict[str, Any]) -> bytes:
        return b"data: " + json.dumps(payload).encode() + b"\n\n"

    async def _send_json(self, writer: asyncio.StreamWriter, status: int,
                         payload: Dict[str, Any]) -> None:
        await self._send_raw(writer, status, json.dumps(payload).encode(),
                             "application/json")

    async def _send_raw(self, writer: asyncio.StreamWriter, status: int,
                        body: bytes, ctype: str) -> None:
        writer.write(
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, '')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
