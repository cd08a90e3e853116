"""Per-request token streams — the delivery half of the serving engine (a
copy of ``neuronx_distributed_inference_tpu/serving/engine/streams.py``).

A :class:`TokenStream` is created at submit time and handed to the caller
before any device work happens. The scheduler is the only producer
(:meth:`TokenStream.put` / :meth:`TokenStream.finish`); consumers read
either synchronously (:meth:`TokenStream.drain`, the closed-loop bench and
tests) or asynchronously (``async for tok in stream``, the SSE front end).
Producer and async consumer are expected to share one asyncio event loop
(the front end runs the scheduler as a task on its own loop), so plain
``asyncio.Event`` signalling suffices — no cross-thread machinery.

Backpressure is cooperative: the stream only REPORTS its unread depth
(:attr:`TokenStream.unread`); the scheduler stops stepping a sequence whose
consumer lags past ``max_unread_tokens`` and resumes once the consumer
catches up. Tokens are never dropped.

Cancellation is edge-triggered from either side: the engine's ``cancel()``
(or the front end noticing a dead client socket) finishes the stream with
reason ``"cancelled"`` and a typed :class:`~...resilience.errors.Cancelled`
error, after the engine has released the sequence and reclaimed its KV
blocks. Tokens delivered before the cancel stay valid.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, List, Optional

from ...resilience.errors import Cancelled

__all__ = ["TokenStream"]

#: Stream finish reasons (``TokenStream.finish_reason``):
#:   ``length``    — max_new_tokens generated
#:   ``stop``      — a stop token was generated (it IS delivered)
#:   ``deadline``  — per-request wall-clock budget blew (in queue or running)
#:   ``cancelled`` — explicit cancel or client gone
#:   ``capacity``  — the compiled seq_len cannot hold another token
#:   ``error``     — unrecoverable engine/device failure (see ``error``)
FINISH_REASONS = ("length", "stop", "deadline", "cancelled", "capacity",
                  "error")


class TokenStream:
    """One request's ordered token stream plus terminal status."""

    def __init__(self, request_id: str, tenant: str = ""):
        self.request_id = request_id
        self.tenant = tenant
        self._tokens: List[int] = []
        self._cursor = 0              # consumer position (drain/aiter)
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._event: Optional[asyncio.Event] = None
        self._cancel_cb: Optional[Callable[[], Any]] = None

    # -- producer side (scheduler only) ------------------------------------
    def put(self, token: int) -> None:
        if self.finish_reason is not None:
            return                    # late token after cancel/expiry: drop
        self._tokens.append(int(token))
        self._wake()

    def finish(self, reason: str,
               error: Optional[BaseException] = None) -> None:
        """Terminal transition; idempotent (first reason wins)."""
        if self.finish_reason is None:
            self.finish_reason = reason
            self.error = error
            self._wake()

    # -- consumer side -----------------------------------------------------
    @property
    def tokens(self) -> List[int]:
        """Every token delivered so far (does not move the cursor)."""
        return list(self._tokens)

    @property
    def n_tokens(self) -> int:
        """Count of delivered tokens — O(1); the scheduler's per-token
        budget checks use this instead of copying ``tokens``."""
        return len(self._tokens)

    def tokens_from(self, start: int) -> List[int]:
        """Tokens from index ``start`` on, without copying the whole
        stream (the fleet router's per-pass pump reads only the new
        tail; does not move the consumer cursor)."""
        return self._tokens[start:]

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    @property
    def unread(self) -> int:
        """Delivered tokens the consumer has not drained/iterated yet —
        the scheduler's backpressure signal."""
        return len(self._tokens) - self._cursor

    def drain(self) -> List[int]:
        """Synchronously take every not-yet-consumed token."""
        out = self._tokens[self._cursor:]
        self._cursor = len(self._tokens)
        return out

    def cancel(self) -> None:
        """Ask the engine to cancel this request (release the sequence,
        reclaim blocks). No-op once finished."""
        if self.finish_reason is None and self._cancel_cb is not None:
            self._cancel_cb()

    def cancelled_error(self) -> Cancelled:
        return Cancelled(f"request {self.request_id} was cancelled")

    # -- async iteration ---------------------------------------------------
    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._cursor < len(self._tokens):
                tok = self._tokens[self._cursor]
                self._cursor += 1
                return tok
            if self.finish_reason is not None:
                raise StopAsyncIteration
            await self._wait()

    async def iter_from(self, start: int = 0):
        """Async-iterate tokens from index ``start`` with a PRIVATE
        cursor, then follow the live stream — safe for multiple
        concurrent consumers (replay attaches), unlike ``__anext__``
        whose shared cursor feeds each token to exactly one reader. The
        shared cursor is advanced as a high-water mark so backpressure
        still sees the farthest-ahead consumer."""
        i = start
        while True:
            if i < len(self._tokens):
                tok = self._tokens[i]
                i += 1
                self._cursor = max(self._cursor, i)
                yield tok
                continue
            if self.finish_reason is not None:
                return
            await self._wait()

    async def wait_finished(self) -> str:
        """Block until the stream is terminal; returns the finish reason
        (tokens may still be undrained)."""
        while self.finish_reason is None:
            await self._wait()
        return self.finish_reason

    # -- signalling --------------------------------------------------------
    def _wake(self) -> None:
        if self._event is not None:
            self._event.set()

    async def _wait(self) -> None:
        if self._event is None:
            self._event = asyncio.Event()
        self._event.clear()
        # re-check after clear: a put() between the cursor check and here
        # already set the (fresh) event or appended a token
        if self._cursor < len(self._tokens) or self.finish_reason is not None:
            return
        await self._event.wait()
