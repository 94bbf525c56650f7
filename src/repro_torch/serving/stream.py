"""Per-request incremental token delivery for the serving engine.

``ServeEngine.submit`` registers a ``StreamState`` per request;
``ServeEngine.stream(rid)`` hands out ``TokenStream`` views over it. The
engine never copies tokens into a side buffer: a stream reads straight
out of ``Request.output`` behind a cursor, so delivered tokens are
bit-identical to what ``run()`` returns by construction — the stream
surface changes *when* a consumer sees a token, never *what* the token
is (regression-tested across the paged x SPx x spec x cb matrix).

Two consumption modes over the same state:

* **sync** (``for tok in engine.stream(rid)``): when the cursor catches
  up with the emitted output, ``__next__`` drives ``engine.step()``
  itself until the next token lands — a self-clocking drain loop that
  interleaves every other resident request's progress.
* **async** (``async for tok in engine.stream(rid)``): ``__anext__``
  parks on a per-stream ``asyncio.Event`` that the engine sets after
  every tick and on every terminal transition. Something else — the
  asyncio front-end in ``launch/serve.py`` — must be ticking the
  engine; the stream itself never steps, so arrival, compute and
  delivery overlap on one event loop.

Terminal states are explicit so consumers never hang: ``finish`` (normal
completion -> StopIteration), ``cancel`` (``engine.cancel(rid)`` ->
``StreamCancelled``), ``fail`` (``run(strict=True)`` died undrained ->
``StreamError`` carrying the engine error).
"""
from __future__ import annotations

__all__ = ["StreamCancelled", "StreamError", "StreamState", "TokenStream"]

#: ticks a dry sync stream will drive without the request finishing or
#: emitting before giving up — the same runaway guard run(max_steps) has
_MAX_IDLE_STEPS = 10_000

LIVE = "live"
DONE = "done"
CANCELLED = "cancelled"
ERROR = "error"


class StreamCancelled(Exception):
    """The request behind this stream was cancelled mid-flight."""


class StreamError(Exception):
    """The engine died with this request still live (undrained strict
    run); ``__cause__`` carries the engine's error."""


class StreamState:
    """Engine-side delivery state for one submitted Request: a terminal
    status machine plus the asyncio wakeup fan-out. One per Request
    *object* — resubmitting a rid after cancellation binds a fresh
    state, and streams opened on the old one stay terminal."""

    __slots__ = ("req", "status", "error", "_events")

    def __init__(self, req):
        self.req = req
        self.status = LIVE
        self.error: BaseException | None = None
        self._events: list = []         # one asyncio.Event per waiter

    # -- terminal transitions (engine-side) -----------------------------------

    def finish(self):
        if self.status == LIVE:
            self.status = DONE
        self.notify()

    def cancel(self):
        if self.status == LIVE:
            self.status = CANCELLED
        self.notify()

    def fail(self, exc: BaseException):
        if self.status == LIVE:
            self.status = ERROR
            self.error = exc
        self.notify()

    def notify(self):
        """Wake every async waiter (the engine calls this once per tick;
        sync consumers poll and never register an event)."""
        for ev in self._events:
            ev.set()

    def register_event(self, ev):
        self._events.append(ev)

    def unregister_event(self, ev):
        if ev in self._events:
            self._events.remove(ev)


class TokenStream:
    """One consumer's view of a request's emitted tokens. Iteration
    yields every token exactly once in emission order; multiple streams
    over the same rid each see the full sequence (independent cursors
    over the same ``Request.output``)."""

    def __init__(self, engine, state: StreamState):
        self._engine = engine
        self._state = state
        self._cursor = 0

    @property
    def rid(self) -> int:
        return self._state.req.rid

    def _pop(self):
        """The next undelivered token, or None when the cursor is caught
        up with emission."""
        out = self._state.req.output
        if self._cursor < len(out):
            tok = int(out[self._cursor])
            self._cursor += 1
            return tok
        return None

    def _raise_terminal(self):
        st = self._state
        if st.status == CANCELLED:
            raise StreamCancelled(
                f"request {st.req.rid} was cancelled after "
                f"{len(st.req.output)} token(s)")
        if st.status == ERROR:
            raise StreamError(
                f"request {st.req.rid}: engine error with the request "
                f"still live") from st.error
        raise StopIteration                  # DONE

    # -- sync: the stream drives the engine -----------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> int:
        for _ in range(_MAX_IDLE_STEPS):
            tok = self._pop()
            if tok is not None:
                return tok
            if self._state.status != LIVE:
                self._raise_terminal()
            self._engine.step()
        raise RuntimeError(
            f"stream for request {self._state.req.rid}: no token after "
            f"{_MAX_IDLE_STEPS} engine steps — the request cannot make "
            "progress (check pool capacity / scheduler state)")

    # -- async: something else ticks the engine -------------------------------

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        import asyncio
        ev = asyncio.Event()
        self._state.register_event(ev)
        try:
            while True:
                tok = self._pop()
                if tok is not None:
                    return tok
                if self._state.status != LIVE:
                    try:
                        self._raise_terminal()
                    except StopIteration:
                        raise StopAsyncIteration from None
                ev.clear()
                # re-check before parking: a tick may have landed tokens
                # (or a terminal transition) between _pop and clear
                if (self._cursor < len(self._state.req.output)
                        or self._state.status != LIVE):
                    continue
                await ev.wait()
        finally:
            self._state.unregister_event(ev)

    def poll(self) -> list[int]:
        """Every token emitted since the last poll, without blocking or
        driving the engine — the delivery loop for callers that tick the
        engine themselves (the streaming benchmark). Empty list when the
        cursor is caught up OR the stream is terminal; check
        ``finished`` to tell them apart."""
        out = []
        while True:
            tok = self._pop()
            if tok is None:
                return out
            out.append(tok)

    @property
    def finished(self) -> bool:
        """True once the stream can never yield another token."""
        return (self._state.status != LIVE
                and self._cursor >= len(self._state.req.output))

    def drain(self) -> list[int]:
        """Collect every remaining token synchronously (drives the
        engine). Convenience for tests and benchmarks."""
        return list(self)
