"""Distributed request tracing: trace/span ids with parent linkage,
monotonic timings, and typed status.

A copy of ``paddle_tpu/observability/tracing.py``. A *trace* is one
request's journey through the ServingEngine's admit->queue->dispatch->
respond ladder, the DecodeEngine's admit->queue->prefill->decode loop,
the fleet router's chunks, and across process boundaries: http_kv
requests carry a compact trace context (``X-Paddle-Trace`` /
``X-Paddle-Span`` hex headers), so a request issued inside a traced
region shows up as a server-side span linked to the caller's tree.

- **Spans are always live, emission is gated off.** Creating a span is
  a few attribute writes; the JSONL step-trace sink the reference
  writes finished spans to (``observability/step_trace.py``) is a later
  port slice, so ``trace_enabled()`` is False and a finished span only
  fixes its duration and typed status. Context still propagates across
  the wire.
- **Typed status.** A span ends ``ok`` or with the error taxonomy name
  that killed it (``DeadlineExceeded``, ``Overloaded``, ...).
- **Deterministic under fake clocks**: every span takes an injectable
  ``clock``.
- **Crash-visible.** Request-root spans register in an in-flight table
  that the flight recorder snapshots into its postmortem.

Stdlib only.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Span", "SpanContext", "current_context", "use_context", "span",
    "new_trace_id", "inflight_snapshot", "trace_enabled",
]

# 63-bit ids: fit a u64 wire field with the sign bit clear, render as
# 16 hex digits. Fully random per id (pids collide in containers, and a
# fixed per-process base caps the varying bits); a live counter is
# folded in so even an exhausted entropy source cannot repeat within a
# process.
_ID_SEQ = itertools.count(1)


def new_trace_id() -> int:
    return ((int.from_bytes(os.urandom(8), "little") + next(_ID_SEQ))
            & 0x7FFFFFFFFFFFFFFF) or 1


_new_span_id = new_trace_id


def _hex(i: Optional[int]) -> Optional[str]:
    return format(i, "016x") if i else None


class SpanContext:
    """Compact propagatable identity: (trace_id, span_id), both 63-bit
    ints. ``to_wire()``/``from_wire()`` are the two-u64 form of a binary
    wire header; ``to_headers()``/``from_headers()`` the http_kv
    form. A zero trace id means "untraced" everywhere."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)

    def to_wire(self) -> Tuple[int, int]:
        return (self.trace_id, self.span_id)

    @staticmethod
    def from_wire(trace_id: int, span_id: int) -> Optional["SpanContext"]:
        if not trace_id:
            return None
        return SpanContext(trace_id, span_id)

    # http_kv propagation: two hex headers, absent = untraced
    TRACE_HEADER = "X-Paddle-Trace"
    SPAN_HEADER = "X-Paddle-Span"

    def to_headers(self) -> Dict[str, str]:
        return {self.TRACE_HEADER: format(self.trace_id, "x"),
                self.SPAN_HEADER: format(self.span_id, "x")}

    @staticmethod
    def from_headers(headers) -> Optional["SpanContext"]:
        raw_t = headers.get(SpanContext.TRACE_HEADER)
        if not raw_t:
            return None
        try:
            trace = int(raw_t, 16)
            sid = int(headers.get(SpanContext.SPAN_HEADER) or "0", 16)
        except ValueError:
            return None
        return SpanContext.from_wire(trace, sid)

    def __repr__(self):
        return f"SpanContext({_hex(self.trace_id)}, {_hex(self.span_id)})"


_CURRENT: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("paddle_torch_trace_context", default=None)


def current_context() -> Optional[SpanContext]:
    """The ambient trace context of this thread/task (None = untraced).
    RPC clients (KVClient) stamp it onto the wire."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]):
    """Make ``ctx`` the ambient context inside the with-block (None
    clears it — e.g. around internal traffic that must not inherit a
    request's identity)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


# -- in-flight request table (flight-recorder postmortems) ----------------
_INFLIGHT: Dict[int, dict] = {}
_INFLIGHT_LOCK = threading.Lock()


def inflight_snapshot() -> List[dict]:
    """Open request-root spans right now — what a crash postmortem
    names as the requests it stranded (trace/span ids + name + start)."""
    with _INFLIGHT_LOCK:
        return [dict(v) for v in _INFLIGHT.values()]


def trace_enabled() -> bool:
    """True when finished spans land in a JSONL sink: never in the port
    (the step-trace sink is a later port slice)."""
    return False


class Span:
    """One timed, linkable operation.

    ``parent`` may be a Span, a SpanContext, or None (None adopts the
    ambient ``current_context()``; pass ``parent=False`` to force a
    root). ``root=True`` registers the span in the in-flight table the
    flight recorder dumps. End with ``end(status)`` or use as a context
    manager (an exception types the status automatically)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "events", "status", "duration_ms", "_clock", "_t0",
                 "_t_epoch", "_root", "_done")

    def __init__(self, name: str, parent=None, clock=None,
                 root: bool = False, **attrs):
        if parent is None:
            parent = current_context()
        elif parent is False:
            parent = None
        if isinstance(parent, Span):
            parent = parent.context()
        self.name = name
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = new_trace_id()
            self.parent_id = 0
        self.span_id = _new_span_id()
        self.attrs: Dict[str, object] = dict(attrs)
        self.events: List[dict] = []
        self.status: Optional[str] = None
        self.duration_ms: Optional[float] = None
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._t_epoch = time.time()
        self._root = bool(root)
        self._done = False
        if self._root:
            with _INFLIGHT_LOCK:
                _INFLIGHT[self.span_id] = {
                    "trace": _hex(self.trace_id),
                    "span": _hex(self.span_id),
                    "name": name, "t0": round(self._t0, 6)}

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def event(self, name: str, **fields) -> "Span":
        """Attach a point-in-time event (e.g. ``preempted``)."""
        ev = {"name": name, "t_ms": round(
            (self._clock() - self._t0) * 1e3, 3)}
        ev.update(fields)
        self.events.append(ev)
        return self

    def activate(self):
        """``with sp.activate():`` — make this span the ambient context
        so nested spans and outbound RPCs link under it."""
        return use_context(self.context())

    def end(self, status: str = "ok") -> None:
        """Finish the span: fix its duration, set the typed status, and
        leave the in-flight table. Idempotent — the first end wins,
        mirroring the request handles' first-resolve-wins rule."""
        if self._done:
            return
        self._done = True
        self.status = status
        self.duration_ms = (self._clock() - self._t0) * 1e3
        if self._root:
            with _INFLIGHT_LOCK:
                _INFLIGHT.pop(self.span_id, None)

    def fail(self, exc: BaseException) -> None:
        """End with the error taxonomy name of ``exc`` as the status."""
        self.end(status=type(exc).__name__)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end(status="ok" if exc is None else exc_type.__name__)
        return False


@contextlib.contextmanager
def span(name: str, parent=None, clock=None, **attrs):
    """Scoped span that is ALSO the ambient context inside the block:
    nested ``span()`` calls and outbound KV requests parent to it. For
    long-lived request spans that cross threads/ticks, construct
    ``Span`` directly and pass it around instead."""
    sp = Span(name, parent=parent, clock=clock, **attrs)
    token = _CURRENT.set(sp.context())
    try:
        yield sp
    except BaseException as e:
        sp.fail(e)
        raise
    finally:
        _CURRENT.reset(token)
        sp.end()   # no-op when fail() already ended it
