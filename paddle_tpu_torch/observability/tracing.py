"""Request tracing: trace/span ids with parent linkage, monotonic
timings, and typed status.

A copy of ``paddle_tpu/observability/tracing.py`` without its JSONL
sink and without the flight recorder's in-flight table: the port has
neither yet, so a finished span fixes its duration and status and
nothing is emitted. Span ids, parent linkage and the ambient context
behave as in the original. Stdlib only.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import time
from typing import Dict, List, Optional

__all__ = ["Span", "SpanContext", "current_context", "use_context",
           "new_trace_id"]

_ID_SEQ = itertools.count(1)


def new_trace_id() -> int:
    """A random 63-bit id with a live counter folded in."""
    return ((int.from_bytes(os.urandom(8), "little") + next(_ID_SEQ))
            & 0x7FFFFFFFFFFFFFFF) or 1


def _hex(i: Optional[int]) -> Optional[str]:
    return format(i, "016x") if i else None


class SpanContext:
    """Compact propagatable identity: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)

    def __repr__(self):
        return f"SpanContext({_hex(self.trace_id)}, {_hex(self.span_id)})"


_CURRENT: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("paddle_torch_trace_context", default=None)


def current_context() -> Optional[SpanContext]:
    """The ambient trace context of this thread/task (None = untraced)."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]):
    """Make ``ctx`` the ambient context inside the with-block."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


class Span:
    """One timed, linkable operation.

    ``parent`` may be a Span, a SpanContext, or None (None adopts the
    ambient ``current_context()``; ``parent=False`` forces a root).
    ``root=True`` marks a request's root span, as the JAX package's
    callers pass it. End with ``end(status)`` or ``fail(exc)``; the
    first end wins."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "events", "status", "duration_ms", "root", "_clock",
                 "_t0", "_done")

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
        self.span_id = new_trace_id()
        self.attrs: Dict[str, object] = dict(attrs)
        self.events: List[dict] = []
        self.status: Optional[str] = None
        self.duration_ms: Optional[float] = None
        self.root = bool(root)
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._done = False

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
        """``with sp.activate():`` makes this span the ambient context."""
        return use_context(self.context())

    def end(self, status: str = "ok") -> None:
        """Finish the span: fix its duration and typed status. Idempotent."""
        if self._done:
            return
        self._done = True
        self.status = status
        self.duration_ms = (self._clock() - self._t0) * 1e3

    def fail(self, exc: BaseException) -> None:
        """End with the error taxonomy name of ``exc`` as the status."""
        self.end(status=type(exc).__name__)
