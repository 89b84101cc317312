"""Crash flight recorder: a bounded in-memory ring of the last N step
records and typed-error events, dumped ATOMICALLY to
``<dir>/flightrec_<pid>.json`` the moment a typed failure fires — a
retry give-up, an injected chaos fault, a serving ``RequestFailed``, a
replica the fleet router saw die — and on SIGTERM drain. A chaos drill
(or a real death) then leaves a readable postmortem whose last events
name the error that killed the process, even when the process exits via
``os._exit`` (the dump happens at raise/fire time, not at interpreter
teardown).

A copy of ``paddle_tpu/observability/flight_recorder.py``. Recording is
always on (a deque append under a lock); DUMPING is gated by
``PADDLE_FLIGHTREC_DIR`` (or an explicit ``dir=``). ``PADDLE_FLIGHTREC_STEPS``
sizes the ring (default 256). Stdlib only.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder", "flight_recorder", "note_typed_error",
           "reset_flight_recorder"]

_ENV_DIR = "PADDLE_FLIGHTREC_DIR"
_ENV_STEPS = "PADDLE_FLIGHTREC_STEPS"


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 dir: Optional[str] = None, clock=time.time):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_STEPS, "256") or 256)
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        # dumps serialize on their own lock (never held while callers
        # record): two threads failing at once — a scheduler thread's
        # typed error racing the SIGTERM drain — must not interleave
        # writes into one postmortem file
        self._dump_lock = threading.Lock()
        self._dir = dir
        self._clock = clock
        self._seq = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def dir(self) -> Optional[str]:
        """Dump directory: the constructor's, else the LIVE env value —
        a worker env-armed after import still dumps."""
        return self._dir or os.environ.get(_ENV_DIR) or None

    # -- recording -------------------------------------------------------
    def record(self, kind: str, **fields) -> dict:
        """Append one event to the ring; returns the event dict."""
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "t": round(self._clock(), 6),
                  "kind": kind}
            ev.update(fields)
            self._ring.append(ev)
        return ev

    def record_step(self, rec: dict) -> None:
        """One executor/serving step record (the StepTrace feed)."""
        self.record("step", **rec)

    def note_error(self, exc: BaseException, where: str = "",
                   dump: bool = True) -> Optional[str]:
        """Record a typed error event; dump the ring when a dump dir is
        configured. Returns the dump path (None when dumping is off)."""
        self.record("typed_error", error=type(exc).__name__,
                    message=str(exc)[:500], where=where)
        if dump:
            return self.dump(reason=f"typed_error:{type(exc).__name__}")
        return None

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping ---------------------------------------------------------
    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> Optional[str]:
        """Write the postmortem JSON atomically (tmp + os.replace).
        With no explicit ``path`` and no configured dir, a no-op
        returning None — the cheap default for jobs not opted in."""
        if path is None:
            d = self.dir
            if not d:
                return None
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flightrec_{os.getpid()}.json")
        payload = {
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "reason": reason,
            "time": self._clock(),
            "events": self.events(),
            "counters": _counters_if_loaded(),
            # requests stranded mid-flight at dump time: their
            # trace/span ids, so a chaos kill NAMES the requests it
            # killed
            "inflight_requests": _inflight_if_loaded(),
        }
        with self._dump_lock:
            # unique tmp per call (module-wide counter): even a dump
            # racing one on another recorder instance targeting the
            # same path must never truncate a tmp mid-json.dump
            tmp = f"{path}.tmp{os.getpid()}.{next(_DUMP_IDS)}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        _bump_if_loaded("flightrec_dumps")
        return path


def _counters_if_loaded() -> dict:
    """Flat counter snapshot for the dump (the port's ``profiler``
    counters live in the default registry's scalar tier)."""
    try:
        from . import metrics

        return metrics.default_registry().flat_snapshot()
    except Exception:
        return {}


def _inflight_if_loaded() -> list:
    """Open request-root spans (tracing module) — a failed import must
    never break the postmortem writer mid-death."""
    try:
        from . import tracing

        return tracing.inflight_snapshot()
    except Exception:
        return []


def _bump_if_loaded(name: str) -> None:
    try:
        from . import metrics

        metrics.default_registry().inc_scalar(name)
    except Exception:
        pass


_DUMP_IDS = itertools.count(1)

_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder every error path feeds."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def reset_flight_recorder() -> None:
    """Drop the global recorder (tests re-size the ring via env)."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None


def note_typed_error(exc: BaseException, where: str = "") -> Optional[str]:
    """Error-path hook: record + dump on the global recorder, never
    raising — a broken postmortem writer must not mask the real error."""
    try:
        return flight_recorder().note_error(exc, where=where)
    except Exception:
        return None
