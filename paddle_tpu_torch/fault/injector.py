"""Deterministic fault injection at named code points.

A copy of ``paddle_tpu/fault/injector.py``: a named ``fault.point("...")``
call on each critical transition; tests — or the ``PADDLE_FAULT_SPEC``
env var — arm a point to fail deterministically N times, after which it
passes again (the failpoint idiom: zero cost unarmed, exact-name match
first, then fnmatch patterns).

Points in the port (grep for ``point(`` to enumerate):

    http_kv.request   before each KV client HTTP round-trip
    serve.admit       serving-engine admission (inference/serving.py)
    serve.assemble    before a serving tick pops its batch
    serve.dispatch    before each batched serving dispatch (retried)
    serve.respond     before each per-request result delivery
    serve.fallback    before each degraded row-by-row fallback

``PADDLE_FAULT_SPEC`` grammar — comma-separated triggers::

    point:times[@after][:ExcName[:message]]
    e.g. PADDLE_FAULT_SPEC="serve.dispatch:2:OSError:injected"
         PADDLE_FAULT_SPEC="serve.respond:1@2"   # fail the 3rd hit only

ExcName resolves from builtins (OSError, TimeoutError, ...); default is
InjectedFault. Each injected raise bumps the process-global
``faults_injected`` counter (the port's ``profiler``) and dumps the
flight recorder. The spec is read when this module is imported.
"""
from __future__ import annotations

import fnmatch
import os
import threading
from typing import Dict, Optional

__all__ = ["InjectedFault", "FaultInjector", "arm", "disarm", "disarm_all",
           "point", "armed", "load_env_spec", "default_injector"]

_ENV_SPEC = "PADDLE_FAULT_SPEC"


class InjectedFault(RuntimeError):
    """Raised by an armed fault point (unless armed with another type)."""


def _bump(name: str, n: int = 1) -> None:
    from .. import profiler

    profiler.bump_counter(name, n)


class _Trigger:
    __slots__ = ("times", "exc_type", "message", "after", "hits", "fired")

    def __init__(self, times: int, exc_type: type, message: str,
                 after: int = 0):
        self.times = int(times)
        self.exc_type = exc_type
        self.message = message
        self.after = int(after)
        self.hits = 0
        self.fired = 0


class FaultInjector:
    """Named fault points armed to fail deterministically N times."""

    def __init__(self, env_spec: Optional[str] = None):
        self._lock = threading.Lock()
        self._triggers: Dict[str, _Trigger] = {}
        if env_spec:
            self.load_spec(env_spec)

    # -- arming -------------------------------------------------------------
    def arm(self, name: str, times: int = 1, exc: Optional[type] = None,
            message: Optional[str] = None, after: int = 0) -> None:
        """Make ``point(name)`` raise ``exc`` (a type; default
        InjectedFault) on ``times`` hits, skipping the first ``after``
        hits ("crash the 3rd commit" = after=2, times=1). ``name`` may
        be an fnmatch pattern ("serve.*")."""
        if exc is not None and not (isinstance(exc, type)
                                    and issubclass(exc, BaseException)):
            raise TypeError(f"exc must be an exception type, got {exc!r}")
        with self._lock:
            self._triggers[name] = _Trigger(
                times, exc or InjectedFault,
                message or f"injected fault at {name!r}", after=after)

    def disarm(self, name: str) -> None:
        with self._lock:
            self._triggers.pop(name, None)

    def disarm_all(self) -> None:
        with self._lock:
            self._triggers.clear()

    def armed(self, name: str) -> int:
        """Remaining failures the next hits of ``name`` will see."""
        with self._lock:
            t = self._find(name)
            return max(0, t.times - t.fired) if t else 0

    def load_spec(self, spec: str) -> None:
        """Parse a PADDLE_FAULT_SPEC string and arm its triggers."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":", 3)
            if len(fields) < 2:
                raise ValueError(
                    f"bad {_ENV_SPEC} entry {part!r}: want "
                    "point:times[@after][:ExcName[:message]]")
            name = fields[0]
            times_field, _, after_field = fields[1].partition("@")
            try:
                times = int(times_field)
                after = int(after_field) if after_field else 0
            except ValueError:
                raise ValueError(
                    f"bad {_ENV_SPEC} counts {fields[1]!r} in {part!r}: "
                    "want times[@after] as integers") from None
            exc: type = InjectedFault
            if len(fields) >= 3 and fields[2]:
                import builtins

                exc = getattr(builtins, fields[2], None)
                if not (isinstance(exc, type)
                        and issubclass(exc, BaseException)):
                    raise ValueError(
                        f"bad {_ENV_SPEC} exception {fields[2]!r} "
                        f"in {part!r}")
            message = (fields[3] if len(fields) == 4
                       else f"injected fault at {name!r} ({_ENV_SPEC})")
            self.arm(name, times=times, exc=exc, message=message,
                     after=after)

    # -- firing -------------------------------------------------------------
    def _find(self, name: str) -> Optional[_Trigger]:
        t = self._triggers.get(name)
        if t is not None:
            return t
        for pat, trig in self._triggers.items():
            if fnmatch.fnmatchcase(name, pat):
                return trig
        return None

    def point(self, name: str) -> None:
        """Fault point: no-op unless armed; armed, raises and consumes
        one failure."""
        with self._lock:
            t = self._find(name)
            if t is None:
                return
            t.hits += 1
            if t.hits <= t.after or t.fired >= t.times:
                return
            t.fired += 1
            exc = t.exc_type(t.message)
        _bump("faults_injected")
        # flight recorder, BEFORE the raise propagates: a chaos
        # SystemExit often dies via os._exit (no atexit, no teardown),
        # so the postmortem must hit disk here or never
        try:
            from ..observability.flight_recorder import flight_recorder

            fr = flight_recorder()
            fr.record("fault_injected", point=name,
                      error=type(exc).__name__, message=str(exc))
            fr.dump(reason=f"fault_injected:{name}")
        except Exception:
            pass   # the chaos knob must not mask its own fault
        raise exc


# -- module-level default injector (what production call sites use) ---------
try:
    default_injector = FaultInjector(os.environ.get(_ENV_SPEC))
except ValueError as _e:
    # a malformed job-wide spec must not brick the import for every
    # process in the environment — the chaos knob cannot be allowed to
    # take down the process it exists to harden
    import warnings as _warnings

    _warnings.warn(f"ignoring malformed {_ENV_SPEC}: {_e}", RuntimeWarning)
    default_injector = FaultInjector()


def arm(name: str, times: int = 1, exc: Optional[type] = None,
        message: Optional[str] = None, after: int = 0) -> None:
    default_injector.arm(name, times=times, exc=exc, message=message,
                         after=after)


def disarm(name: str) -> None:
    default_injector.disarm(name)


def disarm_all() -> None:
    default_injector.disarm_all()


def armed(name: str) -> int:
    return default_injector.armed(name)


def point(name: str) -> None:
    default_injector.point(name)


def load_env_spec(spec: Optional[str] = None) -> None:
    """(Re)load triggers from ``spec`` or the live PADDLE_FAULT_SPEC."""
    spec = spec if spec is not None else os.environ.get(_ENV_SPEC, "")
    if spec:
        default_injector.load_spec(spec)
