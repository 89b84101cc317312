"""Serving error taxonomy and the dual-recorded latency histogram the
decode engine uses (``paddle_tpu/inference/serving.py:72-129``).
Callers branch on the error type, never on the message. The
bucket-compiled ``ServingEngine`` waits for a later port slice."""
from __future__ import annotations

from ..observability.metrics import MetricsRegistry
from ..observability.metrics import default_registry as _registry

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded",
           "EngineStopped", "RequestFailed", "KVRestoreError"]


class ServingError(RuntimeError):
    """Base class for every typed serving failure."""


class Overloaded(ServingError):
    """Shed at admission: queue depth bound or token-bucket rate limit."""


class DeadlineExceeded(ServingError):
    """The request could no longer make its deadline and was dropped."""


class EngineStopped(ServingError):
    """Submitted after drain/stop began — the engine no longer admits."""


class RequestFailed(ServingError):
    """The request's dispatch failed; it ends with this typed error."""


class KVRestoreError(ServingError):
    """A parked session's staged restore was unavailable: the decode
    engine's restore prefetcher died, failed or timed out. The engine
    counts it (``kv_restore_fallbacks``) and restores synchronously."""


class _DualHist:
    """One serving latency histogram recorded twice: into the engine's
    PRIVATE registry (so the engine's percentiles report its own
    requests only) and into the process-global registry. Reads come
    from the private series."""

    __slots__ = ("_local", "_global")

    def __init__(self, name: str, local_registry: MetricsRegistry):
        self._local = local_registry.histogram(name)
        self._global = _registry().histogram(name)

    def observe(self, value) -> None:
        self._local.observe(value)
        self._global.observe(value)

    def percentile(self, q: float) -> float:
        return self._local.percentile(q)

    def snapshot(self) -> dict:
        return self._local.snapshot()
