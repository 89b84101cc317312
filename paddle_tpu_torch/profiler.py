"""Process-global counters: the flat counter API of
``paddle_tpu/profiler.py`` (``bump_counter`` / ``set_counter`` /
``counters_snapshot``) over the port's metrics registry."""
from __future__ import annotations

from .observability import metrics as _metrics

__all__ = ["bump_counter", "set_counter", "counters_snapshot"]

_REGISTRY = _metrics.default_registry()


def bump_counter(name: str, n: int = 1) -> None:
    """Add ``n`` to the global counter ``name`` (thread-safe)."""
    _REGISTRY.inc_scalar(name, n)


def set_counter(name: str, value) -> None:
    """Gauge semantics: overwrite counter ``name`` with ``value``."""
    _REGISTRY.set_scalar(name, value)


def counters_snapshot() -> dict:
    """Copy of the global counters."""
    return _REGISTRY.flat_snapshot()
