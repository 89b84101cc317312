"""Process-global counters: the flat counter API of
``paddle_tpu/profiler.py`` (``bump_counter`` / ``set_counter`` /
``counters_snapshot`` / ``counters_delta``) over the port's metrics
registry, and the fault-tolerance slice (``FAULT_COUNTER_NAMES``) that
the serving engines and the fleet router merge into their counters."""
from __future__ import annotations

from .observability import metrics as _metrics

__all__ = ["FAULT_COUNTER_NAMES", "bump_counter", "set_counter",
           "counters_snapshot", "counters_delta"]

_REGISTRY = _metrics.default_registry()

# process events, not per-engine ones (paddle_tpu/profiler.py:183):
#   retry_attempts     re-attempts after a retryable failure (Retrier)
#   retry_giveups      retry budget/deadline exhausted, last error raised
#   faults_injected    armed fault points fired (tests / PADDLE_FAULT_SPEC)
#   ckpt_*, trainer_relaunches  checkpoint and supervisor events of the
#                      reference, kept so the tuple is the same
FAULT_COUNTER_NAMES = (
    "retry_attempts", "retry_giveups", "faults_injected",
    "ckpt_commits", "ckpt_corrupt_skipped", "ckpt_fallbacks",
    "trainer_relaunches",
)


def bump_counter(name: str, n: int = 1) -> None:
    """Add ``n`` to the global counter ``name`` (thread-safe)."""
    _REGISTRY.inc_scalar(name, n)


def set_counter(name: str, value) -> None:
    """Gauge semantics: overwrite counter ``name`` with ``value``."""
    _REGISTRY.set_scalar(name, value)


def counters_snapshot() -> dict:
    """Copy of the global counters."""
    return _REGISTRY.flat_snapshot()


def counters_delta(before: dict) -> dict:
    """{name: change} of every counter that moved since ``before`` (a
    ``counters_snapshot()``)."""
    return _REGISTRY.flat_delta(before)
