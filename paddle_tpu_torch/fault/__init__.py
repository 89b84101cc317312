"""Fault handling of the port (``paddle_tpu/fault``): failure as a
first-class, testable code path.

- :mod:`retry` — ``Backoff``/``Retrier``/``retry``: exponential backoff
  with jitter, attempt budget, wall-clock deadline, retryable-exception
  filter.
- :mod:`injector` — ``FaultInjector``/``fault.point(name)``: named fault
  points that tests or ``PADDLE_FAULT_SPEC`` arm to fail
  deterministically N times (the serving engine's ``serve.*`` points,
  the KV client's ``http_kv.request``).

Activity lands in process-global counters of the port's ``profiler``
(``retry_attempts``, ``retry_giveups``, ``faults_injected``).
"""
from . import injector  # noqa: F401
from .injector import (  # noqa: F401
    FaultInjector, InjectedFault, arm, armed, default_injector, disarm,
    disarm_all, load_env_spec, point,
)
from .retry import Backoff, Retrier, retry  # noqa: F401

__all__ = ["Backoff", "FaultInjector", "InjectedFault", "Retrier", "arm",
           "armed", "default_injector", "disarm", "disarm_all", "injector",
           "load_env_spec", "point", "retry"]
