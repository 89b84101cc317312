"""Retry with exponential backoff and jitter (port of the part of
``paddle_tpu/fault/retry.py`` that ``serving.disagg.MigrationClient``
uses: :class:`Backoff` and :class:`Retrier`).

The defaults are the reference's own (3 attempts, a first delay of
0.1 s, a 30 s cap); its ``PADDLE_RETRY_*`` environment overrides and the
flight-recorder dump on a give-up are not ported here. Counters (the
port's ``profiler``): ``retry_attempts``, re-attempts after a retryable
failure; ``retry_giveups``, exhausted budgets (the last error is
re-raised).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, Union

__all__ = ["Backoff", "Retrier"]


class Backoff:
    """Exponential backoff schedule with proportional jitter.

    ``delay(attempt)`` for attempt 0, 1, 2, ... is ``min(cap, base *
    factor**attempt)`` with the last ``jitter`` fraction of it
    randomized (jitter 0: deterministic, for tests)."""

    def __init__(self, base: float = 0.1, factor: float = 2.0,
                 cap: float = 30.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        raw = min(self.cap, self.base * (self.factor ** max(0, attempt)))
        if self.jitter <= 0.0:
            return raw
        fixed = raw * (1.0 - self.jitter)
        return fixed + self._rng.random() * (raw - fixed)


_RetryOn = Union[Type[BaseException], Tuple[Type[BaseException], ...],
                 Callable[[BaseException], bool]]


class Retrier:
    """Callable retry policy: deadline, attempt budget, exception filter.

    ``retry_on`` is an exception type or tuple, or a predicate;
    ``giveup_on`` types pass through at once even when they match
    ``retry_on``. On exhaustion the LAST error is re-raised."""

    def __init__(self, max_attempts: int = 3,
                 deadline: Optional[float] = None,
                 backoff: Optional[Backoff] = None,
                 retry_on: _RetryOn = (OSError, ConnectionError,
                                       TimeoutError),
                 giveup_on: Tuple[Type[BaseException], ...] = (),
                 sleep: Callable[[float], None] = time.sleep,
                 name: Optional[str] = None):
        self.max_attempts = int(max_attempts)
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.deadline = deadline
        self.backoff = backoff or Backoff()
        self.retry_on = retry_on
        self.giveup_on = tuple(giveup_on)
        self._sleep = sleep
        self.name = name

    def _retryable(self, exc: BaseException) -> bool:
        if self.giveup_on and isinstance(exc, self.giveup_on):
            return False
        if callable(self.retry_on) and not isinstance(self.retry_on, type):
            return bool(self.retry_on(exc))
        return isinstance(exc, self.retry_on)

    def call(self, fn: Callable, *args, **kwargs):
        from .. import profiler

        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: B036 (filtered below)
                if not self._retryable(e):
                    raise
                attempt += 1
                delay = self.backoff.delay(attempt - 1)
                past_deadline = (
                    self.deadline is not None
                    and time.monotonic() - t0 + delay > self.deadline)
                if attempt >= self.max_attempts or past_deadline:
                    profiler.bump_counter("retry_giveups")
                    raise
                profiler.bump_counter("retry_attempts")
                self._sleep(delay)
