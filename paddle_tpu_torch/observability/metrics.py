"""Metrics registry: the scalar tier behind the counter API
(``profiler.bump_counter`` / ``set_counter`` / ``counters_snapshot``)
and fixed-bucket latency histograms with bucket-derived percentiles.

A copy of the subset of ``paddle_tpu/observability/metrics.py`` the
decode engine needs, labelled histograms included (the engine's
``decode_tick_phase_ms{phase=dispatch|host|fetch}``); the Prometheus
exposition waits for the port's ``/metrics`` listener. Stdlib only.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Sequence, Tuple

__all__ = ["DEFAULT_LATENCY_BUCKETS_MS", "Histogram", "MetricsRegistry",
           "default_registry", "percentile_from_buckets"]

# fixed latency ladder (milliseconds); +Inf is implicit
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-bucket histogram (+Inf bucket implicit), one series per set
    of label values when ``labels`` were declared: ``observe(v,
    **labels)``, ``snapshot(**labels)``, ``percentile(q, **labels)``
    name every declared label. ``percentile(q)`` interpolates inside the
    winning bucket."""

    def __init__(self, registry: "MetricsRegistry", name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 labels: Sequence[str] = ()):
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(
                f"histogram {name!r} buckets must be a strictly "
                f"increasing non-empty sequence, got {buckets!r}")
        self._registry = registry
        self.name = name
        self.buckets = bs
        self.labels = tuple(labels)
        # label values -> [per-bucket counts (+Inf last), sum, count]
        self._series: Dict[tuple, list] = {}

    def _key(self, labels: Dict[str, object]) -> tuple:
        if set(labels) != set(self.labels):
            raise ValueError(
                f"histogram {self.name!r} declared labels "
                f"{list(self.labels)}, got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.labels)

    def observe(self, value, **labels) -> None:
        v = float(value)
        key = self._key(labels)
        with self._registry.lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1),
                                         0.0, 0]
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            s[0][idx] += 1
            s[1] += v
            s[2] += 1

    def snapshot(self, **labels) -> dict:
        """{"count", "sum", "buckets": [(le, cumulative_count), ...]}
        with the +Inf bucket last."""
        key = self._key(labels)
        with self._registry.lock:
            counts, total, n = self._series.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            cum, out = 0, []
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append((b, cum))
            out.append((float("inf"), cum + counts[-1]))
            return {"count": n, "sum": total, "buckets": out}

    def percentile(self, q: float, **labels) -> float:
        """q in [0, 100]. 0.0 when empty; the last finite bound when the
        quantile lands in the +Inf bucket."""
        return percentile_from_buckets(self.snapshot(**labels)["buckets"],
                                       q)


def percentile_from_buckets(buckets, q: float) -> float:
    """Quantile from CUMULATIVE histogram buckets by linear
    interpolation inside the winning bucket."""
    buckets = list(buckets)
    total = buckets[-1][1] if buckets else 0
    if total == 0:
        return 0.0
    rank = (float(q) / 100.0) * total
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in buckets:
        if cum >= rank and cum > prev_cum:
            if math.isinf(bound):
                return prev_bound if prev_bound else 0.0
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * max(0.0, frac)
        prev_bound, prev_cum = (0.0 if math.isinf(bound) else bound,
                                cum)
    return prev_bound


class MetricsRegistry:
    """Declared histograms + the flat scalar tier the counter API
    rides. One reentrant lock guards everything."""

    def __init__(self):
        self.lock = threading.RLock()
        self._hists: Dict[str, Histogram] = {}
        self._scalars: Dict[str, object] = {}

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  labels: Sequence[str] = ()) -> Histogram:
        """The histogram ``name``, declared on first use with its label
        names; a later call with other label names raises."""
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(self, name, buckets,
                                                  labels)
            elif h.labels != tuple(labels):
                raise ValueError(f"histogram {name!r} already declared "
                                 f"with labels {list(h.labels)}")
            return h

    def inc_scalar(self, name: str, n=1) -> None:
        with self.lock:
            self._scalars[name] = self._scalars.get(name, 0) + n

    def set_scalar(self, name: str, value) -> None:
        with self.lock:
            self._scalars[name] = value

    def flat_snapshot(self) -> dict:
        with self.lock:
            return dict(self._scalars)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every shim shares."""
    return _DEFAULT
