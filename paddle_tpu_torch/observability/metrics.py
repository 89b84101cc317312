"""Typed metrics registry: declared Counter/Gauge/Histogram metrics with
optional labels, help text, and Prometheus text exposition.

A copy of ``paddle_tpu/observability/metrics.py``. It is the substrate
under the port's ``profiler`` counter API: ``bump_counter`` /
``set_counter`` / ``counters_snapshot`` are thin shims over the default
registry's *scalar tier* (unlabeled counters and gauges live in one
flat name->value dict), while typed call sites declare metrics —
fixed-bucket latency histograms with bucket-derived p50/p99, labeled
series with a hard cardinality cap (``max_label_sets``), and
``render_prometheus()`` for the ``/metrics`` route of every
``distributed.http_kv`` listener. ``parse_prometheus_text`` is its
inverse, read by ``observability.federation`` and ``slo``.

Stdlib only: ``fault``, ``http_kv`` and the serving planes import it.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CONTENT_TYPE", "DEFAULT_LATENCY_BUCKETS_MS", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "default_registry",
    "render_prometheus", "parse_prometheus_text",
    "percentile_from_buckets",
]

# the Prometheus text exposition format version this module renders
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# fixed latency ladder (milliseconds): wide enough for a sub-ms KV poll
# and a multi-second cold dispatch; +Inf is implicit
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt_value(v) -> str:
    """Prometheus sample value: integral floats print as ints."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Base declared metric. Unlabeled counters/gauges store their value
    in the registry's scalar tier (the legacy flat-snapshot dict);
    labeled series and histograms store in the metric object."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = "", labels: Sequence[str] = ()):
        self._registry = registry
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        # label-values tuple -> value (counter/gauge) or bucket state
        self._series: Dict[tuple, object] = {}

    # -- labels ----------------------------------------------------------
    def _series_key(self, labels: Dict[str, object],
                    write: bool = False) -> tuple:
        if set(labels) != set(self.labels):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{list(self.labels)}, got {sorted(labels)}")
        key = tuple(str(labels[n]) for n in self.labels)
        if key not in self._series and \
                len(self._series) >= self._registry.max_label_sets:
            # hard cardinality cap: an unbounded label (request id, user
            # id) must not grow the registry without limit — the excess
            # folds into one overflow series, counted on writes
            if write:
                self._registry._scalars["metrics_label_overflow"] = \
                    self._registry._scalars.get(
                        "metrics_label_overflow", 0) + 1
            key = ("__overflow__",) * len(self.labels)
        return key

    def _sorted_series(self) -> List[Tuple[tuple, object]]:
        return sorted(self._series.items())


class Counter(_Metric):
    """Monotonically increasing metric. ``inc(n)`` unlabeled,
    ``inc(n, **labels)`` when labels were declared."""

    kind = "counter"

    def inc(self, n=1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._registry.lock:
            if not self.labels:
                sc = self._registry._scalars
                sc[self.name] = sc.get(self.name, 0) + n
                return
            key = self._series_key(labels, write=True)
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels):
        with self._registry.lock:
            if not self.labels:
                return self._registry._scalars.get(self.name, 0)
            return self._series.get(self._series_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time metric: ``set`` overwrites, ``inc``/``dec`` adjust."""

    kind = "gauge"

    def set(self, value, **labels) -> None:
        with self._registry.lock:
            if not self.labels:
                self._registry._scalars[self.name] = value
                return
            self._series[self._series_key(labels, write=True)] = value

    def inc(self, n=1, **labels) -> None:
        with self._registry.lock:
            if not self.labels:
                sc = self._registry._scalars
                sc[self.name] = sc.get(self.name, 0) + n
                return
            key = self._series_key(labels, write=True)
            self._series[key] = self._series.get(key, 0) + n

    def dec(self, n=1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels):
        with self._registry.lock:
            if not self.labels:
                return self._registry._scalars.get(self.name, 0)
            return self._series.get(self._series_key(labels), 0)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram (+Inf bucket implicit). ``observe(v)``
    lands ``v`` in its bucket; ``percentile(q)`` derives p50/p99-style
    quantiles from the cumulative bucket counts (linear interpolation
    inside the winning bucket — the engine-side latency truth that does
    not depend on any client keeping samples)."""

    kind = "histogram"

    def __init__(self, registry, name, help="", labels=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        super().__init__(registry, name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)):
            raise ValueError(
                f"histogram {name!r} buckets must be a strictly "
                f"increasing non-empty sequence, got {buckets!r}")
        self.buckets = bs                      # finite upper bounds

    def _get_series(self, labels) -> _HistSeries:
        key = self._series_key(labels, write=True)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1)
        return s

    def observe(self, value, **labels) -> None:
        v = float(value)
        with self._registry.lock:
            s = self._get_series(labels)
            # linear scan beats bisect at these ladder sizes and keeps
            # the hot path allocation-free
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    idx = i
                    break
            s.counts[idx] += 1
            s.sum += v
            s.count += 1

    def snapshot(self, **labels) -> dict:
        """{"count", "sum", "buckets": [(le, cumulative_count), ...]}
        with the +Inf bucket last."""
        with self._registry.lock:
            s = self._series.get(self._series_key(labels))
            if s is None:
                return {"count": 0, "sum": 0.0,
                        "buckets": [(b, 0) for b in self.buckets]
                        + [(float("inf"), 0)]}
            cum, out = 0, []
            for b, c in zip(self.buckets, s.counts):
                cum += c
                out.append((b, cum))
            out.append((float("inf"), cum + s.counts[-1]))
            return {"count": s.count, "sum": s.sum, "buckets": out}

    def percentile(self, q: float, **labels) -> float:
        """q in [0, 100]. 0.0 when empty; the last finite bound when the
        quantile lands in the +Inf bucket."""
        return percentile_from_buckets(self.snapshot(**labels)["buckets"],
                                       q)


def percentile_from_buckets(buckets, q: float) -> float:
    """Quantile from CUMULATIVE histogram buckets by linear
    interpolation inside the winning bucket — the one interpolation
    rule every bucket-derived percentile of the port uses
    (``Histogram.percentile``, ``slo``'s inverse of it).

    ``buckets``: ``[(upper_bound, cumulative_count), ...]`` sorted by
    bound with the +Inf bucket last (``Histogram.snapshot`` layout).
    Returns 0.0 when empty; the last finite bound when the quantile
    lands in the +Inf bucket."""
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
    """Declared metrics + the flat scalar tier the legacy counter API
    rides. One reentrant lock guards everything (including the
    profiler's host-span state — see profiler.RecordEvent)."""

    def __init__(self, max_label_sets: int = 64):
        self.lock = threading.RLock()
        self.max_label_sets = int(max_label_sets)
        self._metrics: Dict[str, _Metric] = {}
        # unlabeled counter/gauge values AND legacy auto-created names:
        # this dict IS counters_snapshot()'s byte-identical source
        self._scalars: Dict[str, object] = {}
        # auto-created (undeclared) scalar name -> last write kind
        self._auto_kinds: Dict[str, str] = {}

    # -- declaration -----------------------------------------------------
    def _declare(self, cls, name: str, help: str, labels, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self.lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or \
                        existing.labels != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{existing.kind} with labels "
                        f"{list(existing.labels)}")
                return existing
            m = cls(self, name, help=help, labels=labels, **kw)
            self._metrics[name] = m
            self._auto_kinds.pop(name, None)
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  ) -> Histogram:
        return self._declare(Histogram, name, help, labels,
                             buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self.lock:
            return self._metrics.get(name)

    # -- scalar tier (legacy bump_counter/set_counter compat) ------------
    def inc_scalar(self, name: str, n=1) -> None:
        with self.lock:
            self._scalars[name] = self._scalars.get(name, 0) + n
            if name not in self._metrics:
                self._auto_kinds.setdefault(name, "counter")

    def set_scalar(self, name: str, value) -> None:
        with self.lock:
            self._scalars[name] = value
            if name not in self._metrics:
                self._auto_kinds[name] = "gauge"

    def flat_snapshot(self) -> dict:
        """Copy of every scalar value ever written — the legacy
        ``counters_snapshot()`` view (declared-but-untouched metrics and
        histograms do NOT appear, exactly like the old Counter)."""
        with self.lock:
            return dict(self._scalars)

    def flat_delta(self, before: dict) -> dict:
        with self.lock:
            return {k: v - before.get(k, 0)
                    for k, v in self._scalars.items()
                    if v - before.get(k, 0)}

    def reset_values(self) -> None:
        """Clear recorded values (declarations survive)."""
        with self.lock:
            self._scalars.clear()
            for m in self._metrics.values():
                m._series.clear()

    # -- exposition ------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4): HELP/TYPE
        headers for declared metrics, scalar values (declared metrics
        render 0 when untouched so scrape series never gap), histogram
        ``_bucket``/``_sum``/``_count`` triples, and auto-created legacy
        counters as untyped trailers."""
        lines: List[str] = []
        with self.lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {name} {m.kind}")
                if isinstance(m, Histogram):
                    series = m._sorted_series() or ([((), None)]
                                                    if not m.labels
                                                    else [])
                    for key, s in series:
                        cum = 0
                        counts = (s.counts if s is not None
                                  else [0] * (len(m.buckets) + 1))
                        for b, c in zip(m.buckets, counts):
                            cum += c
                            ls = _label_str(m.labels + ("le",),
                                            key + (_fmt_value(b),))
                            lines.append(f"{name}_bucket{ls} {cum}")
                        ls = _label_str(m.labels + ("le",),
                                        key + ("+Inf",))
                        total = cum + counts[-1]
                        lines.append(f"{name}_bucket{ls} {total}")
                        lines.append(
                            f"{name}_sum{_label_str(m.labels, key)} "
                            f"{_fmt_value(s.sum if s else 0.0)}")
                        lines.append(
                            f"{name}_count{_label_str(m.labels, key)} "
                            f"{total}")
                    continue
                if not m.labels:
                    v = self._scalars.get(name, 0)
                    lines.append(f"{name} {_fmt_value(v)}")
                else:
                    for key, v in m._sorted_series():
                        lines.append(
                            f"{name}{_label_str(m.labels, key)} "
                            f"{_fmt_value(v)}")
            for name in sorted(self._auto_kinds):
                if name in self._metrics:
                    continue
                kind = self._auto_kinds[name]
                safe = name if _NAME_RE.match(name) else \
                    re.sub(r"[^a-zA-Z0-9_:]", "_", name)
                lines.append(f"# TYPE {safe} {kind}")
                lines.append(
                    f"{safe} {_fmt_value(self._scalars.get(name, 0))}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every shim/endpoint shares."""
    return _DEFAULT


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    return (registry or _DEFAULT).render_prometheus()


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Inverse of render_prometheus (federation and the SLO plane):
    sample lines -> {"name{labels}": value}. Comments are skipped;
    unparseable lines are ignored (scrape targets may interleave)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, raw = line.rsplit(None, 1)
            out[key] = float(raw) if raw not in ("+Inf", "-Inf", "NaN") \
                else float(raw.replace("Inf", "inf"))
        except ValueError:
            continue
    return out
