"""SLO burn-rate plane: declare objectives over the cumulative
histograms and counters of a ``/metrics`` scrape, evaluate multi-window
burn rates from bucket deltas, and publish the verdicts as metrics.

A copy of ``paddle_tpu/observability/slo.py``. An :class:`Objective` is
either **latency** (``p<q>`` of a histogram family under a threshold;
compliance per window from the cumulative ``<hist>_bucket{le=...}``
deltas, good events = observations <= threshold, the repo-wide
``percentile_from_buckets`` interpolation inverted) or **error_rate** (a
numerator counter over a denominator counter under a fraction).

**Burn rate** is (observed bad fraction) / (allowed bad fraction); an
objective *burns* when every window with signal exceeds its factor (the
fast 14.4x / slow 6x pair by default). Windows are evaluated over the
scrape snapshots an :class:`SLOEvaluator` accumulates, so everything is
deterministic under an injected clock. The fleet router's
``FleetSLOSignal`` is its caller.
"""
from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DEFAULT_WINDOWS", "Objective", "SLOEvaluator",
           "WindowVerdict", "counter_value", "default_objectives",
           "extract_histogram", "objectives_from_json"]

# (window_seconds, burn_factor) pairs: page when BOTH windows burn
# above their factor — Google SRE workbook's fast/slow pair, scaled to
# the short-lived jobs this repo runs in CI (minutes, not days).
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = (
    (300.0, 14.4), (3600.0, 6.0))

_BUCKET_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_bucket"
                        r"\{(?P<labels>.*)\}$")
_LE_RE = re.compile(r'(?:^|,)le="(?P<le>[^"]+)"')


def _parse_le(raw: str) -> float:
    return float("inf") if raw == "+Inf" else float(raw)


def extract_histogram(samples: Dict[str, float], family: str,
                      instance: Optional[str] = None
                      ) -> List[Tuple[float, float]]:
    """Cumulative ``[(le, count), ...]`` for one histogram family out
    of a parsed scrape (``parse_prometheus_text`` keys). Series from
    several label sets (ops, instances) are summed per bound — the
    fleet view — unless ``instance`` narrows to one member of a
    federated scrape. Sorted with +Inf last, ``percentile_from_buckets``
    layout."""
    acc: Dict[float, float] = {}
    for key, v in samples.items():
        m = _BUCKET_RE.match(key)
        if not m or m.group("name") != family:
            continue
        labels = m.group("labels")
        if instance is not None and \
                f'instance="{instance}"' not in labels:
            continue
        le = _LE_RE.search(labels)
        if le is None:
            continue
        bound = _parse_le(le.group("le"))
        acc[bound] = acc.get(bound, 0.0) + v
    return sorted(acc.items(), key=lambda kv: kv[0])


def counter_value(samples: Dict[str, float], name: str,
                  instance: Optional[str] = None) -> float:
    """Sum of a counter family's series across label sets (optionally
    narrowed to one federated instance)."""
    total = 0.0
    for key, v in samples.items():
        base = key.split("{", 1)[0]
        if base != name:
            continue
        if instance is not None and "{" in key and \
                f'instance="{instance}"' not in key:
            continue
        total += v
    return total


def _good_fraction_under(buckets: List[Tuple[float, float]],
                         threshold: float) -> Optional[float]:
    """Fraction of observations ≤ ``threshold`` from cumulative
    buckets (linear interpolation inside the straddling bucket — the
    inverse of ``percentile_from_buckets``). None when the histogram
    is empty (no signal ≠ compliant)."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if threshold <= bound:
            if bound == float("inf") or cum == prev_cum:
                return cum / total
            span = bound - prev_bound
            frac = (threshold - prev_bound) / span if span > 0 else 1.0
            est = prev_cum + (cum - prev_cum) * min(max(frac, 0.0), 1.0)
            return est / total
        prev_bound, prev_cum = bound, cum
    return 1.0


def _delta_buckets(new: List[Tuple[float, float]],
                   old: List[Tuple[float, float]]
                   ) -> List[Tuple[float, float]]:
    om = dict(old)
    # counter reset (process restart): a negative delta means the old
    # snapshot is from a previous life — fall back to the new totals
    out = [(b, c - om.get(b, 0.0)) for b, c in new]
    if any(c < 0 for _, c in out):
        return list(new)
    return out


class Objective:
    """One declared objective.

    latency:    Objective("decode_p99", hist="decode_e2e_ms",
                          percentile=99, threshold_ms=250.0)
    error rate: Objective("serve_errors", numerator="serve_failed",
                          denominator="serve_requests",
                          max_ratio=0.01)

    ``percentile`` names the implied SLO target (p99 < X ⇒ 99% of
    events must be good ⇒ error budget 1%); ``instance`` narrows a
    federated scrape to one member."""

    def __init__(self, name: str, hist: Optional[str] = None,
                 percentile: float = 99.0,
                 threshold_ms: Optional[float] = None,
                 numerator: Optional[str] = None,
                 denominator: Optional[str] = None,
                 max_ratio: Optional[float] = None,
                 instance: Optional[str] = None):
        self.name = str(name)
        self.instance = instance
        if hist is not None:
            if threshold_ms is None:
                raise ValueError(
                    f"latency objective {name!r} needs threshold_ms")
            if not 0.0 < percentile < 100.0:
                raise ValueError(
                    f"objective {name!r}: percentile must be in (0, "
                    f"100), got {percentile}")
            self.kind = "latency"
            self.hist = hist
            self.percentile = float(percentile)
            self.threshold_ms = float(threshold_ms)
            self.budget = 1.0 - self.percentile / 100.0
        elif numerator is not None:
            if denominator is None or max_ratio is None:
                raise ValueError(
                    f"error-rate objective {name!r} needs denominator "
                    "and max_ratio")
            if not 0.0 < float(max_ratio) < 1.0:
                raise ValueError(
                    f"objective {name!r}: max_ratio must be in (0, 1), "
                    f"got {max_ratio}")
            self.kind = "error_rate"
            self.numerator = numerator
            self.denominator = denominator
            self.budget = float(max_ratio)
        else:
            raise ValueError(
                f"objective {name!r} needs hist= (latency) or "
                "numerator=/denominator= (error rate)")

    # -- (good, total) event extraction ----------------------------------
    def _events(self, samples: Dict[str, float]
                ) -> Optional[Tuple[float, float]]:
        if self.kind == "latency":
            buckets = extract_histogram(samples, self.hist,
                                        instance=self.instance)
            if not buckets:
                return None
            total = buckets[-1][1]
            good_frac = _good_fraction_under(buckets, self.threshold_ms)
            if good_frac is None:
                return (0.0, 0.0)
            return (good_frac * total, total)
        total = counter_value(samples, self.denominator, self.instance)
        bad = counter_value(samples, self.numerator, self.instance)
        return (max(0.0, total - bad), total)

    def bad_fraction(self, new: Dict[str, float],
                     old: Optional[Dict[str, float]] = None
                     ) -> Optional[float]:
        """Observed bad fraction over the delta between two scrapes
        (``old=None``: the cumulative totals since process start).
        None when the window carries no events — no signal, not a
        burn."""
        if self.kind == "latency":
            nb = extract_histogram(new, self.hist, instance=self.instance)
            if not nb:
                return None
            if old is not None:
                nb = _delta_buckets(
                    nb, extract_histogram(old, self.hist,
                                          instance=self.instance))
            total = nb[-1][1] if nb else 0.0
            if total <= 0:
                return None
            good = _good_fraction_under(nb, self.threshold_ms)
            return 1.0 - (good if good is not None else 0.0)
        ev_new = self._events(new)
        if ev_new is None:
            return None
        good, total = ev_new
        if old is not None:
            ev_old = self._events(old) or (0.0, 0.0)
            dg, dt = good - ev_old[0], total - ev_old[1]
            if dt < 0 or dg < 0:   # counter reset: use new totals
                dg, dt = good, total
            good, total = dg, dt
        if total <= 0:
            return None
        return min(1.0, max(0.0, 1.0 - good / total))

    def burn_rate(self, new: Dict[str, float],
                  old: Optional[Dict[str, float]] = None
                  ) -> Optional[float]:
        """bad_fraction / error_budget — 1.0 = budget consumed exactly
        at the sustainable pace."""
        bad = self.bad_fraction(new, old)
        if bad is None:
            return None
        return bad / self.budget


class WindowVerdict:
    """Burn evaluation of one objective over the configured windows."""

    __slots__ = ("objective", "windows", "burning")

    def __init__(self, objective: str,
                 windows: List[dict], burning: bool):
        self.objective = objective
        self.windows = windows
        self.burning = burning

    def to_dict(self) -> dict:
        return {"objective": self.objective, "burning": self.burning,
                "windows": list(self.windows)}


class SLOEvaluator:
    """Accumulate scrape snapshots; evaluate multi-window burn rates.

    ``add_snapshot(samples, t=None)`` records one parsed scrape (from
    ``parse_prometheus_text`` — direct or federated). ``evaluate()``
    computes, per objective and per ``(window_s, factor)``, the burn
    rate from the delta between the newest snapshot and the one just
    outside the window (snapshots sparser than the window degrade to
    the oldest available — honest about what was seen). An objective
    is **burning** when every window with signal exceeds its factor
    and at least one window had signal.

    Verdicts publish to the default registry: gauge
    ``slo_burn_rate{objective,window}``, gauge
    ``slo_burning{objective}``, counter ``slo_breaches``."""

    def __init__(self, objectives: Sequence[Objective],
                 windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                 clock=time.time, max_snapshots: int = 512,
                 publish: bool = True):
        if not objectives:
            raise ValueError("SLOEvaluator needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.objectives = list(objectives)
        self.windows = tuple((float(w), float(f)) for w, f in windows)
        self._clock = clock
        self._snaps: List[Tuple[float, Dict[str, float]]] = []
        self._max_snapshots = int(max_snapshots)
        self._publish = bool(publish)

    def add_snapshot(self, samples: Dict[str, float],
                     t: Optional[float] = None) -> None:
        t = self._clock() if t is None else float(t)
        self._snaps.append((t, dict(samples)))
        if len(self._snaps) > self._max_snapshots:
            del self._snaps[:len(self._snaps) - self._max_snapshots]

    def _window_base(self, now: float,
                     window_s: float) -> Optional[Dict[str, float]]:
        """Newest snapshot at/older than ``now - window_s`` (None:
        nothing predates the window — deltas fall back to cumulative,
        i.e. 'since the oldest thing we know')."""
        base = None
        for t, samples in self._snaps[:-1]:
            if t <= now - window_s:
                base = samples
            else:
                break
        return base

    def evaluate(self, publish: Optional[bool] = None
                 ) -> List[WindowVerdict]:
        """Evaluate every objective over the configured windows.
        ``publish`` overrides the constructor's flag for this call
        (``burning()`` passes False so a verdict is never published —
        and ``slo_breaches`` never counted — twice per cycle)."""
        if not self._snaps:
            raise ValueError("no snapshots added yet")
        now, newest = self._snaps[-1]
        verdicts: List[WindowVerdict] = []
        for obj in self.objectives:
            rows: List[dict] = []
            burning = True
            saw_signal = False
            for window_s, factor in self.windows:
                base = self._window_base(now, window_s)
                rate = obj.burn_rate(newest, base)
                rows.append({"window_s": window_s, "factor": factor,
                             "burn_rate": (round(rate, 4)
                                           if rate is not None else None)})
                if rate is None:
                    continue
                saw_signal = True
                if rate <= factor:
                    burning = False
            burning = burning and saw_signal
            verdicts.append(WindowVerdict(obj.name, rows, burning))
        if self._publish if publish is None else publish:
            self._publish_verdicts(verdicts)
        return verdicts

    def _publish_verdicts(self, verdicts: List[WindowVerdict]) -> None:
        from .catalog import LABELED_GAUGES
        from .metrics import default_registry

        reg = default_registry()
        # declared FROM the catalog so help/labels cannot drift from
        # federation's declarations (mismatched labels raise at runtime)
        rate_g = reg.gauge("slo_burn_rate",
                           help=LABELED_GAUGES["slo_burn_rate"][0],
                           labels=LABELED_GAUGES["slo_burn_rate"][1])
        burn_g = reg.gauge("slo_burning",
                           help=LABELED_GAUGES["slo_burning"][0],
                           labels=LABELED_GAUGES["slo_burning"][1])
        for v in verdicts:
            for row in v.windows:
                if row["burn_rate"] is not None:
                    rate_g.set(row["burn_rate"], objective=v.objective,
                               window=f"{int(row['window_s'])}s")
            burn_g.set(1 if v.burning else 0, objective=v.objective)
            if v.burning:
                reg.inc_scalar("slo_breaches")

    def burning(self) -> List[str]:
        """Names of currently-burning objectives. Never publishes —
        a loop doing ``evaluate(); ... burning()`` must not count the
        same breach (or set the gauges) twice per cycle."""
        return [v.objective
                for v in self.evaluate(publish=False) if v.burning]


def default_objectives() -> List[Objective]:
    """The stock fleet objectives over the declared catalog families —
    a starting point; real deployments pass their own thresholds."""
    return [
        Objective("decode_e2e_p99", hist="decode_e2e_ms",
                  percentile=99, threshold_ms=2500.0),
        Objective("serve_e2e_p99", hist="serve_e2e_ms",
                  percentile=99, threshold_ms=1000.0),
        Objective("ps_rpc_p99", hist="ps_rpc_ms",
                  percentile=99, threshold_ms=250.0),
        Objective("serve_error_rate", numerator="serve_failed",
                  denominator="serve_requests", max_ratio=0.01),
        Objective("decode_error_rate", numerator="decode_failed",
                  denominator="decode_requests", max_ratio=0.01),
    ]


def objectives_from_json(text: str) -> List[Objective]:
    """Parse a JSON objective list:
    ``[{"name": ..., "hist": ..., "percentile": ..., "threshold_ms":
    ...}, {"name": ..., "numerator": ..., "denominator": ...,
    "max_ratio": ...}, ...]``."""
    rows = json.loads(text)
    if not isinstance(rows, list):
        raise ValueError("objectives JSON must be a list of objects")
    return [Objective(**row) for row in rows]
