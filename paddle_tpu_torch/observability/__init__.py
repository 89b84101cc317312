"""Host-side observability planes of the port (``paddle_tpu/observability``),
stdlib only:

- :mod:`.metrics` — ``MetricsRegistry`` (Counter/Gauge/Histogram with
  labels, help text, a label-cardinality cap, bucket-derived p50/p99)
  and its Prometheus text exposition; the ``profiler`` counter API is a
  shim over the default registry's scalar tier.
- :mod:`.flight_recorder` — bounded postmortem ring dumped atomically
  on typed failures and SIGTERM drain (``PADDLE_FLIGHTREC_DIR``).
- :mod:`.server` — standalone ``/metrics`` endpoint
  (``PADDLE_METRICS_PORT``); every http_kv listener serves ``/metrics``
  natively.
- :mod:`.tracing` — request tracing: trace/span ids with parent linkage
  and typed status, context carried over http_kv headers (the JSONL
  sink is a later port slice).
- :mod:`.slo` — objectives over cumulative histograms/counters with
  multi-window burn-rate evaluation.
- :mod:`.federation` — scrape N member ``/metrics`` endpoints, merge
  families under an ``instance`` label, re-serve the union.
- :mod:`.device_peaks` — the card's data-sheet peaks for the cost
  gauges.
"""
from . import metrics  # noqa: F401
from .metrics import (CONTENT_TYPE, Counter, Gauge,  # noqa: F401
                      Histogram, MetricsRegistry, default_registry,
                      parse_prometheus_text, percentile_from_buckets,
                      render_prometheus)
from .flight_recorder import (FlightRecorder,  # noqa: F401
                              flight_recorder, note_typed_error,
                              reset_flight_recorder)
from . import tracing  # noqa: F401
from .tracing import (Span, SpanContext, current_context,  # noqa: F401
                      inflight_snapshot, span, use_context)
from . import slo  # noqa: F401
from .slo import Objective, SLOEvaluator  # noqa: F401

__all__ = [
    "CONTENT_TYPE", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "render_prometheus", "parse_prometheus_text",
    "percentile_from_buckets",
    "FlightRecorder", "flight_recorder", "note_typed_error",
    "reset_flight_recorder",
    "MetricsServer", "start_metrics_server",
    "maybe_start_metrics_server", "stop_metrics_server",
    "Span", "SpanContext", "current_context", "inflight_snapshot",
    "span", "use_context",
    "Objective", "SLOEvaluator",
    "FederatedMetrics", "FederationServer",
]


def __getattr__(name):
    # server/federation pull in distributed.http_kv; kept lazy as in the
    # JAX package
    if name in ("MetricsServer", "start_metrics_server",
                "maybe_start_metrics_server", "stop_metrics_server"):
        from . import server

        return getattr(server, name)
    if name in ("FederatedMetrics", "FederationServer"):
        from . import federation

        return getattr(federation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
