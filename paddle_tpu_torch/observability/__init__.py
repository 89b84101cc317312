"""Host-side observability planes of the port: the metrics registry
and request tracing (stdlib only)."""
from . import metrics, tracing

__all__ = ["metrics", "tracing"]
