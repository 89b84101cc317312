"""Standalone ``/metrics`` exposition server.

A copy of ``paddle_tpu/observability/server.py``. The /metrics route
itself lives in ``distributed.http_kv.KVHandler``, so every KV listener
of the port already answers scrapes. This module adds a listener for a
process with no HTTP surface of its own: ``maybe_start_metrics_server()``
is the env-gated idempotent wiring the decode engine calls at
construction — unset ``PADDLE_METRICS_PORT`` = no-op; a bind failure
(two engines sharing one env) warns instead of killing the process it
exists to observe.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["MetricsServer", "start_metrics_server",
           "maybe_start_metrics_server", "stop_metrics_server"]

_ENV_PORT = "PADDLE_METRICS_PORT"


class MetricsServer:
    """Thin KVHTTPServer wrapper: GET /metrics (plus the KV routes —
    harmless, loopback-bound by default like every KV listener)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        from ..distributed.http_kv import KVHandler, KVHTTPServer

        self._server = KVHTTPServer(port, KVHandler, host=host,
                                    max_body_bytes=1 << 20,
                                    request_timeout=10.0)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="paddle-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()


_SINGLETON: Optional[MetricsServer] = None
_LOCK = threading.Lock()


def start_metrics_server(port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start (or return) the process-wide metrics server."""
    global _SINGLETON
    with _LOCK:
        if _SINGLETON is None:
            _SINGLETON = MetricsServer(port, host=host).start()
        return _SINGLETON


def maybe_start_metrics_server() -> Optional[MetricsServer]:
    """Env-gated: starts the singleton on ``PADDLE_METRICS_PORT`` (0 =
    ephemeral), returns None when the env is unset or the bind fails."""
    raw = os.environ.get(_ENV_PORT)
    if not raw:
        return None
    try:
        return start_metrics_server(int(raw))
    except (OSError, ValueError) as e:
        import warnings

        warnings.warn(f"metrics server on {_ENV_PORT}={raw!r} not "
                      f"started: {e}", RuntimeWarning)
        return None


def stop_metrics_server() -> None:
    global _SINGLETON
    with _LOCK:
        if _SINGLETON is not None:
            _SINGLETON.stop()
            _SINGLETON = None
