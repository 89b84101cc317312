"""HTTP KV server and client: a tiny GET/PUT/DELETE key-value HTTP
service (paths are "scope/key", values raw bytes) whose hardened
listener every HTTP surface of the port rides — the decode engine's
fleet surface (``serving.router.DecodeEngineServer``), the batch
serving probes (``inference.serving.ServingHealthServer``), the
standalone ``/metrics`` server and the metrics federator. GET
``/metrics`` on any of them is the Prometheus exposition of the
process-global registry.

A copy of ``paddle_tpu/distributed/http_kv.py``. ``KVClient`` retries
transient socket failures through ``fault.Retrier``, and
``wait``/``barrier`` give the blocking rendezvous a hard timeout so a
dead peer surfaces as TimeoutError instead of an infinite poll."""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["KVHandler", "KVHTTPServer", "KVServer", "KVClient"]


# shared lazy counter shim (the profiler loads on the first bump)
from ..fault.injector import _bump as _bump_counter  # noqa: E402
# the registry: /metrics exposition + the kv round-trip histogram
from ..observability import metrics as _obs_metrics  # noqa: E402
# stdlib-only tracing: requests carry X-Paddle-Trace/X-Paddle-Span so
# a rendezvous/shard-map poll inside a traced region links server-side
from ..observability import tracing as _tracing  # noqa: E402

_KV_HIST = None


def _kv_hist():
    """Cached kv_request_ms histogram handle (per-request hot path —
    includes every barrier wait poll)."""
    global _KV_HIST
    if _KV_HIST is None:
        _KV_HIST = _obs_metrics.default_registry().histogram(
            "kv_request_ms")
    return _KV_HIST


class KVHandler(BaseHTTPRequestHandler):
    """GET returns the stored bytes (404 when absent), PUT stores the
    body, DELETE removes the key and counts toward the scope's
    deleted-size barrier.

    Hardened against misbehaving clients — this server doubles as the
    serving health endpoint, so a single bad peer must not wedge it:

    - a PUT whose Content-Length exceeds the server's ``max_body_bytes``
      is rejected 413 without reading the body (counter
      ``kv_rejected_oversize``) and the connection is closed;
    - a missing/unparseable Content-Length on PUT is a 411;
    - every connection socket carries the server's ``request_timeout``,
      so a client that stalls mid-request (half-sent headers, dribbled
      body) gets its connection closed (counter ``kv_conn_timeouts``)
      instead of pinning a handler thread forever.

    GET ``/metrics`` is a RESERVED route (Prometheus exposition of the
    process-global registry) — a KV key literally named ``metrics`` is
    shadowed on GET; real keys use "scope/key" paths, which never
    collide."""

    def setup(self):
        # per-connection socket timeout BEFORE the stream wrappers are
        # built: socketserver applies self.timeout in its setup()
        self.timeout = getattr(self.server, "request_timeout", None)
        super().setup()

    def _traced(self, name: str, inner):
        """Run ``inner()`` inside a server-side span parented to the
        caller's header context (straight call when untraced) — the
        http_kv leg of distributed tracing."""
        ctx = _tracing.SpanContext.from_headers(self.headers)
        if ctx is None:
            return inner()
        sp = _tracing.Span(name, parent=ctx, path=self.path)
        try:
            with sp.activate():
                return inner()
        except BaseException as e:
            sp.fail(e)
            raise
        finally:
            sp.end()

    def log_error(self, format, *args):  # noqa: A002 (reference name)
        # handle_one_request swallows socket timeouts after routing them
        # here — the one hook where a stalled connection is observable;
        # everything else keeps the stock stderr diagnostics (only
        # access logging via log_message is quieted)
        if "timed out" in (format % args if args else format):
            _bump_counter("kv_conn_timeouts")
            return
        BaseHTTPRequestHandler.log_error(self, format, *args)

    def do_GET(self):
        return self._traced("http_kv.GET", self._get_inner)

    def _get_inner(self):
        if self.path == "/metrics":
            # Prometheus text exposition of the process-global registry:
            # every KV listener (the decode engine's fleet surface, the
            # serving health server, the PADDLE_METRICS_PORT standalone)
            # is a scrape target for free
            body = _obs_metrics.default_registry() \
                .render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", _obs_metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        with self.server.kv_lock:
            value = self.server.kv.get(self.path.strip("/"))
        if value is None:
            self.send_status_code(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):
        return self._traced("http_kv.PUT", self._put_inner)

    def _put_inner(self):
        raw_len = self.headers.get("Content-Length")
        try:
            n = int(raw_len)
        except (TypeError, ValueError):
            # missing (None) or unparseable: refuse rather than guess —
            # a silent empty-body store would destroy the stored value
            self.send_status_code(411)
            self.close_connection = True
            return
        if n < 0:
            # a negative length slips past the oversize guard and makes
            # rfile.read(n) read until EOF — unbounded buffering, the
            # exact hole max_body_bytes closes
            self.send_status_code(400)
            self.close_connection = True
            return
        limit = getattr(self.server, "max_body_bytes", None)
        if limit is not None and n > limit:
            # reject WITHOUT buffering. Up to 4x the cap the body is
            # drained in chunks (O(chunk) memory) so the client reads a
            # clean 413 instead of hitting EPIPE mid-send — which its
            # retry layer would treat as transient and re-send the
            # whole oversized body for. Past that (absurd declared
            # lengths) the body is left unread: the 413 is still sent,
            # but a client mid-send will usually see the reset first
            # and surface a connection error after its retries — the
            # accepted tradeoff for not sinking unbounded bandwidth.
            _bump_counter("kv_rejected_oversize")
            if n <= 4 * limit:
                left = n
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 16))
                    if not chunk:
                        break
                    left -= len(chunk)
            self.send_status_code(413)
            self.close_connection = True
            return
        body = self.rfile.read(n) if n else b""
        with self.server.kv_lock:
            self.server.kv[self.path.strip("/")] = body
        self.send_status_code(200)

    def do_DELETE(self):
        return self._traced("http_kv.DELETE", self._delete_inner)

    def _delete_inner(self):
        key = self.path.strip("/")
        with self.server.kv_lock:
            self.server.kv.pop(key, None)
            scope = key.split("/")[0]
            self.server.delete_kv[scope] = \
                self.server.delete_kv.get(scope, 0) + 1
        self.send_status_code(200)

    def log_message(self, format, *args):  # noqa: A002 (reference name)
        pass

    def send_status_code(self, code):
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


class KVHTTPServer(ThreadingHTTPServer):
    """The listener: shared dict + per-scope delete counters.

    Binds loopback by default — the unauthenticated KV store must not be
    reachable from the network unless a real multi-node bring-up opts in
    (host="" or the node's address).

    ``max_body_bytes`` bounds any single PUT body (413 past it; None
    disables) and ``request_timeout`` is the per-connection socket
    timeout in seconds (None disables) — together they keep one stalled
    or oversized client from wedging the KV/health server."""

    def __init__(self, port, handler, host="127.0.0.1",
                 max_body_bytes: int = 64 << 20,
                 request_timeout: Optional[float] = 30.0):
        super().__init__((host, int(port)), handler)
        self.max_body_bytes = max_body_bytes
        self.request_timeout = request_timeout
        self.delete_kv = {}
        self.kv_lock = threading.Lock()
        self.kv = {}

    def get_deleted_size(self, key):
        with self.kv_lock:
            return self.delete_kv.get(key, 0)


class KVServer:
    """Start/stop wrapper (reference KVServer): `size` maps scope ->
    expected delete count for wait_server_ready-style barriers."""

    def __init__(self, port, size=None, host="127.0.0.1",
                 max_body_bytes: int = 64 << 20,
                 request_timeout: Optional[float] = 30.0):
        self.http_server = KVHTTPServer(port, KVHandler, host=host,
                                        max_body_bytes=max_body_bytes,
                                        request_timeout=request_timeout)
        self.listen_thread = None
        self.size = dict(size or {})

    def start(self):
        self.listen_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True)
        self.listen_thread.start()

    def stop(self):
        self.http_server.shutdown()
        if self.listen_thread is not None:
            self.listen_thread.join()
        self.http_server.server_close()

    def should_stop(self):
        for key, expected in self.size.items():
            if self.http_server.get_deleted_size(key) < expected:
                return False
        return True


class KVClient:
    """HTTP client for KVServer with transient-failure retry and
    barrier timeouts.

    ``endpoint`` is "host:port". Each request passes the
    "http_kv.request" fault point and retries connection-level OSErrors
    with exponential backoff; HTTP-level responses (404 = absent key)
    are semantic, not retried.
    """

    def __init__(self, endpoint: str, timeout: float = 5.0,
                 retrier=None, sleep=time.sleep):
        from ..fault.retry import Retrier, env_backoff, env_max_attempts

        endpoint = endpoint.replace("http://", "")
        host, _, port = endpoint.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.timeout = float(timeout)
        import http.client

        # BadStatusLine and friends (HTTPException) mean the server
        # died mid-response — as transient as a refused connection
        self._transient = (OSError, http.client.HTTPException)
        self._retry = retrier or Retrier(
            max_attempts=env_max_attempts(4), retry_on=self._transient,
            backoff=env_backoff(0.05, 1.0), sleep=sleep,
            name="http_kv")
        self._sleep = sleep

    def _request_once(self, method: str, key: str,
                      body: Optional[bytes] = None):
        import http.client

        from ..fault import injector as _fault

        _fault.point("http_kv.request")
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        # stamp the ambient trace context onto the request so the
        # server's handler links its span into the caller's tree
        ctx = _tracing.current_context()
        headers = ctx.to_headers() if ctx is not None else {}
        t0 = time.perf_counter()
        try:
            conn.request(method, "/" + key.strip("/"), body=body,
                         headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()
            _kv_hist().observe((time.perf_counter() - t0) * 1e3)

    def _request(self, method: str, key: str, body: Optional[bytes] = None):
        return self._retry.call(self._request_once, method, key, body)

    def get(self, key: str) -> Optional[bytes]:
        """Stored bytes, or None while the key is absent."""
        status, data = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise RuntimeError(f"KV GET {key!r} failed: HTTP {status}")
        return data

    def put(self, key: str, value) -> None:
        body = value.encode() if isinstance(value, str) else bytes(value)
        status, _ = self._request("PUT", key, body=body)
        if status != 200:
            raise RuntimeError(f"KV PUT {key!r} failed: HTTP {status}")

    def delete(self, key: str) -> None:
        # single attempt, never retried: the server counts every DELETE
        # toward the scope's rendezvous barrier, so a retry after a
        # lost response would double-count and release the barrier with
        # a trainer still missing
        status, _ = self._request_once("DELETE", key)
        if status != 200:
            raise RuntimeError(f"KV DELETE {key!r} failed: HTTP {status}")

    def wait(self, key: str, timeout: float = 60.0,
             poll: float = 0.1, max_poll: float = 1.0,
             clock=time.monotonic) -> bytes:
        """Block until ``key`` exists; TimeoutError past ``timeout`` —
        the barrier form of the reference's unbounded wait loops.
        ``wait_until`` with no predicate."""
        return self.wait_until(key, timeout=timeout, poll=poll,
                               max_poll=max_poll, clock=clock)

    def wait_until(self, key: str, predicate=None, timeout: float = 60.0,
                   poll: float = 0.1, max_poll: float = 1.0,
                   clock=time.monotonic, sleep=None) -> bytes:
        """Block until ``key`` exists AND ``predicate(value)`` is true
        (predicate=None just waits for existence); TimeoutError past
        ``timeout``. The shard-map/epoch watchers build on this: e.g.
        ``wait_until("ps/job/epoch", lambda v: int(v) >= 2)``.

        Each poll is a SINGLE request attempt (the poll loop *is* the
        retry — an inner 4-attempt Retrier per poll would let a dead
        server overshoot the deadline by minutes); a connection error
        counts as "not there yet".

        Polls pace out with capped exponential backoff + jitter: the
        first retry waits ``poll`` seconds, later ones grow 1.5x up to
        ``max_poll`` — N workers parked in a barrier stop hammering the
        KV server at a fixed aggregate rate, and the jitter de-phases
        them. Every slowed poll (the second onward) bumps the
        ``kv_poll_backoffs`` counter. ``clock``/``sleep`` are injectable
        so tests drive the deadline without real sleeps (``sleep``
        defaults to the one passed at construction)."""
        from ..fault.retry import Backoff

        sleep = sleep or self._sleep
        deadline = clock() + timeout
        backoff = Backoff(base=poll, factor=1.5,
                          cap=max(poll, max_poll), jitter=0.25)
        attempt = 0
        while True:
            try:
                status, data = self._request_once("GET", key)
                if status == 200 and (predicate is None
                                      or predicate(data)):
                    return data
            except self._transient:
                pass  # server not up yet / transient: poll again
            if clock() >= deadline:
                raise TimeoutError(
                    f"KV barrier timed out after {timeout}s waiting "
                    f"for {key!r} at {self.host}:{self.port}")
            if attempt > 0:
                _bump_counter("kv_poll_backoffs")
            sleep(min(backoff.delay(attempt),
                      max(0.0, deadline - clock())))
            attempt += 1

    def barrier(self, scope: str, rank: int, world_size: int,
                timeout: float = 60.0, poll: float = 0.1) -> None:
        """All-ranks rendezvous on ``scope``: announce this rank, then
        wait (bounded) for every other rank's announcement."""
        self.put(f"{scope}/{rank}", b"1")
        deadline = time.monotonic() + timeout
        for r in range(int(world_size)):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"KV barrier {scope!r} timed out after {timeout}s "
                    f"(rank {r} never arrived)")
            self.wait(f"{scope}/{r}", timeout=remaining, poll=poll)
