"""Batch serving on the card: a bucketed static-graph predictor and a
continuous-batching engine with admission control, deadlines, and
chaos-tested degradation (port of ``paddle_tpu/inference/serving.py``).

Two layers:

``AnalysisPredictor`` — loads an inference blob written by
``static.save_inference_model`` (either package's; sha256-manifest
verified), prunes it to the feed->fetch subgraph, and runs it through
the port's static ``Executor`` over a PRIVATE ``Scope`` on the card.
Every request batch is padded up to the nearest of a fixed ladder of
batch buckets. The JAX package compiles one XLA executable a bucket and
caches it on disk (``PADDLE_COMPILE_CACHE_DIR``); the port's executor
interprets the program op by op, so nothing is compiled or cached and
``warm()`` runs each bucket once, so that the first request pays no
first-use cost of cuDNN's algorithm choice or of the allocator.

``ServingEngine`` — continuous batching over a bounded admission queue:

- **admission control**: a queue-depth bound plus an optional
  token-bucket rate limit shed load with a typed ``Overloaded`` error;
  after drain begins, submission raises ``EngineStopped``.
- **deadlines**: requests carry a relative deadline and are dropped
  with ``DeadlineExceeded`` the moment they can no longer make it — at
  admission, at batch assembly, and before respond.
- **batching**: each scheduler tick packs compatible requests (same
  non-batch feed signature) up to the largest bucket and pads to the
  nearest one; fill ratio lands in the ``serve_batch_fill_pct`` gauge.
- **degradation ladder**: every stage is a named fault point
  (``serve.admit`` / ``serve.assemble`` / ``serve.dispatch`` /
  ``serve.respond`` / ``serve.fallback``). A failing dispatch retries
  through ``fault.Retrier``, then degrades to the request run ROW BY ROW
  through ``static.executor.run_block`` on the same device (counter
  ``serve_degraded``); only when that fails too does the request fail,
  typed (``RequestFailed``). The degraded leg is a serving feature, not
  a fallback of any kernel: it never leaves the predictor's device.
- **drain**: ``install_sigterm_drain(engine)`` makes SIGTERM stop
  admission, flush every in-flight and queued request, then exit 0.
- **probes**: ``ServingHealthServer`` rides the hardened http_kv
  scaffolding — GET /healthz (liveness) and /readyz (503 while warming
  or draining).

All time is read through an injectable ``clock`` and the scheduler can
be driven synchronously (``run_once``), so every failure path runs
deterministically with no sleeps and no real kills. The error taxonomy
and ``_DualHist`` are the decode engine's too.
"""
from __future__ import annotations

import os
import threading
import time
from collections import Counter as _Counter
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ServingError", "Overloaded", "DeadlineExceeded", "EngineStopped",
    "RequestFailed", "KVRestoreError", "AnalysisPredictor",
    "ServingEngine", "ServingHealthServer", "install_sigterm_drain",
]


# ---------------------------------------------------------------------------
# typed serving errors — callers branch on type, not on message strings
# ---------------------------------------------------------------------------
class ServingError(RuntimeError):
    """Base class for every typed serving failure."""


class Overloaded(ServingError):
    """Shed at admission: queue depth bound or token-bucket rate limit."""


class DeadlineExceeded(ServingError):
    """The request could no longer make its deadline and was dropped."""


class EngineStopped(ServingError):
    """Submitted after drain/stop began — the engine no longer admits."""


class RequestFailed(ServingError):
    """Dispatch retries AND the degraded fallback were exhausted (or the
    request's dispatch failed outright)."""


class KVRestoreError(ServingError):
    """A parked session's staged restore was unavailable: the decode
    engine's restore prefetcher died, failed or timed out. The engine
    counts it (``kv_restore_fallbacks``) and restores synchronously."""


from ..fault.injector import _bump  # noqa: E402 (shared counter shim)
from ..observability import tracing  # noqa: E402
from ..observability.flight_recorder import note_typed_error  # noqa: E402
from ..observability.metrics import MetricsRegistry  # noqa: E402
from ..observability.metrics import default_registry as _registry  # noqa: E402


class _DualHist:
    """One serving latency histogram recorded twice: into the engine's
    PRIVATE registry (so ``engine_latency_stats`` reports THIS engine's
    requests) and into the process-global registry the /metrics scrape
    renders. Reads come from the private series."""

    __slots__ = ("_local", "_global")

    def __init__(self, name: str, local_registry: MetricsRegistry):
        self._local = local_registry.histogram(name)
        self._global = _registry().histogram(name)

    def observe(self, value) -> None:
        self._local.observe(value)
        self._global.observe(value)

    def percentile(self, q: float) -> float:
        return self._local.percentile(q)

    def snapshot(self) -> dict:
        return self._local.snapshot()


# ---------------------------------------------------------------------------
# AnalysisPredictor: a bucketed static-graph inference model
# ---------------------------------------------------------------------------
class AnalysisPredictor:
    """Load an inference blob and run it at a ladder of batch buckets.

    ``model_dir`` is a ``static.save_inference_model`` directory
    (``__model__`` + params + MANIFEST.json), saved by either package.
    The blob is sha256-verified when the manifest is present, pruned to
    its feed->fetch subgraph, and run through a PRIVATE Scope (a serving
    process must not share mutable state with a trainer's global scope)
    on ``device`` (None: the card; ``"cpu"`` runs the plain versions).

    ``batch_buckets`` is the padded-batch ladder (ascending); ``warm()``
    runs every bucket once. ``donate_state`` is taken for the JAX
    signature: the port's executor updates no state at inference.
    """

    def __init__(self, model_dir: str,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 model_filename: Optional[str] = None,
                 params_filename: Optional[str] = None,
                 donate_state: bool = True, device=None):
        from ..io.serialization import load_pickle
        from ..io.snapshot import verify_file_manifest
        from ..static.executor import Executor, Scope, load_numpy_state
        from ..static.ir import Program

        buckets = sorted({int(b) for b in batch_buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"batch_buckets must be positive ints, got "
                             f"{batch_buckets!r}")
        self.batch_buckets: Tuple[int, ...] = tuple(buckets)
        self.model_dir = model_dir
        verify_file_manifest(os.path.join(model_dir, "MANIFEST.json"),
                             model_dir)
        blob = load_pickle(os.path.join(
            model_dir, model_filename or "__model__"))
        program = Program.from_dict(blob["program"])
        meta = blob["meta"]
        self.feed_names: List[str] = list(meta["feed_names"])
        self.fetch_names: List[str] = list(meta["fetch_names"])
        # re-prune defensively: hand-assembled blobs may carry dead ops
        self._program = program.prune(self.feed_names, self.fetch_names)
        state = load_pickle(os.path.join(
            model_dir, params_filename or "params.pdparams"))
        self._exe = Executor(device)
        self.device = self._exe.device
        self._scope = Scope()
        load_numpy_state(self._scope, state, self.device)
        block = self._program.global_block
        self._feed_specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}
        for name in self.feed_names:
            desc = block.vars[name]
            tail = tuple(int(d) for d in (desc.shape or ())[1:])
            if any(d < 0 for d in tail):
                raise ValueError(
                    f"feed {name!r} has a dynamic non-batch dim "
                    f"{desc.shape}; bucketed serving pads only the batch "
                    "dim")
            self._feed_specs[name] = (tail, np.dtype(desc.dtype))
        self._warmed = False

    # -- buckets ----------------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows``; ValueError past the ladder."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        raise ValueError(
            f"batch of {rows} rows exceeds the largest bucket "
            f"{self.max_batch}; raise batch_buckets or split the request")

    def pad_to_bucket(self, feed: Dict[str, np.ndarray], rows: int,
                      bucket: int) -> Dict[str, np.ndarray]:
        """Pad every feed's batch dim from ``rows`` to ``bucket`` by
        repeating the last row (finite by construction — zero padding can
        feed NaN-producing ops like 1/x normalizations)."""
        if rows == bucket:
            return feed
        out = {}
        for name, arr in feed.items():
            pad = np.repeat(arr[-1:], bucket - rows, axis=0)
            out[name] = np.concatenate([arr, pad], axis=0)
        return out

    def warm(self) -> int:
        """Run every bucket once (zeros) so the first real request pays
        no first-use cost; returns the number of buckets warmed."""
        for b in self.batch_buckets:
            feed = {name: np.zeros((b,) + tail, dtype)
                    for name, (tail, dtype) in self._feed_specs.items()}
            self._exe.run(self._program, feed=feed,
                          fetch_list=self.fetch_names, scope=self._scope)
        self._warmed = True
        return len(self.batch_buckets)

    # -- execution --------------------------------------------------------
    def run_batch(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """One batched run: pad the batch to its bucket, run the program
        on the device, slice the fetches back to the true row count."""
        rows = int(next(iter(feed.values())).shape[0])
        bucket = self.bucket_for(rows)
        padded = self.pad_to_bucket(feed, rows, bucket)
        outs = self._exe.run(self._program, feed=padded,
                             fetch_list=self.fetch_names,
                             scope=self._scope)
        return [o[:rows] if getattr(o, "ndim", 0) and o.shape[0] == bucket
                else o for o in outs]

    def run_eager(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Degraded leg: interpret the block row by row (batch 1) through
        ``run_block`` on the predictor's device, outside the executor's
        batched ``run``. Slow, but independent of the batched dispatch
        that just failed."""
        import torch

        from ..framework import random as random_mod
        from ..static.executor import live_ops, run_block
        from ..static.kernels import ExecContext

        block = self._program.global_block
        state = {n: self._scope.find_var(n) for n in block.vars
                 if block.vars[n].persistable
                 and self._scope.find_var(n) is not None}
        steps = live_ops(block, self.fetch_names)
        rows = int(next(iter(feed.values())).shape[0])
        seed = self._program.random_seed or random_mod.initial_seed()
        per_row: List[List[np.ndarray]] = []
        for i in range(rows):
            env = dict(state)
            for name, arr in feed.items():
                env[name] = self._exe._feed_tensor(
                    block, name, np.asarray(arr[i:i + 1]))
            ctx = ExecContext(device=self.device, seed=seed)
            with torch.no_grad():
                env = run_block(block, env, ctx, steps)
            per_row.append([env[n].detach().cpu().numpy()
                            for n in self.fetch_names])
        out: List[np.ndarray] = []
        for j in range(len(self.fetch_names)):
            parts = [r[j] for r in per_row]
            if parts[0].ndim == 0:
                # scalar/reduced fetch: the batched path delivers one
                # value for the whole batch (run_once's unsliced
                # branch); per-row eager can't recover the batch-wide
                # reduction, so degraded mode keeps the first row's —
                # best effort, not concatenable
                out.append(parts[0])
            else:
                out.append(np.concatenate(parts, axis=0))
        return out

    @property
    def counters(self) -> Dict[str, int]:
        """The executor's counters (``executor_steps``: batched runs,
        warm-up included). There is no compile cache, hence no
        ``compile_cache_*`` counters."""
        return dict(self._exe.counters)

    def memory_stats(self) -> Dict[str, int]:
        return self._exe.memory_stats()


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
class _PendingResult:
    """Caller-side handle: block on ``result()`` for the fetch list or
    the typed serving error."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value=None, error: Optional[BaseException] = None):
        # first write wins: a request failed in _dispatch (fallback
        # exhausted) must not be overwritten by the stitched zero rows
        # the respond loop walks past afterwards
        if self._event.is_set():
            return
        self._value, self._error = value, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still in flight")
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    __slots__ = ("feed", "rows", "sig", "deadline", "t_submit", "handle",
                 "degraded", "span", "qspan")

    def __init__(self, feed, rows, sig, deadline, t_submit):
        self.feed = feed
        self.rows = rows
        self.sig = sig
        self.deadline = deadline   # absolute clock() time or None
        self.t_submit = t_submit
        self.handle = _PendingResult()
        self.degraded = False
        # request-lifecycle trace: root span (admit -> respond, in the
        # flight recorder's in-flight table) + its open child for the
        # current wait (queue). The engine ends them typed.
        self.span: Optional[tracing.Span] = None
        self.qspan: Optional[tracing.Span] = None


# ---------------------------------------------------------------------------
# ServingEngine
# ---------------------------------------------------------------------------
class ServingEngine:
    """Continuous batching with admission control over a bucketed
    predictor. See the module docstring for semantics; construction
    knobs:

    max_queue          admission queue bound (beyond it: Overloaded)
    rate_limit/burst   token bucket, requests/sec + bucket capacity
                       (None disables)
    default_deadline_s applied when submit passes no deadline (None =
                       no deadline)
    min_service_s      admission-time estimate: a deadline closer than
                       this is unmakeable and expires immediately
    retry_attempts     per-batch dispatch budget through fault.Retrier
                       (attempts INCLUDING the first; 2 = one retry)
    clock / sleep      injectable time sources — every deadline/backoff
                       decision is testable without real waiting
    """

    def __init__(self, predictor: AnalysisPredictor, max_queue: int = 64,
                 rate_limit: Optional[float] = None,
                 burst: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 min_service_s: float = 0.0,
                 retry_attempts: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 tick_interval: float = 0.002):
        from ..fault.retry import Backoff, Retrier

        self.predictor = predictor
        self.max_queue = int(max_queue)
        self.default_deadline_s = default_deadline_s
        self.min_service_s = float(min_service_s)
        self._clock = clock
        self._sleep = sleep
        self._tick_interval = float(tick_interval)
        if rate_limit is not None and rate_limit <= 0:
            # 0 is falsy: a plain truthiness check would silently
            # DISABLE the limiter for an operator dialing it to zero
            raise ValueError(
                f"rate_limit must be > 0 req/s (got {rate_limit}); "
                f"pass None to disable rate limiting")
        if burst is not None and burst < 1:
            # a bucket that can never hold one whole token sheds 100%
            # of traffic forever — same silent-outage class the
            # rate_limit guard above refuses
            raise ValueError(
                f"burst must be >= 1 token (got {burst}); omit it to "
                f"default to max(1, rate_limit)")
        self._rate = float(rate_limit) if rate_limit is not None else None
        # default burst floors at one token: with rate_limit < 1 req/s
        # the bucket could otherwise never reach a whole token
        self._burst = float(burst) if burst is not None \
            else max(1.0, self._rate or 0.0)
        self._tokens = self._burst
        self._t_refill = clock()
        self._retrier = Retrier(
            max_attempts=max(1, int(retry_attempts)),
            retry_on=lambda e: not isinstance(e, ServingError),
            backoff=Backoff(base=0.005, cap=0.1, jitter=0.0),
            sleep=sleep, name="serve.dispatch")
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._inflight = 0
        self._accepting = True
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # leaf lock for the stats containers: the scheduler thread
        # mutates them outside _cond, and a monitoring caller iterating
        # a deque/dict mid-mutation raises RuntimeError
        self._stats_lock = threading.Lock()
        self._counters: _Counter = _Counter()
        self._lat_ms: deque = deque(maxlen=8192)
        self._fill_rows = 0
        self._fill_capacity = 0
        # engine-side latency histograms: the serving latency record no
        # longer depends on any client's view (dual-recorded: private
        # per-engine series + the process-global /metrics series)
        self._hist_reg = MetricsRegistry()
        self._h_queue_wait = _DualHist("serve_queue_wait_ms",
                                       self._hist_reg)
        self._h_assembly = _DualHist("serve_assembly_ms", self._hist_reg)
        self._h_dispatch = _DualHist("serve_dispatch_ms", self._hist_reg)
        self._h_e2e = _DualHist("serve_e2e_ms", self._hist_reg)

    # -- counters ---------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            self._counters[name] += n
        _bump(name, n)

    def _gauge(self, name: str, value) -> None:
        from .. import profiler

        with self._stats_lock:
            self._counters[name] = value
        profiler.set_counter(name, value)

    @property
    def counters(self) -> Dict[str, int]:
        """This engine's serving counters plus the process-global fault
        slice (retry_*, faults_injected, ...) — one dashboard, like
        ``exe.counters``."""
        from .. import profiler

        with self._stats_lock:
            out = dict(self._counters)
        snap = profiler.counters_snapshot()
        for name in profiler.FAULT_COUNTER_NAMES:
            if name in snap:
                out[name] = snap[name]
        return out

    def latency_stats(self) -> Dict[str, float]:
        """p50/p99/mean milliseconds over the last completed requests."""
        with self._stats_lock:
            lat_snapshot = list(self._lat_ms)
        if not lat_snapshot:
            return {"n": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        lat = np.asarray(lat_snapshot, dtype=np.float64)
        return {"n": int(lat.size),
                "p50_ms": round(float(np.percentile(lat, 50)), 3),
                "p99_ms": round(float(np.percentile(lat, 99)), 3),
                "mean_ms": round(float(lat.mean()), 3)}

    def engine_latency_stats(self) -> Dict[str, float]:
        """Engine-reported percentiles DERIVED FROM THE HISTOGRAM
        BUCKETS (serve_e2e_ms / serve_queue_wait_ms) — the latency
        record that exists server-side whatever any client measured,
        and exactly what a /metrics scraper can recompute."""
        e2e, qw = self._h_e2e, self._h_queue_wait
        return {
            "n": int(e2e.snapshot()["count"]),
            "e2e_p50_ms": round(e2e.percentile(50), 3),
            "e2e_p99_ms": round(e2e.percentile(99), 3),
            "queue_wait_p50_ms": round(qw.percentile(50), 3),
            "queue_wait_p99_ms": round(qw.percentile(99), 3),
        }

    @property
    def ready(self) -> bool:
        """Readiness: admitting, past predictor warmup, AND the
        scheduler is running — a warmed engine whose start() was
        forgotten would admit requests that nothing ever dispatches,
        while /readyz keeps telling the load balancer to route to it."""
        return self._accepting and self._running \
            and self.predictor._warmed

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- admission --------------------------------------------------------
    @staticmethod
    def _feed_sig(feed: Dict[str, np.ndarray]) -> tuple:
        return tuple(sorted((k, tuple(v.shape[1:]), str(v.dtype))
                            for k, v in feed.items()))

    def _take_token(self, now: float) -> bool:
        if self._rate is None:
            return True
        self._tokens = min(self._burst,
                           self._tokens + (now - self._t_refill)
                           * self._rate)
        self._t_refill = now
        if self._tokens < 1.0:
            return False
        self._tokens -= 1.0
        return True

    def submit(self, feed: Dict[str, Any],
               deadline_s: Optional[float] = None) -> _PendingResult:
        """Admit one request (``feed``: name → array with a leading batch
        dim) and return its pending handle. Raises the typed admission
        errors synchronously; everything past admission resolves through
        the handle."""
        from ..fault import injector as _fault

        feed = {k: np.asarray(v) for k, v in feed.items()}
        if set(feed) != set(self.predictor.feed_names):
            raise ValueError(
                f"feed names {sorted(feed)} != model feeds "
                f"{sorted(self.predictor.feed_names)}")
        rows = int(next(iter(feed.values())).shape[0])
        if rows < 1:
            raise ValueError("request carries zero rows")
        for k, v in feed.items():
            if v.shape[0] != rows:
                raise ValueError(
                    f"inconsistent batch dims in feed: {k!r} has "
                    f"{v.shape[0]} rows, expected {rows}")
        if rows > self.predictor.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds the largest batch "
                f"bucket {self.predictor.max_batch}; split the request")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        # request-root span: created on the CALLER's thread so an
        # ambient client context (an upstream service) parents
        # it; a typed admission failure ends it with that error's name
        root = tracing.Span("serve.request", clock=self._clock,
                            root=True, rows=rows)
        try:
            with self._cond:
                # clock read under the lock: concurrent submitters
                # reading timestamps outside it can apply them out of
                # order in _take_token, shrinking the bucket and
                # rewinding _t_refill
                now = self._clock()
                if not self._accepting:
                    raise EngineStopped(
                        "serving engine is draining/stopped; "
                        "not admitting")
                _fault.point("serve.admit")
                if deadline_s is not None and \
                        deadline_s <= self.min_service_s:
                    self._count("serve_deadline_expired")
                    raise DeadlineExceeded(
                        f"deadline {deadline_s}s cannot be met "
                        f"(min service estimate {self.min_service_s}s)")
                # queue-depth first: it is side-effect-free, so a
                # queue-full shed never burns a rate token
                # (double-punishing bursts)
                if len(self._queue) >= self.max_queue:
                    self._count("serve_shed")
                    raise Overloaded(
                        f"admission queue full ({self.max_queue})")
                if not self._take_token(now):
                    self._count("serve_shed")
                    raise Overloaded(
                        f"rate limit {self._rate} req/s exceeded "
                        f"(burst {int(self._burst)})")
                req = _Request(
                    feed, rows, self._feed_sig(feed),
                    None if deadline_s is None else now + deadline_s,
                    now)
                req.span = root
                req.qspan = tracing.Span("serve.queue", parent=root,
                                         clock=self._clock)
                self._queue.append(req)
                self._count("serve_requests")
                self._gauge("serve_queue_depth", len(self._queue))
                self._cond.notify_all()
        except BaseException as e:
            # typed sheds AND armed admission faults: the root span must
            # not leak into the in-flight table
            root.fail(e)
            raise
        return req.handle

    def infer(self, feed: Dict[str, Any],
              deadline_s: Optional[float] = None,
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Blocking convenience: submit + wait for the fetch list."""
        return self.submit(feed, deadline_s=deadline_s).result(timeout)

    # -- scheduling -------------------------------------------------------
    def _expire(self, reqs: List[_Request], now: float) -> None:
        for r in reqs:
            self._count("serve_deadline_expired")
            err = DeadlineExceeded(
                f"deadline passed before completion "
                f"({now - r.t_submit:.3f}s since submit)")
            self._end_trace(r, err)
            r.handle._resolve(error=err)

    @staticmethod
    def _end_trace(r: _Request,
                   error: Optional[BaseException] = None) -> None:
        """Close a request's open spans with the typed status (first
        end wins, like the handle resolve)."""
        if r.qspan is not None:
            r.qspan.end("ok" if error is None
                        else type(error).__name__)
        if r.span is not None:
            if r.degraded:
                r.span.set("degraded", True)
            if error is None:
                r.span.end()
            else:
                r.span.fail(error)

    def _assemble(self) -> List[_Request]:
        """Pop one batch: drop expired requests, then pack the oldest
        request's signature greedily up to the largest bucket."""
        t0 = time.perf_counter()
        now = self._clock()
        with self._cond:
            expired = [r for r in self._queue
                       if r.deadline is not None and now >= r.deadline]
            if expired:
                kept = deque(r for r in self._queue if r not in expired)
                self._queue = kept
            if not self._queue:
                batch: List[_Request] = []
            else:
                head = self._queue[0]
                cap = self.predictor.max_batch
                batch, rows, rest = [], 0, deque()
                for r in self._queue:
                    if r.sig == head.sig and rows + r.rows <= cap:
                        batch.append(r)
                        rows += r.rows
                    else:
                        rest.append(r)
                self._queue = rest
            self._inflight += len(batch)
            self._gauge("serve_queue_depth", len(self._queue))
        if expired:
            self._expire(expired, now)
        if batch:
            self._h_assembly.observe((time.perf_counter() - t0) * 1e3)
            for r in batch:
                # queue wait ends when the request makes it into a batch
                self._h_queue_wait.observe(max(0.0, now - r.t_submit)
                                           * 1e3)
                if r.qspan is not None:
                    r.qspan.end()
        return batch

    def run_once(self) -> int:
        """One synchronous scheduler tick: assemble, dispatch, respond.
        Returns the number of requests resolved (served OR failed) this
        tick — the deterministic drive used by tests; the background
        thread calls this in a loop."""
        from ..fault import injector as _fault

        try:
            _fault.point("serve.assemble")
        except BaseException:
            # assembly faults are transient by definition (nothing was
            # popped yet): leave the queue intact for the next tick
            return 0
        batch = self._assemble()
        if not batch:
            return 0
        total_rows = sum(r.rows for r in batch)
        resolved = 0
        try:
            results = self._dispatch(batch)
            now = self._clock()
            offset = 0
            for r in batch:
                # slice only batched fetches; a scalar/whole-batch fetch
                # (0-d mean, reduced metric) is delivered as-is
                sl = [f[offset:offset + r.rows]
                      if getattr(f, "ndim", 0) and f.shape[0] == total_rows
                      else f for f in results]
                offset += r.rows
                resolved += 1
                if r.handle.done():
                    continue   # failed in _dispatch (fallback exhausted)
                if r.deadline is not None and now >= r.deadline:
                    self._count("serve_deadline_expired")
                    err = DeadlineExceeded(
                        "completed after its deadline; result dropped")
                    self._end_trace(r, err)
                    r.handle._resolve(error=err)
                    continue
                try:
                    _fault.point("serve.respond")
                except BaseException as e:
                    self._end_trace(r, e)
                    r.handle._resolve(error=e)
                    continue
                if r.degraded:
                    self._count("serve_degraded")
                e2e_ms = (now - r.t_submit) * 1e3
                with self._stats_lock:
                    self._lat_ms.append(e2e_ms)
                self._h_e2e.observe(e2e_ms)
                self._end_trace(r)
                r.handle._resolve(value=sl)
        except BaseException as e:
            # no unexpected error may leave a handle unresolved (the
            # caller would block forever) or kill the scheduler thread:
            # fail the batch's remaining requests typed and keep serving
            noted = False
            for r in batch:
                if not r.handle.done():
                    self._count("serve_failed")
                    err = RequestFailed(
                        f"internal serving error: "
                        f"{type(e).__name__}: {e}")
                    self._end_trace(r, err)
                    if not noted:
                        # once per failed BATCH: a 32-request batch
                        # must not write 32 identical postmortems on
                        # the scheduler thread mid-incident
                        note_typed_error(err, where="serve.run_once")
                        noted = True
                    r.handle._resolve(error=err)
            resolved = len(batch)
        finally:
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()
        return resolved

    def _dispatch(self, batch: List[_Request]) -> List[np.ndarray]:
        """Batched dispatch with retry, then the per-request row-by-row
        fallback. Returns the fetch arrays for the CONCATENATED batch
        rows (fallback results are stitched to the same layout)."""
        from ..fault import injector as _fault

        feed = {name: np.concatenate([r.feed[name] for r in batch],
                                     axis=0)
                for name in self.predictor.feed_names}
        rows = sum(r.rows for r in batch)
        bucket = self.predictor.bucket_for(rows)
        self._fill_rows += rows
        self._fill_capacity += bucket
        self._gauge("serve_batch_fill_pct",
                    round(100.0 * self._fill_rows
                          / max(1, self._fill_capacity), 2))

        # one batch-level span: no single parent (requests fan in), so
        # the member request traces ride as an attribute; activated so
        # any RPC inside the predictor links under it
        dspan = tracing.Span(
            "serve.dispatch", parent=False, clock=self._clock,
            rows=rows, bucket=bucket, n_requests=len(batch),
            requests=[format(r.span.trace_id, "016x")
                      for r in batch if r.span is not None])

        def _batched():
            _fault.point("serve.dispatch")
            with dspan.activate():
                return self.predictor.run_batch(feed)

        t0 = time.perf_counter()
        try:
            out = self._retrier.call(_batched)
            self._h_dispatch.observe((time.perf_counter() - t0) * 1e3)
            self._count("serve_batches")
            dspan.end()
            return out
        except ServingError as e:
            dspan.fail(e)
            raise
        except BaseException as dispatch_err:
            dspan.fail(dispatch_err)
            # degrade: row by row per request; a request whose
            # fallback also fails is failed typed, the others survive
            per_req: List[Optional[List[np.ndarray]]] = []
            fb_noted = False
            for r in batch:
                try:
                    _fault.point("serve.fallback")
                    per_req.append(self.predictor.run_eager(r.feed))
                    r.degraded = True
                except BaseException as fb_err:
                    self._count("serve_failed")
                    err = RequestFailed(
                        f"dispatch failed after "
                        f"{self._retrier.max_attempts} attempts "
                        f"({type(dispatch_err).__name__}: {dispatch_err})"
                        f" and the degraded fallback failed too "
                        f"({type(fb_err).__name__}: {fb_err})")
                    if not fb_noted:
                        # once per batch (see run_once's failure path)
                        note_typed_error(err, where="serve.fallback")
                        fb_noted = True
                    self._end_trace(r, err)
                    r.handle._resolve(error=err)
                    per_req.append(None)
            # stitch survivors back into batch-row layout; failed
            # requests contribute zero-filled rows (their handles are
            # already resolved — the rows are never delivered)
            nfetch = len(self.predictor.fetch_names)
            stitched = []
            for j in range(nfetch):
                proto = next((np.asarray(q[j]) for q in per_req
                              if q is not None), None)
                if proto is not None and proto.ndim == 0:
                    # scalar fetch: run_once delivers it to every
                    # request unsliced, so no row stitching applies
                    stitched.append(proto)
                    continue
                parts = []
                for r, res in zip(batch, per_req):
                    if res is not None:
                        parts.append(np.asarray(res[j]))
                    else:
                        shape = ((r.rows,) + proto.shape[1:]
                                 if proto is not None else (r.rows,))
                        dtype = (proto.dtype if proto is not None
                                 else np.float32)
                        parts.append(np.zeros(shape, dtype))
                stitched.append(np.concatenate(parts, axis=0))
            return stitched

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Run the scheduler on a background thread (continuous
        batching); idempotent."""
        with self._cond:
            if self._running:
                return self
            stale = self._thread
        if stale is not None:
            # a stopped scheduler may still be finishing its last tick
            # (stop()'s bounded join expired); two loops must never
            # share the queue, so wait it out before flipping _running
            # — flipping first would also revive the old loop
            stale.join()
        with self._cond:
            if self._running:
                return self
            self._running = True
            # re-open admission: a start() after stop() must serve, not
            # run a scheduler that rejects every submit as stopped
            self._accepting = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-scheduler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(timeout=0.05)
                if not self._running:
                    # stop() semantics: queued requests stay queued
                    # (drain() empties the queue before flipping
                    # _running, so a drain still flushes everything)
                    return
            try:
                resolved = self.run_once()
            except BaseException:
                # run_once fails batches internally; this is the last
                # line of defense — the scheduler thread must survive
                resolved = 0
            if resolved == 0 and self._queue:
                # nothing resolvable this tick (e.g. armed assemble
                # fault): yield briefly instead of spinning
                self._sleep(self._tick_interval)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, flush every queued and
        in-flight request, then stop the scheduler. Returns True when
        the flush completed (always, unless ``timeout`` expired first).
        Synchronous-mode engines are flushed inline."""
        with self._cond:
            self._accepting = False
            threaded = self._running
            self._cond.notify_all()
        if not threaded:
            while self.run_once():
                pass
            with self._cond:
                return not self._queue and self._inflight == 0
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = None if deadline is None else \
                    deadline - self._clock()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=0.05 if remaining is None
                                else min(0.05, remaining))
        self.stop()
        return True

    def stop(self) -> None:
        """Stop the scheduler thread (queued requests stay queued; use
        drain() for a flush)."""
        with self._cond:
            self._running = False
            self._accepting = False
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            if not t.is_alive():
                # a straggler (mid-dispatch past the join window) stays
                # referenced so a later start() can wait it out instead
                # of racing a second scheduler onto the queue
                self._thread = None


# ---------------------------------------------------------------------------
# SIGTERM → graceful drain
# ---------------------------------------------------------------------------
def install_sigterm_drain(engine,
                          on_drained: Optional[Callable[[], None]] = None,
                          exit_code: Optional[int] = 0,
                          drain_timeout: Optional[float] = 30.0) -> None:
    """Make SIGTERM drain ``engine`` (stop admitting, flush in-flight
    batches) and exit ``exit_code`` — the contract a supervised server
    needs when its supervisor forwards SIGTERM (the reference's
    ``launch.Supervisor``; the port's supervisor is a later slice).

    ``engine`` is duck-typed on ``drain(timeout=...) -> bool``: a
    ``ServingEngine``, a ``DecodeEngine``, or a
    ``serving.FleetRouter`` (which drains its own admission first,
    then every replica) all satisfy it. Pass
    ``exit_code=None`` to keep the process alive after the drain (the
    caller owns the exit); ``on_drained`` runs after the flush, before
    any exit. The flush is bounded by ``drain_timeout`` (seconds, the
    reference supervisor's drain_window default): a wedged dispatch
    must not turn SIGTERM into a no-op that only SIGKILL resolves —
    past the window the process exits anyway."""
    import signal as _signal

    def _drain_and_exit():
        drained = engine.drain(timeout=drain_timeout)
        try:
            from ..observability.flight_recorder import flight_recorder

            fr = flight_recorder()
            fr.record("sigterm_drain", drained=bool(drained))
            fr.dump(reason="sigterm_drain")
        except Exception:
            pass   # the postmortem writer must not block the drain exit
        if on_drained is not None:
            on_drained()
        if exit_code is not None:
            os._exit(exit_code)

    def _handler(signum, frame):
        # the handler interrupts the main thread mid-bytecode — possibly
        # inside submit()'s critical section on engine._cond. Draining
        # inline would re-enter that RLock and its cond.wait() would
        # release the interrupted frame's lock mid-critical-section, so
        # the only safe action here is a hand-off (the
        # Supervisor.request_stop flag pattern): flush on a fresh
        # thread, non-daemon so the process survives until it finishes.
        threading.Thread(target=_drain_and_exit, daemon=False,
                         name="serving-sigterm-drain").start()

    _signal.signal(_signal.SIGTERM, _handler)


# ---------------------------------------------------------------------------
# health/readiness over the hardened http_kv scaffolding
# ---------------------------------------------------------------------------
class ServingHealthServer:
    """Liveness + readiness probes riding ``KVHTTPServer`` (body cap and
    per-connection timeout included): GET /healthz is 200 while the
    process serves HTTP at all; GET /readyz is 200 only when the engine
    is warmed and admitting (503 while warming or draining — the load
    balancer stops routing before shutdown). Other paths keep the KV
    GET/PUT/DELETE semantics."""

    def __init__(self, engine: ServingEngine, port: int = 0,
                 host: str = "127.0.0.1",
                 request_timeout: Optional[float] = 10.0,
                 max_body_bytes: int = 1 << 20):
        from ..distributed.http_kv import KVHandler, KVHTTPServer

        class _Handler(KVHandler):
            def do_GET(handler):  # noqa: N805 (handler-local self)
                if handler.path == "/healthz":
                    handler.send_response(200)
                    handler.send_header("Content-Length", "2")
                    handler.end_headers()
                    handler.wfile.write(b"ok")
                    return
                if handler.path == "/readyz":
                    code = 200 if engine.ready else 503
                    body = b"ready" if code == 200 else b"not ready"
                    handler.send_response(code)
                    handler.send_header("Content-Length",
                                        str(len(body)))
                    handler.end_headers()
                    handler.wfile.write(body)
                    return
                KVHandler.do_GET(handler)

        self.engine = engine
        self._server = KVHTTPServer(port, _Handler, host=host,
                                    max_body_bytes=max_body_bytes,
                                    request_timeout=request_timeout)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "ServingHealthServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serving-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            # shutdown() blocks on an event only serve_forever() sets —
            # calling it on a never-started server would hang forever
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()
