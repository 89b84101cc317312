"""LLM decode engine: continuous batching over a paged KV pool with one
ragged decode step per tick.

Port of ``paddle_tpu/inference/decode/engine.py``. A request's prompt is
PREFILLED once (dense forward, K/V scattered into its allocated pages),
then joins a fixed ladder of decode SLOTS; every engine tick runs one
decode step at ``max_batch`` that advances EVERY live sequence by one
token, ragged via the page table, through the paged attention kernel.
The pool tensors are updated in place. A tick's host-to-device traffic
is at most one packed int32 control buffer (and the Gumbel noise when
sampling), always from pinned memory.

ASYNC TICKS (``async_decode``; ``None``, the default, turns them on for
greedy engines without speculation, as the reference does): the step's
next tokens stay ON THE DEVICE and feed the next step directly, with a
``torch.where`` splicing host-injected tokens (fresh prefills, resumed
sessions) over the chain; the next positions come out of the step too.
Tick ``t+1`` is enqueued before tick ``t``'s tokens are fetched, so the
host's work (EOS checks, admission, page growth) overlaps the device's.
The fetch is a ``non_blocking`` copy into one of two pinned host
buffers, in turn, with a CUDA event recorded after it; the harvest waits
on that event alone. A steady tick (same slots, no page-table mutation
since the last dispatch) uploads nothing. Park, preempt, reset, adopt
and stop drain the in-flight tick first, so greedy output is bitwise the
synchronous tick's; at EOS the one extra token in flight is discarded.
Sampling and speculative ticks stay synchronous. On the CPU the same
code runs on plain tensors. ``decode_tick_phase_ms{phase=dispatch|host|
fetch}`` splits the tick and ``decode_overlap_frac`` gauges the share of
it not spent waiting on the device.

SPECULATIVE DECODING (``spec_k > 0``): drafts from ``proposer`` (default
n-gram prompt lookup) are verified in ONE ragged step over B·(K+1) rows
(``spec_decode_forward``); the accepted prefix is bitwise greedy's.

HOST KV TIER (``host_kv_bytes > 0``): a :class:`~.kv_cache.HostKVPool`
below the device pool. Under pool pressure the scheduler PARKS the
coldest slot (pages encoded int8 per token row) instead of preempting
it, reclaimed prefix pages spill there, and parked sessions resume
through a background prefetcher that stages the pages on the card on a
stream of its own (a typed ``KVRestoreError`` falls back to a
synchronous restore). int8 pools park verbatim, so park -> resume is
bitwise.

PAGE ADOPTION (:meth:`DecodeEngine.adopt_pages`): a prefill page frame
(``serving/disagg.py``) becomes cached prefix pages, applied on the
scheduler thread between ticks.

Sampling (``temperature > 0``) draws Gumbel noise from
``np.random.RandomState(sample_seed)`` on the host, in the same order
as the JAX engine (one (1, V) draw per prefill, one (B, V) draw per
tick), and feeds it to the fused sampling kernel, so a seeded run
replays token for token.

Pools: ``kv_codec="off"`` keeps them in ``dtype`` (float32, bfloat16 or
float16; params stay float32, as in the reference), ``"int8"`` in int8
with per-token-row f32 scales. Per-step cost gauges (``step_model_flops``
/ ``step_hbm_bytes`` / ``arith_intensity`` / ``mfu``) come from
``static.cost_model.paged_decode_cost``. Not in this slice: tensor
parallelism (``mesh_shape`` raises ``NotImplementedError``).
"""
from __future__ import annotations

import threading
import time
from collections import Counter as _Counter, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..._device import resolve_device
from ...observability import tracing
from ...observability.metrics import MetricsRegistry, default_registry
from ...ops.cuda import _build
from ...ops.cuda.paged_attention import (paged_prefill_write,
                                         paged_prefill_write_quant)
from ...ops.cuda.sampling import fused_sample
from ..serving import (DeadlineExceeded, KVRestoreError, RequestFailed,
                       _DualHist)
from .kv_cache import (HostKVPool, PageTableManager, _chain_keys,
                       alloc_kv_pool, alloc_kv_scales)
from .model import (DecodeModelConfig, decode_forward, init_decode_params,
                    params_from_numpy, prefill_forward, spec_decode_forward)
from .scheduler import DecodeRequest, DecodeScheduler, RunningSeq
from .spec import NgramProposer

__all__ = ["DecodeEngine"]

_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _later_slice(what: str):
    return NotImplementedError(f"{what} comes in a later port slice")


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``. On the card the copy goes through pinned
    memory with ``non_blocking``: a copy from pageable memory would wait
    for the stream first, which is a hidden synchronisation."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _RestorePrefetcher:
    """Background restore staging: a parked session's records are
    decoded on the host and copied to the card on a stream of its own
    the moment it parks, so a resume usually finds its pages READY and
    pays only the device writes. ``take`` returns ``(arrays, event)``:
    the caller's stream waits on ``event`` (None on the CPU) before it
    reads the arrays. It raises the typed :class:`KVRestoreError` when
    the worker died, staging failed or the wait timed out; the engine
    then restores synchronously (correctness never depends on it)."""

    def __init__(self, decode_fn, device: torch.device):
        self._decode = decode_fn
        self._device = device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._lock = threading.Lock()
        self._staged: Dict[int, dict] = {}
        self._queue: deque = deque()
        self._wake = threading.Event()
        self._alive = True
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="kv-restore-prefetch")
        self._thread.start()

    def request(self, key: int, records) -> None:
        """Idempotently stage a parked session's restore."""
        with self._lock:
            if key in self._staged:
                return
            self._staged[key] = {"ready": threading.Event(),
                                 "arrays": None, "event": None,
                                 "error": None}
            self._queue.append((key, list(records)))
        self._wake.set()

    def _stage(self, records):
        arrays = [self._decode(r) for r in records]
        if self._stream is None:
            return [tuple(torch.from_numpy(a) for a in arr)
                    for arr in arrays], None
        with torch.cuda.stream(self._stream):
            staged = [tuple(_h2d(a, self._device) for a in arr)
                      for arr in arrays]
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _run(self) -> None:
        while self._alive:
            if not self._wake.wait(timeout=0.1):
                continue
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    key, records = self._queue.popleft()
                    ent = self._staged.get(key)
                if ent is None:
                    continue   # discarded while queued
                try:
                    ent["arrays"], ent["event"] = self._stage(records)
                except BaseException as e:
                    ent["error"] = e
                ent["ready"].set()

    def take(self, key: int, timeout: float = 2.0):
        """The staged ``(arrays, event)`` for ``key`` (waits for a
        staging in progress); raises :class:`KVRestoreError` when
        nothing was staged, the worker died, staging failed, or the
        wait timed out."""
        with self._lock:
            ent = self._staged.get(key)
        if ent is None:
            raise KVRestoreError(
                f"no staged restore for parked session {key}")
        if not ent["ready"].is_set() and not self._thread.is_alive():
            raise KVRestoreError(
                "restore prefetcher thread died; falling back to a "
                "synchronous restore")
        if not ent["ready"].wait(timeout):
            raise KVRestoreError(
                f"restore staging for session {key} timed out "
                f"after {timeout}s")
        with self._lock:
            self._staged.pop(key, None)
        if ent["error"] is not None:
            raise KVRestoreError(
                f"restore staging failed: "
                f"{type(ent['error']).__name__}: {ent['error']}")
        return ent["arrays"], ent["event"]

    def discard(self, key: int) -> None:
        with self._lock:
            self._staged.pop(key, None)

    def stop(self) -> None:
        self._alive = False
        self._wake.set()


class DecodeEngine:
    """Paged continuous-batching decode engine. Construction knobs:

    config / params      DecodeModelConfig (+ optional ready params, a
                         dict of tensors or numpy arrays keyed as the
                         JAX package keys them, see ``params_from_numpy``;
                         omitted: random init from ``seed`` on the
                         device)
    device               where the model and pool live (default: the
                         card; ``"cpu"`` runs the plain kernel versions)
    max_batch            decode slots (the decode step's batch)
    n_pages / page_size  KV pool geometry (page 0 reserved)
    max_pages_per_seq    page-table width per sequence
    max_queue, rate_limit/burst, default_deadline_s, min_service_s
                         admission semantics (typed sheds)
    eos_id               optional stop token
    dtype                the pool's dtype when ``kv_codec="off"``:
                         "float32", "bfloat16" or "float16" (params
                         stay float32)
    kv_codec             "off" (pool in ``dtype``) or "int8" (int8 pages
                         with per-token-row f32 scales, dequantised
                         inside the attention kernel)
    host_kv_bytes        host-RAM KV tier budget in bytes (0 = off):
                         under pool pressure the coldest slot PARKS its
                         pages there instead of being preempted
    spec_k / proposer    speculative drafts per slot per tick (0 = off)
                         and their source (default: n-gram prompt
                         lookup); greedy only
    async_decode         None: async ticks for greedy engines without
                         speculation; False pins the synchronous tick;
                         True asks for it (greedy only)
    temperature/top_k/top_p/sample_seed
                         sampling controls (temperature 0 = greedy)
    clock / sleep        injectable time sources (deterministic tests)
    """

    def __init__(self, config: DecodeModelConfig,
                 params: Optional[Dict[str, object]] = None,
                 seed: int = 0, max_batch: int = 4,
                 n_pages: int = 64, page_size: int = 16,
                 max_pages_per_seq: int = 8,
                 mesh_shape: Optional[Dict[str, int]] = None,
                 max_queue: int = 64,
                 rate_limit: Optional[float] = None,
                 burst: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 min_service_s: float = 0.0,
                 eos_id: Optional[int] = None,
                 dtype: str = "float32",
                 kv_codec: str = "off",
                 host_kv_bytes: int = 0,
                 spec_k: int = 0, proposer=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, sample_seed: int = 0,
                 clock=time.monotonic, sleep=time.sleep,
                 tick_interval: float = 0.002, device=None,
                 async_decode: Optional[bool] = None):
        if mesh_shape:
            raise _later_slice("tensor-parallel serving (mesh_shape)")
        if dtype not in _POOL_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_POOL_DTYPES)}, "
                             f"got {dtype!r}")
        self.config = config
        if config.max_context < max_pages_per_seq * page_size:
            raise ValueError(
                f"config.max_context={config.max_context} is smaller "
                f"than the page budget {max_pages_per_seq}x{page_size}; "
                f"positions past it would alias positional embeddings")
        if n_pages - 1 < max_pages_per_seq:
            raise ValueError(
                f"pool of {n_pages} pages (1 reserved) cannot hold even "
                f"one full sequence of {max_pages_per_seq} pages")
        if kv_codec not in ("off", "int8"):
            raise ValueError(f"kv_codec must be 'off' or 'int8', got "
                             f"{kv_codec!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.eos_id = eos_id
        self._clock = clock
        self._sleep = sleep
        self._tick_interval = float(tick_interval)
        self._dtype = dtype
        self._kv_codec = kv_codec
        self._pool_dtype = torch.int8 if kv_codec == "int8" \
            else _POOL_DTYPES[dtype]
        self._spec_k = int(spec_k)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        if self._spec_k and self._temperature > 0:
            raise ValueError(
                "speculative decoding verifies against greedy argmax; "
                "it requires temperature=0 (got "
                f"temperature={temperature})")
        if async_decode and self._temperature > 0:
            raise ValueError(
                "the async tick is greedy only: sampling engines keep the "
                "synchronous tick (an extra tick at EOS would consume "
                "Gumbel noise)")
        # on by default for greedy engines without speculation; a spec
        # engine's verify ticks are synchronous whatever this says
        self._async_decode = bool(async_decode) if async_decode is not None \
            else (self._temperature == 0 and self._spec_k == 0)
        self.proposer = proposer if proposer is not None \
            else NgramProposer()
        self._sample_rng = np.random.RandomState(int(sample_seed))

        self.pool = PageTableManager(n_pages, page_size, max_pages_per_seq)
        self.sched = DecodeScheduler(
            self.pool, max_batch, max_queue=max_queue,
            rate_limit=rate_limit, burst=burst,
            default_deadline_s=default_deadline_s,
            min_service_s=min_service_s, clock=clock)
        self.sched._count = self._count

        self.params = init_decode_params(config, seed, self.device) \
            if params is None else params_from_numpy(params, self.device)
        self._alloc_pool()
        self._warmed = False
        self._device_kind = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else self.device.type

        # -- async tick state ------------------------------------------------
        self._inflight: Optional[dict] = None   # the depth-1 lagged tick
        self._chain = None       # device (B,) tokens of the last dispatch
        self._pos_chain = None   # device (B,) next positions (step output)
        self._steady_sig = None  # (slot set, pool mutation epoch)
        self._tab_dev = None     # device table/mask of the last rebuild
        self._mask_dev = None
        pin = self.device.type == "cuda"
        self._fetch_bufs = [torch.zeros((self.max_batch,), dtype=torch.int32,
                                        pin_memory=pin) for _ in range(2)]
        self._fetch_i = 0

        # -- host KV tier ----------------------------------------------------
        self._offload: Optional[HostKVPool] = None
        self._prefetch: Optional[_RestorePrefetcher] = None
        if int(host_kv_bytes) > 0:
            self._offload = HostKVPool(
                config.n_layers, page_size, config.n_heads,
                config.head_dim, int(host_kv_bytes))
            self.pool.spill_sink = self._spill_prefix_page
            self._prefetch = _RestorePrefetcher(self._decode_record,
                                                self.device)

        # -- observability ---------------------------------------------------
        self._counters: _Counter = _Counter()
        self._stats_lock = threading.Lock()
        self._fill_rows = 0
        self._fill_capacity = 0
        self._hist_reg = MetricsRegistry()
        self._h_prefill = _DualHist("decode_prefill_ms", self._hist_reg)
        self._h_step = _DualHist("decode_step_ms", self._hist_reg)
        self._h_e2e = _DualHist("decode_e2e_ms", self._hist_reg)
        self._h_restore = _DualHist("kv_restore_wait_ms", self._hist_reg)
        # tick phase split (dispatch / host / fetch) feeding the
        # decode_overlap_frac gauge: 1 - fetch/total, the share of the
        # tick wall NOT spent blocked on the device
        self._phase_h = default_registry().histogram(
            "decode_tick_phase_ms", labels=("phase",))
        self._phase_ms = {"dispatch": 0.0, "host": 0.0, "fetch": 0.0}

        self._running = False
        self._thread: Optional[threading.Thread] = None
        # page frames posted from any thread, adopted on the scheduler
        # thread between ticks
        self._adoptions: deque = deque()

        # the process's /metrics listener when PADDLE_METRICS_PORT is set
        from ...observability.server import maybe_start_metrics_server

        maybe_start_metrics_server()

    def _alloc_pool(self) -> None:
        cfg = self.config
        self._k_pages, self._v_pages = alloc_kv_pool(
            cfg.n_layers, self.pool.n_pages, self.pool.page_size,
            cfg.n_heads, cfg.head_dim, dtype=self._pool_dtype,
            device=self.device)
        self._k_scales = self._v_scales = None
        if self._kv_codec == "int8":
            self._k_scales, self._v_scales = alloc_kv_scales(
                cfg.n_layers, self.pool.n_pages, self.pool.page_size,
                device=self.device)

    # -- counters ---------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        from ... import profiler

        with self._stats_lock:
            self._counters[name] += n
        profiler.bump_counter(name, n)

    def _gauge(self, name: str, value) -> None:
        from ... import profiler

        with self._stats_lock:
            self._counters[name] = value
        profiler.set_counter(name, value)

    @property
    def counters(self) -> Dict[str, int]:
        """This engine's decode counters plus the pool gauges."""
        with self._stats_lock:
            out = dict(self._counters)
        out["kv_pages_in_use"] = self.pool.pages_in_use
        out["kv_page_evictions"] = self.pool.evicted_pages
        out["kv_pages_shared"] = self.pool.pages_shared
        out["kv_pages_cached"] = self.pool.pages_cached
        out["kv_prefix_hits"] = self.pool.prefix_hits
        if self._offload is not None:
            out["kv_pages_host"] = self._offload.pages_host
            out["kv_pages_parked"] = self.pool.parked_pages
        return out

    def kv_debug_snapshot(self) -> dict:
        """JSON-ready page-pool state: the manager's snapshot (tables,
        refcounts, shared/cached/indexed pages) plus this engine's
        codec/spec configuration, its host tier and its decode
        counters."""
        snap = self.pool.snapshot()
        snap["kv_codec"] = self._kv_codec
        snap["spec_k"] = self._spec_k
        snap["max_batch"] = self.max_batch
        snap["async_decode"] = self._async_decode
        if self._offload is not None:
            snap["host_tier"] = self._offload.snapshot()
            snap["host_tier"]["parked_sessions"] = len(self.sched.parked)
        with self._stats_lock:
            snap["counters"] = {
                k: v for k, v in sorted(self._counters.items())
                if k.startswith(("spec_", "kv_", "decode_"))}
        return snap

    def engine_latency_stats(self) -> Dict[str, float]:
        """Bucket-derived engine-side percentiles of decode_e2e_ms /
        decode_step_ms / decode_prefill_ms (and kv_restore_wait_ms with
        a host tier)."""
        out = {
            "n": int(self._h_e2e.snapshot()["count"]),
            "e2e_p50_ms": round(self._h_e2e.percentile(50), 3),
            "e2e_p99_ms": round(self._h_e2e.percentile(99), 3),
            "step_p50_ms": round(self._h_step.percentile(50), 3),
            "step_p99_ms": round(self._h_step.percentile(99), 3),
            "prefill_p50_ms": round(self._h_prefill.percentile(50), 3),
            "prefill_p99_ms": round(self._h_prefill.percentile(99), 3),
        }
        if self._offload is not None:
            out["restore_wait_p99_ms"] = round(
                self._h_restore.percentile(99), 3)
        return out

    def tick_phase_totals(self) -> Dict[str, float]:
        """This engine's summed tick phases in ms (dispatch: building
        and enqueueing a tick; host: harvesting its tokens; fetch:
        waiting for the device), the sums behind
        ``decode_overlap_frac``."""
        with self._stats_lock:
            return dict(self._phase_ms)

    def warm(self) -> int:
        """Build the CUDA kernels and run one decode step with every
        slot masked (its writes land on the trash page) before serving,
        so no request pays a compile or a library's first-call set-up.
        Returns the number of kernel libraries ready (0 on the CPU)."""
        n = 0
        if self.device.type == "cuda":
            _build.build_all()
            n = len(_build.sources())
        B, T = self.max_batch, self.pool.max_pages_per_seq
        zeros = np.zeros((B,), np.int32)
        with torch.no_grad():
            out, _ = self._step(zeros, zeros, np.full((B, T), -1, np.int32),
                                np.zeros((B,), np.bool_), None)
            out.cpu()
        self._warmed = True
        return n

    # -- public API --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_s: Optional[float] = None):
        """Admit one generation request; returns the pending handle
        (``result()`` -> generated token ids, ``stats()`` -> TTFT and
        per-token times). Typed admission errors raise synchronously."""
        return self.sched.submit(prompt, max_new_tokens,
                                 deadline_s=deadline_s)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience: submit + wait for the token list."""
        return self.submit(prompt, max_new_tokens,
                           deadline_s=deadline_s).result(timeout)

    def adopt_pages(self, frame: bytes) -> dict:
        """Adopt a shipped prefill PAGE FRAME (``serving/disagg.py`` wire
        format) into this engine's pool: decode the frame, allocate and
        index its full pages under their chained content hashes, write
        the KV rows on the device. The adopted pages park in the cached
        prefix LRU, so the next ``submit`` with that prompt shares them
        and prefills only its suffix.

        Thread-safe: while the scheduler thread runs, the frame is
        queued and adopted between ticks. Returns the report dict
        (``ok``/``adopted``/``shared``/``pages``); raises
        ``MalformedPageFrame`` on a bad frame or a geometry the pool
        can't hold."""
        with self.sched.lock:
            running = self._running
            if running:
                box: dict = {}
                done = threading.Event()
                entry = (frame, box, done)
                self._adoptions.append(entry)
                self.sched.lock.notify_all()
        if not running:
            return self._adopt_now(frame)
        while not done.wait(timeout=0.05):
            with self.sched.lock:
                if self._running or done.is_set():
                    continue
                # the scheduler stopped before taking the frame: adopt
                # inline once its thread is out of the tick
                try:
                    self._adoptions.remove(entry)
                except ValueError:
                    continue   # taken after all; keep waiting
            t = self._thread
            if t is not None:
                t.join(timeout=10)
            return self._adopt_now(frame)
        if "error" in box:
            raise box["error"]
        return box["result"]

    @torch.no_grad()
    def _adopt_now(self, frame: bytes) -> dict:
        from ...serving.disagg import MalformedPageFrame, decode_frame

        pf = decode_frame(frame)
        want = (self.config.n_layers, self.pool.page_size,
                self.config.n_heads, self.config.head_dim)
        got = (pf.n_layers, pf.page_size, pf.heads, pf.head_dim)
        if got != want:
            raise MalformedPageFrame(
                f"frame geometry {got} does not match engine "
                f"(n_layers, page_size, heads, head_dim)={want}")
        if self._inflight is not None:
            self._drain_inflight()
        seq_id = self.sched.new_seq_id()
        res = self.pool.adopt_pages(seq_id, pf.tokens)
        if res is None:
            return {"ok": False, "reason": "pool_full",
                    "adopted": 0, "shared": 0, "pages": 0}
        pages, fresh = res
        if fresh:
            blocks = [i for i, _ in fresh]
            idx = _h2d(np.asarray([p for _, p in fresh], np.int64),
                       self.device)
            if self._kv_codec == "int8":
                # the frame's int8 rows and scales as they are: an
                # adopted page is bitwise a locally prefilled one
                for which, pages_t, scales_t in (
                        ("k", self._k_pages, self._k_scales),
                        ("v", self._v_pages, self._v_scales)):
                    q, sc = pf.int8_rows(which)
                    pages_t[:, idx] = _h2d(q[:, blocks], self.device)
                    scales_t[:, idx] = _h2d(sc[:, blocks], self.device)
            else:
                for which, pages_t in (("k", self._k_pages),
                                       ("v", self._v_pages)):
                    rows = _h2d(pf.f32_rows(which)[:, blocks], self.device)
                    pages_t[:, idx] = rows.to(self._pool_dtype)
            self._count("kv_migration_pages", len(fresh))
        # drop the holder reference: the pages park INDEXED in the
        # cached LRU, reclaimable under pressure
        self.pool.free_seq(seq_id)
        return {"ok": True, "adopted": len(fresh),
                "shared": len(pages) - len(fresh), "pages": len(pages)}

    @property
    def ready(self) -> bool:
        return self.sched.accepting and self._running and self._warmed

    @property
    def queue_depth(self) -> int:
        return self.sched.queue_depth

    # -- the tick -----------------------------------------------------------
    @torch.no_grad()
    def run_once(self) -> int:
        """One scheduler tick: adoptions, expiry, host-tier resume and
        park-to-admit, admit+prefill, one ragged decode step (async: its
        dispatch, then the previous tick's harvest). Returns a work
        count (prefills + tokens emitted + expiries + ...); 0 means
        nothing advanced."""
        now = self._clock()
        work = 0
        while self._adoptions:
            frame, box, done = self._adoptions.popleft()
            try:
                box["result"] = self._adopt_now(frame)
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()
            work += 1
        work += len(self.sched.expire_queued(now))
        if self._offload is not None:
            for pk in self.sched.expire_parked(now):
                self._offload.drop_seq(pk.host_key)
                self._prefetch.discard(pk.host_key)
                self._gauge("kv_pages_host", self._offload.pages_host)
                work += 1
            work += self._resume_parked()
            # admission-driven parking: the queue head can't fit but a
            # slot is free, so park the coldest running session (not
            # while resumes wait themselves: no thrash between the two)
            if not self.sched.parked:
                with self.sched.lock:
                    head = self.sched.queue[0] if self.sched.queue \
                        else None
                    slot_free = len(self.sched.slots) < self.max_batch
                if head is not None and slot_free and not \
                        self.pool.can_fit(len(head.prompt)
                                          + len(head.generated)):
                    if self._try_park():
                        work += 1
        while True:
            req = self.sched.pop_for_prefill()
            if req is None:
                break
            try:
                work += self._prefill_one(req)
            finally:
                self.sched.prefill_done()
        active = self.sched.active()
        if active:
            work += self._decode_once(active)
        elif self._inflight is not None:
            # every slot of the in-flight tick already finished: its
            # tokens are discards, but it is consumed all the same
            work += 1 + self._drain_inflight()
        return work

    def _finish(self, slot_id: Optional[int], rs_or_req, error=None):
        req = rs_or_req.req if isinstance(rs_or_req, RunningSeq) \
            else rs_or_req
        if slot_id is not None:
            self.sched.release(slot_id)
        h = req.handle
        now = self._clock()
        h.meta["preempted"] = req.preempted
        if req.token_times:
            h.meta["ttft_ms"] = round(
                (req.token_times[0] - req.t_submit) * 1e3, 3)
            h.meta["token_times"] = list(req.token_times)
        if req.span is not None:
            h.meta["trace_id"] = req.trace_hex()
            req.span.set("tokens", len(req.generated))
            if req.preempted:
                req.span.set("preempted", req.preempted)
            if error is not None:
                req.span.fail(error)
            else:
                req.span.end()
        if error is not None:
            h._resolve(error=error)
            return
        self._h_e2e.observe((now - req.t_submit) * 1e3)
        h._resolve(value=list(req.generated))

    def _emit(self, req: DecodeRequest, token: int) -> None:
        req.generated.append(int(token))
        req.token_times.append(self._clock())
        self._count("decode_tokens")

    def _req_done(self, req: DecodeRequest) -> bool:
        if len(req.generated) >= req.max_new_tokens:
            return True
        return self.eos_id is not None and req.generated \
            and req.generated[-1] == self.eos_id

    def _noise(self, rows: int) -> torch.Tensor:
        """The next Gumbel draw of the seeded host stream, on device."""
        g = self._sample_rng.gumbel(
            size=(rows, self.config.vocab_size)).astype(np.float32)
        return _h2d(g, self.device)

    def _prefill_one(self, req: DecodeRequest) -> int:
        now = self._clock()
        if req.qspan is not None:
            req.qspan.end("DeadlineExceeded"
                          if req.deadline is not None
                          and now >= req.deadline else "ok")
        if req.deadline is not None and now >= req.deadline:
            self._count("decode_deadline_expired")
            self._finish(None, req, error=DeadlineExceeded(
                f"deadline passed before prefill "
                f"({now - req.t_submit:.3f}s since submit)"))
            return 1
        ctx_tokens = req.prompt + req.generated
        ctx = len(ctx_tokens)
        S = self.pool.page_size
        # prefix cache: the longest indexed full-page chain of this
        # context is SHARED (refcounted, zero new pages), capped so at
        # least one suffix token remains to produce the next logits;
        # with a host tier, spilled pages come back first so the match
        # sees them
        if self._offload is not None:
            self._revive_host_prefix(ctx_tokens, (ctx - 1) // S)
        shared = self.pool.match_prefix(ctx_tokens, limit=(ctx - 1) // S)
        # pages allocate in power-of-two counts, as in the JAX engine
        # (its prefill buckets), so pool pressure plays out the same
        npages = min(_next_pow2(self.pool.pages_for_tokens(ctx)),
                     self.pool.max_pages_per_seq)
        seq_id = self.sched.new_seq_id()
        pages = self.pool.alloc_seq_shared(seq_id, shared, npages * S)
        if pages is None:
            npages = self.pool.pages_for_tokens(ctx)
            pages = self.pool.alloc_seq_shared(seq_id, shared, ctx)
        if pages is None:
            if req.span is not None:
                req.qspan = tracing.Span("decode.queue",
                                         parent=req.span,
                                         clock=self._clock)
            with self.sched.lock:
                self.sched.queue.appendleft(req)
            return 0
        # shared prefix pages already hold this exact KV and other
        # sequences may be reading them: route their writes at the
        # trash page
        write_ids = np.asarray(pages, np.int32)
        write_ids[:len(shared)] = 0
        pspan = tracing.Span("decode.prefill", parent=req.span,
                             clock=self._clock, ctx_tokens=ctx,
                             n_pages=npages, shared_pages=len(shared))
        t0 = time.perf_counter()
        try:
            token = self._prefill_dispatch(ctx_tokens, npages, write_ids)
        except Exception as e:
            self.pool.free_seq(seq_id)
            self._count("decode_failed")
            err = RequestFailed(
                f"prefill dispatch failed: {type(e).__name__}: {e}")
            pspan.fail(err)
            self._finish(None, req, error=err)
            self._reset_pool()
            return 1
        pspan.end()
        self.pool.register_prefix(seq_id, ctx_tokens)
        self._h_prefill.observe((time.perf_counter() - t0) * 1e3)
        self._count("decode_prefills")
        self._emit(req, token)
        if self._req_done(req):
            self.pool.free_seq(seq_id)
            self._finish(None, req)
            return 1
        self.sched.place(req, seq_id, ctx, token)
        return 1

    def _prefill_dispatch(self, ctx_tokens: List[int], npages: int,
                          write_ids: np.ndarray) -> int:
        """Dense forward over the context, K/V scattered into the pages
        (zero rows past the context), first token drawn."""
        cfg = self.config
        S = self.pool.page_size
        ctx = len(ctx_tokens)
        toks, lens, ids = (
            _h2d(np.asarray([ctx_tokens], np.int32), self.device),
            _h2d(np.asarray([ctx], np.int32), self.device),
            _h2d(write_ids, self.device))
        sampling = self._temperature > 0
        nxt, ks, vs = prefill_forward(cfg, self.params, toks, lens,
                                      return_logits=sampling)
        pad = npages * S - ctx
        for i in range(cfg.n_layers):
            ki = torch.nn.functional.pad(ks[i][0], (0, 0, 0, 0, 0, pad))
            vi = torch.nn.functional.pad(vs[i][0], (0, 0, 0, 0, 0, pad))
            if self._k_scales is not None:
                paged_prefill_write_quant(
                    self._k_pages[i], self._v_pages[i], self._k_scales[i],
                    self._v_scales[i], ids, ki, vi)
            else:
                paged_prefill_write(self._k_pages[i], self._v_pages[i],
                                    ids, ki, vi)
        if sampling:
            nxt = fused_sample(nxt, self._noise(1), self._temperature,
                               self._top_k, self._top_p)
        return int(nxt[0])

    def _reset_pool(self) -> None:
        """Recover from a failed dispatch, which may have left the pool
        half written: abort the in-flight tick, preempt every running
        sequence onto the queue (their emitted tokens ride the
        re-prefill, so greedy outputs are preserved) and re-allocate a
        zeroed pool."""
        fl, self._inflight = self._inflight, None
        self._chain = self._pos_chain = self._steady_sig = None
        if fl is not None:
            self._abort_inflight(fl)
        while self.sched.preempt_youngest() is not None:
            pass
        self._alloc_pool()

    def _maybe_cow(self, rs: RunningSeq) -> None:
        """Copy-on-write guard before this slot's writes: prefix sharing
        only ever shares FULL prompt pages and writes land past the
        context, so an organic hit is impossible by construction — but
        a proposer or table bug must corrupt a private copy, not a page
        other sequences are reading."""
        span = self._spec_k if self._spec_k > 0 else 0
        for pos in {rs.length, rs.length + span}:
            if not self.pool.needs_cow(rs.seq_id, pos):
                continue
            res = self.pool.cow_page(rs.seq_id, pos)
            if res is None or res == -1:
                continue   # already private / pool dry (preempt soon)
            src, dst = res
            self._count("kv_cow_copies")
            self._k_pages[:, dst] = self._k_pages[:, src]
            self._v_pages[:, dst] = self._v_pages[:, src]
            if self._k_scales is not None:
                self._k_scales[:, dst] = self._k_scales[:, src]
                self._v_scales[:, dst] = self._v_scales[:, src]

    def _note_fill(self, n_live: int) -> None:
        with self._stats_lock:
            self._fill_rows += n_live
            self._fill_capacity += self.max_batch
            fill = round(100.0 * self._fill_rows
                         / max(1, self._fill_capacity), 2)
        self._gauge("decode_batch_fill_pct", fill)

    def _note_phases(self, dispatch_ms: float, host_ms: float,
                     fetch_ms: float) -> None:
        self._phase_h.observe(dispatch_ms, phase="dispatch")
        self._phase_h.observe(host_ms, phase="host")
        self._phase_h.observe(fetch_ms, phase="fetch")
        with self._stats_lock:
            self._phase_ms["dispatch"] += dispatch_ms
            self._phase_ms["host"] += host_ms
            self._phase_ms["fetch"] += fetch_ms
            tot = sum(self._phase_ms.values())
            frac = 0.0 if tot <= 0 else round(
                (tot - self._phase_ms["fetch"]) / tot, 4)
        self._gauge("decode_overlap_frac", frac)

    def _fail_tick(self, plan, error: Exception) -> int:
        """Fail every live request of a failed tick TYPED (no silent
        hang) and rebuild the possibly half-written pool, so queued
        requests keep serving."""
        n = 0
        for slot_id, rs in plan:
            if rs.req.handle.done():
                continue
            self._count("decode_failed")
            self._finish(
                slot_id if self.sched.slots.get(slot_id) is rs else None,
                rs, error=RequestFailed(
                    f"decode step dispatch failed: "
                    f"{type(error).__name__}: {error}"))
            n += 1
        self._reset_pool()
        return n

    def _decode_once(self, active: Dict[int, RunningSeq]) -> int:
        if self._async_decode and self._spec_k == 0:
            return self._decode_once_async(active)
        # grow page tables for this step's writes; pool pressure parks
        # the coldest slot into the host tier when one is attached,
        # else preempts the youngest (requeued, outputs preserved)
        for slot_id in sorted(active):
            rs = active[slot_id]
            if slot_id not in self.sched.slots:
                continue   # preempted below while we iterated
            self._maybe_cow(rs)
            while self.pool.append_token(rs.seq_id, rs.length + 1) == -1:
                if self._try_park(exclude=rs.req):
                    continue
                victim = self.sched.preempt_youngest()
                if victim is None or victim is rs.req:
                    break
        active = self.sched.active()
        if not active:
            return 0
        if self._spec_k > 0:
            return self._spec_once(active)
        B, T = self.max_batch, self.pool.max_pages_per_seq
        t_build0 = time.perf_counter()
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        table = np.full((B, T), -1, np.int32)
        mask = np.zeros((B,), np.bool_)
        for slot_id, rs in active.items():
            tokens[slot_id] = rs.next_token
            positions[slot_id] = rs.length
            table[slot_id] = self.pool.table_row(rs.seq_id)
            mask[slot_id] = True
        noise = self._noise(B) if self._temperature > 0 else None
        tspan = tracing.Span(
            "decode.tick", parent=False, clock=self._clock,
            slots=sorted(active),
            requests=[rs.req.trace_hex() for _, rs in sorted(
                active.items()) if rs.req.span is not None])
        t0 = time.perf_counter()
        try:
            with tspan.activate():
                out, _ = self._step(tokens, positions, table, mask, noise)
                t_launched = time.perf_counter()
                nxt = out.cpu().numpy()   # waits for the device
        except Exception as e:
            tspan.fail(e)
            return self._fail_tick(list(active.items()), e)
        step_s = time.perf_counter() - t0
        tspan.end()
        self._h_step.observe(step_s * 1e3)
        self._count("decode_steps")
        self._note_fill(len(active))
        self._publish_cost([rs.length + 1 for rs in active.values()],
                           step_s)
        now = self._clock()
        emitted = 0
        t_h0 = time.perf_counter()
        for slot_id, rs in active.items():
            rs.length += 1
            tok = int(nxt[slot_id])
            rs.next_token = tok
            self._emit(rs.req, tok)
            emitted += 1
            if rs.req.deadline is not None and now >= rs.req.deadline:
                self._count("decode_deadline_expired")
                self._finish(slot_id, rs, error=DeadlineExceeded(
                    "deadline passed mid-generation; sequence dropped"))
            elif self._req_done(rs.req):
                self._finish(slot_id, rs)
        # dispatch: building and enqueueing the step; fetch: the wait
        # for the device that follows
        self._note_phases((t_launched - t_build0) * 1e3,
                          (time.perf_counter() - t_h0) * 1e3,
                          (t0 + step_s - t_launched) * 1e3)
        return emitted

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host int/bool arrays on the device in ONE copy: packed as
        int32, split on the device (bool arrays come back bool)."""
        flat = _h2d(np.concatenate(
            [np.asarray(a, np.int32).reshape(-1) for a in arrays]),
            self.device)
        out, off = [], 0
        for a in arrays:
            t = flat[off:off + a.size].view(a.shape)
            out.append(t != 0 if a.dtype == np.bool_ else t)
            off += a.size
        return out

    def _step(self, tokens, positions, table, mask, noise):
        """Enqueue one decode step on the device (greedy when ``noise``
        is None) and return its device ``(next tokens, next
        positions)``; nothing waits for the device. Host (numpy) control
        arrays are uploaded in one pinned copy; device tensors are used
        as they are."""
        if isinstance(table, np.ndarray):
            tokens, positions, table, mask = self._upload(
                tokens, positions, table, mask)
        out, nxt_pos = decode_forward(
            self.config, self.params, tokens, positions, self._k_pages,
            self._v_pages, table, positions, mask,
            k_scales=self._k_scales, v_scales=self._v_scales,
            return_logits=noise is not None, return_next_positions=True)
        if noise is not None:
            out = fused_sample(out, noise, self._temperature, self._top_k,
                               self._top_p)
        return out, nxt_pos

    # -- the async tick -----------------------------------------------------
    def _budget_done(self, rs: RunningSeq) -> bool:
        """True when harvested + in-flight tokens already cover the
        request's budget: dispatching more would overrun
        ``max_new_tokens`` (EOS, unknowable before the lagged fetch, is
        handled by discarding one in-flight token instead)."""
        return len(rs.req.generated) + rs.pending \
            >= rs.req.max_new_tokens

    def _decode_once_async(self, active: Dict[int, RunningSeq]) -> int:
        """One pipelined tick: enqueue tick ``t+1`` against the
        device-resident token chain BEFORE fetching tick ``t``'s tokens,
        then harvest ``t`` at depth-1 lag. Page growth happens at
        dispatch (headroom allocated ahead, so a page-boundary write
        never waits on the lagged token); any state surgery (park,
        preempt, pool reset) drains the in-flight tick first, which
        keeps greedy outputs bitwise the sync tick's."""
        work = 0
        for slot_id in sorted(active):
            rs = active[slot_id]
            if slot_id not in self.sched.slots \
                    or rs.req.handle.done() or self._budget_done(rs):
                continue
            self._maybe_cow(rs)
            while slot_id in self.sched.slots and \
                    self.pool.append_token(rs.seq_id, rs.length + 1) == -1:
                if self._inflight is not None:
                    # harvesting may finish slots and free their pages
                    work += self._drain_inflight()
                    if rs.req.handle.done() \
                            or slot_id not in self.sched.slots:
                        break
                    continue
                if self._try_park(exclude=rs.req):
                    continue
                victim = self.sched.preempt_youngest()
                if victim is None or victim is rs.req:
                    break
        # the growth loop only ever REMOVES slots (finished, parked,
        # preempted), so filtering the tick's own view is complete
        elig = {sid: rs for sid, rs in sorted(active.items())
                if self.sched.slots.get(sid) is rs
                and not rs.req.handle.done()
                and not self._budget_done(rs)}
        prev, self._inflight = self._inflight, None
        if elig:
            work += self._dispatch_async(elig, prev)
            if self._inflight is None:   # the dispatch failed
                return work
        if prev is not None:
            work += self._harvest(prev)
        return work

    def _dispatch_async(self, elig: Dict[int, RunningSeq],
                        prev: Optional[dict]) -> int:
        B, T = self.max_batch, self.pool.max_pages_per_seq
        t_build0 = time.perf_counter()
        # steady signature: the slot set of the previous dispatch and no
        # page-table mutation since. When it holds, every control vector
        # is already on the device (tokens from the chain, positions from
        # the step's own positions + 1, table and mask from the last
        # rebuild), so the tick uploads nothing.
        sig = (tuple(elig), self.pool.mutations)
        steady = (self._chain is not None and self._pos_chain is not None
                  and sig == self._steady_sig)
        if steady:
            tokens, positions = self._chain, self._pos_chain
            table, mask = self._tab_dev, self._mask_dev
        else:
            # fresh host arrays every rebuild tick, one pinned upload;
            # the pinned block is not reused before its copy is done
            inject = np.zeros((B,), np.int32)
            inj_mask = np.zeros((B,), np.bool_)
            positions = np.zeros((B,), np.int32)
            table = np.full((B, T), -1, np.int32)
            mask = np.zeros((B,), np.bool_)
            n_inj = 0
            for slot_id, rs in elig.items():
                if not rs.fed:
                    # a fresh prefill or a resumed session: the chain
                    # does not hold this slot's next input
                    inject[slot_id] = rs.next_token
                    inj_mask[slot_id] = True
                    n_inj += 1
                positions[slot_id] = rs.length
                table[slot_id] = self.pool.table_row(rs.seq_id)
                mask[slot_id] = True
            inject, inj_mask, positions, table, mask = self._upload(
                inject, inj_mask, positions, table, mask)
            self._tab_dev, self._mask_dev = table, mask
            if self._chain is None or n_inj == len(elig):
                tokens = inject
            elif n_inj == 0:
                tokens = self._chain
            else:   # mixed: splice the injected tokens over the chain
                tokens = torch.where(inj_mask, inject, self._chain)
        # no per-tick span here: the reference makes one only while a
        # trace sink records, and the port has no sink yet
        t0 = time.perf_counter()
        try:
            out, nxt_pos = self._step(tokens, positions, table, mask, None)
            # the fetch: a non_blocking copy into the next pinned buffer
            # and an event after it; the harvest waits on that event
            host = self._fetch_bufs[self._fetch_i]
            self._fetch_i ^= 1
            host.copy_(out, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        except Exception as e:
            self._chain = self._pos_chain = self._steady_sig = None
            self._inflight = prev   # aborted by the reset below
            return self._fail_tick(list(elig.items()), e)
        self._chain, self._pos_chain = out, nxt_pos
        self._steady_sig = sig
        self._inflight = {
            "host": host, "event": event, "plan": list(elig.items()),
            "t0": t0,
            "dispatch_ms": (time.perf_counter() - t_build0) * 1e3,
            "lens": [rs.length + 1 for rs in elig.values()]}
        for rs in elig.values():
            rs.length += 1    # optimistic: the write is in flight
            rs.pending += 1
            rs.fed = True
        self._count("decode_steps")
        self._note_fill(len(elig))
        return len(elig)

    def _harvest(self, fl: dict) -> int:
        """Consume one lagged tick: wait for its event (the only
        blocking point of the pipeline), emit its tokens, finish
        EOS/budget/deadline slots. A slot finished by an EARLIER harvest
        discards its token: the one extra the EOS lag costs."""
        t_f0 = time.perf_counter()
        try:
            if fl["event"] is not None:
                fl["event"].synchronize()
            nxt = fl["host"].numpy().copy()
        except Exception as e:
            # a fault during the tick surfaces at the wait: the same
            # typed-fail + pool-rebuild posture as a failed dispatch
            for _, rs in fl["plan"]:
                rs.pending -= 1
            self._chain = self._pos_chain = self._steady_sig = None
            return self._fail_tick(fl["plan"], e)
        fetch_ms = (time.perf_counter() - t_f0) * 1e3
        step_ms = (time.perf_counter() - fl["t0"]) * 1e3
        self._h_step.observe(step_ms)
        self._publish_cost(fl["lens"], step_ms / 1e3)
        now = self._clock()
        emitted = 0
        t_h0 = time.perf_counter()
        for slot_id, rs in fl["plan"]:
            rs.pending -= 1
            if rs.req.handle.done():
                continue   # EOS already out: discard the extra token
            tok = int(nxt[slot_id])
            rs.next_token = tok
            self._emit(rs.req, tok)
            emitted += 1
            if rs.req.deadline is not None and now >= rs.req.deadline:
                self._count("decode_deadline_expired")
                self._finish(slot_id, rs, error=DeadlineExceeded(
                    "deadline passed mid-generation; sequence dropped"))
            elif self._req_done(rs.req):
                self._finish(slot_id, rs)
        self._note_phases(fl["dispatch_ms"],
                          (time.perf_counter() - t_h0) * 1e3, fetch_ms)
        return emitted

    def _drain_inflight(self) -> int:
        """Harvest the lagged tick NOW: the barrier before any state
        surgery (park, preempt, adopt, reset, stop)."""
        fl, self._inflight = self._inflight, None
        return self._harvest(fl) if fl is not None else 0

    def _abort_inflight(self, fl: dict) -> None:
        """Discard an in-flight tick whose results can no longer be
        trusted (a later dispatch failed): wait the device out, so no
        tick still writes pool pages during the caller's pool surgery,
        then roll back the optimistic advances (the caller fails or
        requeues the slots)."""
        try:
            if fl["event"] is not None:
                fl["event"].synchronize()
        except Exception:
            pass
        for _, rs in fl["plan"]:
            rs.pending -= 1
            rs.length = max(0, rs.length - 1)
            rs.fed = False

    # -- host tier ----------------------------------------------------------
    def _fetch_page_records(self, pages: Sequence[int]) -> List[tuple]:
        """Device-to-host snapshot of pool pages as host-tier records
        ``(kq, ks, vq, vs)``, one copy a plane for all of them: int8
        pools copy VERBATIM (their planes are the per-row codec layout,
        so park -> resume is bitwise); other pools pay one
        deterministic per-row quantization (the wire's rounding)."""
        from ...serving.disagg import quantize_rows

        idx = _h2d(np.asarray(pages, np.int64), self.device)
        if self._kv_codec == "int8":
            planes = [t[:, idx].cpu().numpy() for t in (
                self._k_pages, self._k_scales, self._v_pages,
                self._v_scales)]
            return [tuple(p[:, j] for p in planes)
                    for j in range(len(pages))]
        kq, ks = quantize_rows(self._k_pages[:, idx].float().cpu().numpy())
        vq, vs = quantize_rows(self._v_pages[:, idx].float().cpu().numpy())
        return [(kq[:, j], ks[:, j], vq[:, j], vs[:, j])
                for j in range(len(pages))]

    def _decode_record(self, rec: tuple) -> tuple:
        """Host-side decode of one record into write-ready arrays (the
        prefetcher runs it off the scheduler thread)."""
        if self._kv_codec == "int8":
            return rec   # the pool IS the encoded layout
        kq, ks, vq, vs = rec
        return ((kq.astype(np.float32) * ks[:, :, None, None]),
                (vq.astype(np.float32) * vs[:, :, None, None]))

    def _write_page_arrays(self, page: int, arrays: tuple) -> None:
        """Write one page's decoded arrays (host or device) into the
        pool."""
        arrays = [a if isinstance(a, torch.Tensor) else
                  _h2d(a, self.device) for a in arrays]
        if self._kv_codec == "int8":
            kq, ks, vq, vs = arrays
            self._k_pages[:, page] = kq
            self._v_pages[:, page] = vq
            self._k_scales[:, page] = ks
            self._v_scales[:, page] = vs
        else:
            kf, vf = arrays
            self._k_pages[:, page] = kf.to(self._pool_dtype)
            self._v_pages[:, page] = vf.to(self._pool_dtype)

    def _spill_prefix_page(self, page: int, key: bytes) -> None:
        """``spill_sink``: the allocator is reclaiming an indexed cached
        page; keep its rows in the host prefix LRU so a later prefill
        can revive it instead of recomputing."""
        if self._offload is None:
            return
        rec = self._fetch_page_records([page])[0]
        if self._offload.put_prefix(key, rec):
            self._count("kv_offload_bytes", self._offload.page_nbytes)
            self._gauge("kv_pages_host", self._offload.pages_host)

    def _try_park(self, exclude: Optional[DecodeRequest] = None) -> bool:
        """Park the coldest slot's session into the host tier: drain the
        in-flight tick, snapshot its pages (encoded) to the host, release
        them from the pool, move the request to the parked list. False
        when no tier is attached, no parkable slot exists, or the tier
        is full (callers then preempt)."""
        if self._offload is None:
            return False
        if self._inflight is not None:
            self._drain_inflight()
        slot_id = self.sched.coldest_slot(exclude_req=exclude)
        if slot_id is None:
            return False
        rs = self.sched.slots.get(slot_id)
        if rs is None or rs.req.handle.done():
            return False
        pages = self.pool.seq_pages(rs.seq_id)
        if not pages or not self._offload.room_for(len(pages)):
            return False
        records = self._fetch_page_records(pages)
        if not self._offload.put_seq(rs.seq_id, records):
            return False
        self.sched.park(slot_id)
        # stage the restore at once: by the time pages free up for the
        # resume, its pages are usually on the card already
        self._prefetch.request(rs.seq_id, records)
        self._count("kv_offload_bytes",
                    len(records) * self._offload.page_nbytes)
        self._gauge("kv_pages_host", self._offload.pages_host)
        return True

    def _resume_parked(self) -> int:
        """Resume parked sessions (FIFO) while slots and pages allow:
        allocate fresh pages, write the staged (or synchronously
        decoded) rows back, re-place the request with its exact
        pre-park state. Bitwise for int8 pools (verbatim records),
        deterministic for the others (one quantization)."""
        work = 0
        while True:
            pk = self.sched.peek_parked()
            if pk is None:
                break
            if pk.req.handle.done():   # failed or cancelled while parked
                self.sched.pop_parked()
                self._offload.drop_seq(pk.host_key)
                self._prefetch.discard(pk.host_key)
                self._gauge("kv_pages_host", self._offload.pages_host)
                continue
            if pk.n_pages > self.pool.pages_free:
                break   # pages not there yet; staging already runs
            t0 = time.perf_counter()
            seq_id = self.sched.new_seq_id()
            pages = self.pool.alloc_seq(
                seq_id, pk.n_pages * self.pool.page_size)
            if pages is None:
                break
            arrays = None
            try:
                arrays, event = self._prefetch.take(pk.host_key)
                if event is not None:
                    # the pages were copied on the prefetcher's stream:
                    # this stream waits for them, and their memory is
                    # not reused before this stream is done with them
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for arr in arrays:
                        for t in arr:
                            t.record_stream(stream)
            except KVRestoreError:
                self._count("kv_restore_fallbacks")
            records = self._offload.pop_seq(pk.host_key)
            if arrays is None:   # typed fallback: a synchronous restore
                arrays = [self._decode_record(r) for r in records]
            for page, arr in zip(pages, arrays):
                self._write_page_arrays(page, arr)
            self.sched.pop_parked()
            self.sched.place(pk.req, seq_id, pk.length, pk.next_token)
            if pk.req.span is not None:
                pk.req.span.event("resumed", pages=pk.n_pages,
                                  length=pk.length)
            self._count("kv_page_restores", len(pages))
            self._count("kv_sessions_resumed")
            self._h_restore.observe((time.perf_counter() - t0) * 1e3)
            self._gauge("kv_pages_host", self._offload.pages_host)
            work += 1
        return work

    def _revive_host_prefix(self, tokens: List[int], limit: int) -> int:
        """Walk the context's chain keys and bring spilled prefix pages
        back from the host tier into the cached LRU (write + index
        install), so the prefill right after shares them through
        ``match_prefix`` instead of recomputing."""
        n_full = min(len(tokens) // self.pool.page_size, int(limit))
        if n_full <= 0:
            return 0
        revived = 0
        for key in _chain_keys(tokens, n_full, self.pool.page_size):
            if self.pool.is_indexed(key):
                continue   # already in the pool
            rec = self._offload.take_prefix(key)
            if rec is None:
                break      # the chain ends: nothing further can match
            page = self.pool.install_cached(key)
            if page is None:
                self._offload.put_prefix(key, rec)   # pool dry: keep it
                break
            self._write_page_arrays(page, self._decode_record(rec))
            self._count("kv_page_restores")
            revived += 1
        if revived:
            self._gauge("kv_pages_host", self._offload.pages_host)
        return revived

    # -- speculative decoding ----------------------------------------------
    def _spec_step(self, tokens, positions, table, colmask) -> np.ndarray:
        """One verify step on the device; returns the (B, K+1) greedy
        tokens on the host."""
        toks, pos, tab, cm = self._upload(tokens, positions, table,
                                          colmask)
        greedy = spec_decode_forward(
            self.config, self.params, toks, pos, self._k_pages,
            self._v_pages, tab, pos, cm, k_scales=self._k_scales,
            v_scales=self._v_scales)
        return greedy.cpu().numpy()

    def _spec_once(self, active: Dict[int, RunningSeq]) -> int:
        """One speculative tick: propose up to ``spec_k`` drafts a slot
        (host, model-free), verify every column in ONE ragged step,
        accept the longest prefix matching greedy argmax: every accepted
        token is bitwise what one-token-a-tick decode would emit, in
        fewer steps."""
        B, T = self.max_batch, self.pool.max_pages_per_seq
        K = self._spec_k
        K1 = K + 1
        tokens = np.zeros((B, K1), np.int32)
        positions = np.zeros((B,), np.int32)
        table = np.full((B, T), -1, np.int32)
        colmask = np.zeros((B, K1), np.bool_)
        drafts: Dict[int, List[int]] = {}
        for slot_id, rs in active.items():
            tokens[slot_id, 0] = rs.next_token
            positions[slot_id] = rs.length
            colmask[slot_id, 0] = True
            # draft capacity grows the table opportunistically but
            # NEVER preempts: drafts shrink to what the table holds
            k_cap = K
            while k_cap > 0:
                got = self.pool.append_token(rs.seq_id,
                                             rs.length + 1 + k_cap)
                if got is None:
                    break
                if got == -1:
                    k_cap -= 1
            d: List[int] = []
            if k_cap > 0:
                d = [int(t) for t in self.proposer.propose(
                    rs.req.prompt + rs.req.generated, k_cap)][:k_cap]
            for j, t in enumerate(d, start=1):
                tokens[slot_id, j] = t
                colmask[slot_id, j] = True
            drafts[slot_id] = d
            if d:
                self._count("spec_proposed", len(d))
            table[slot_id] = self.pool.table_row(rs.seq_id)
        tspan = tracing.Span(
            "decode.tick", parent=False, clock=self._clock,
            slots=sorted(active), spec_k=K,
            requests=[rs.req.trace_hex() for _, rs in sorted(
                active.items()) if rs.req.span is not None])
        t0 = time.perf_counter()
        try:
            with tspan.activate():
                greedy = self._spec_step(tokens, positions, table, colmask)
        except Exception as e:
            tspan.fail(e)
            return self._fail_tick(list(active.items()), e)
        step_s = time.perf_counter() - t0
        tspan.end()
        self._h_step.observe(step_s * 1e3)
        self._count("decode_steps")
        self._note_fill(len(active))
        self._publish_cost([rs.length + 1 for rs in active.values()],
                           step_s)
        now = self._clock()
        emitted = 0
        for slot_id, rs in active.items():
            d = drafts.get(slot_id, [])
            g = greedy[slot_id]
            # g_0 is the committed next token; draft d_j holds while it
            # equals g_{j-1}, and then g_j, scored in the same step,
            # comes for free
            accept = [int(g[0])]
            for j in range(1, len(d) + 1):
                if d[j - 1] != int(g[j - 1]):
                    break
                accept.append(int(g[j]))
            if len(accept) > 1:
                self._count("spec_accepted", len(accept) - 1)
            rs.length += len(accept)
            rs.next_token = accept[-1]
            done = False
            for tok in accept:
                self._emit(rs.req, tok)
                emitted += 1
                if self._req_done(rs.req):
                    done = True
                    break
            if rs.req.deadline is not None and now >= rs.req.deadline:
                self._count("decode_deadline_expired")
                self._finish(slot_id, rs, error=DeadlineExceeded(
                    "deadline passed mid-generation; sequence dropped"))
            elif done:
                self._finish(slot_id, rs)
        with self._stats_lock:
            p = self._counters.get("spec_proposed", 0)
            a = self._counters.get("spec_accepted", 0)
        self._gauge("spec_accept_rate", round(a / max(1, p), 4))
        return emitted

    def _publish_cost(self, live_lens: List[int], step_s: float) -> None:
        """Per-step cost gauges from the paged accounting (the gathered
        LIVE pages count toward the bytes, never the whole pool); mfu
        against the card's data-sheet bf16 peak, 0 where the device has
        no row in ``device_peaks``."""
        from ... import profiler
        from ...observability.device_peaks import peaks_for
        from ...static.cost_model import paged_decode_cost

        c = paged_decode_cost(self.config, live_lens, self.pool.page_size,
                              itemsize=_POOL_DTYPES[self._dtype].itemsize,
                              kv_codec=self._kv_codec)
        vals = {"step_model_flops": c["model_flops"],
                "step_hbm_bytes": c["hbm_bytes"],
                "step_comm_bytes": 0,
                "arith_intensity": round(c["arith_intensity"], 3)}
        peaks = peaks_for(self._device_kind)
        vals["mfu"] = round(c["model_flops"] / step_s / peaks.flops, 6) \
            if peaks is not None and step_s > 0 else 0
        for name, v in vals.items():
            with self._stats_lock:
                self._counters[name] = v    # a gauge: Counter.update adds
            profiler.set_counter(name, v)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DecodeEngine":
        """Run the scheduler on a background thread; idempotent."""
        with self.sched.lock:
            if self._running:
                return self
            stale = self._thread
        if stale is not None:
            stale.join()
        with self.sched.lock:
            if self._running:
                return self
            self._running = True
            self.sched.accepting = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="decode-scheduler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self.sched.lock:
                while self._running and not self.sched.queue \
                        and not self.sched.slots \
                        and not self.sched.parked \
                        and self._inflight is None \
                        and not self._adoptions:
                    self.sched.lock.wait(timeout=0.05)
                if not self._running:
                    return
            try:
                work = self.run_once()
            except BaseException:
                work = 0   # the scheduler thread must survive
            if work == 0 and self.sched.pending():
                self._sleep(self._tick_interval)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, flush every queued and in-flight request,
        stop the scheduler. True when the flush completed."""
        with self.sched.lock:
            self.sched.accepting = False
            threaded = self._running
            self.sched.lock.notify_all()
        if not threaded:
            while self.sched.pending():
                if self.run_once() == 0 and self.sched.pending():
                    return False  # wedged: nothing can advance
            self._drain_inflight()
            return True
        deadline = None if timeout is None else self._clock() + timeout
        while self.sched.pending():
            if deadline is not None and self._clock() >= deadline:
                return False
            self._sleep(0.01)
        self.stop()
        return True

    def stop(self) -> None:
        """Stop the scheduler thread, then consume the in-flight tick
        (its tokens are discards by now, or the next start's) and stop
        the restore prefetcher."""
        with self.sched.lock:
            self._running = False
            self.sched.accepting = False
            self.sched.lock.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            if not t.is_alive():
                self._thread = None
        if self._thread is None and self._inflight is not None:
            with torch.no_grad():
                self._drain_inflight()
        if self._prefetch is not None:
            self._prefetch.stop()
