"""LLM decode engine: continuous batching over a paged KV pool with one
ragged decode step per tick.

Port of ``paddle_tpu/inference/decode/engine.py``, synchronous tick.
A request's prompt is PREFILLED once (dense forward, K/V scattered into
its allocated pages), then joins a fixed ladder of decode SLOTS; every
engine tick runs one decode step at ``max_batch`` that advances EVERY
live sequence by one token, ragged via the page table, through the
paged attention kernel. The pool tensors are updated in place; per-tick
host-to-device traffic is a few int32 control vectors (and the Gumbel
noise when sampling).

Sampling (``temperature > 0``) draws Gumbel noise from
``np.random.RandomState(sample_seed)`` on the host, in the same order
as the JAX engine (one (1, V) draw per prefill, one (B, V) draw per
tick), and feeds it to the fused sampling kernel, so a seeded run
replays token for token.

Not in this slice (each raises ``NotImplementedError`` when asked for):
async double-buffered ticks, speculative decoding (``spec_k``), the host
KV tier (``host_kv_bytes``), tensor parallelism (``mesh_shape``) and
page adoption (``adopt_pages``). Greedy output is bitwise the same in
the JAX package's synchronous and asynchronous ticks, so the
synchronous tick is the whole contract here.
"""
from __future__ import annotations

import threading
import time
from collections import Counter as _Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..._device import resolve_device
from ...observability import tracing
from ...observability.metrics import MetricsRegistry
from ...ops.cuda import _build
from ...ops.cuda.paged_attention import (paged_prefill_write,
                                         paged_prefill_write_quant)
from ...ops.cuda.sampling import fused_sample
from ..serving import DeadlineExceeded, RequestFailed, _DualHist
from .kv_cache import PageTableManager, alloc_kv_pool, alloc_kv_scales
from .model import (DecodeModelConfig, decode_forward, init_decode_params,
                    params_from_numpy, prefill_forward)
from .scheduler import DecodeRequest, DecodeScheduler, RunningSeq

__all__ = ["DecodeEngine"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _later_slice(what: str):
    return NotImplementedError(f"{what} comes in a later port slice")


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
    kv_codec             "off" (f32 pool) or "int8" (int8 pages with
                         per-token-row f32 scales, dequantised inside
                         the attention kernel)
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
                 tick_interval: float = 0.002, device=None):
        if mesh_shape:
            raise _later_slice("tensor-parallel serving (mesh_shape)")
        if int(spec_k) != 0 or proposer is not None:
            raise _later_slice("speculative decoding (spec_k)")
        if int(host_kv_bytes) > 0:
            raise _later_slice("the host KV tier (host_kv_bytes)")
        if dtype != "float32":
            raise ValueError(f"the decode engine runs float32 models, got "
                             f"dtype={dtype!r}")
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
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.eos_id = eos_id
        self._clock = clock
        self._sleep = sleep
        self._tick_interval = float(tick_interval)
        self._kv_codec = kv_codec
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
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

        self._counters: _Counter = _Counter()
        self._stats_lock = threading.Lock()
        self._fill_rows = 0
        self._fill_capacity = 0
        self._hist_reg = MetricsRegistry()
        self._h_prefill = _DualHist("decode_prefill_ms", self._hist_reg)
        self._h_step = _DualHist("decode_step_ms", self._hist_reg)
        self._h_e2e = _DualHist("decode_e2e_ms", self._hist_reg)

        self._running = False
        self._thread: Optional[threading.Thread] = None

    def _alloc_pool(self) -> None:
        cfg = self.config
        quant = self._kv_codec == "int8"
        self._k_pages, self._v_pages = alloc_kv_pool(
            cfg.n_layers, self.pool.n_pages, self.pool.page_size,
            cfg.n_heads, cfg.head_dim,
            dtype=torch.int8 if quant else torch.float32,
            device=self.device)
        self._k_scales = self._v_scales = None
        if quant:
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
        return out

    def engine_latency_stats(self) -> Dict[str, float]:
        """Bucket-derived engine-side percentiles of decode_e2e_ms /
        decode_step_ms / decode_prefill_ms."""
        return {
            "n": int(self._h_e2e.snapshot()["count"]),
            "e2e_p50_ms": round(self._h_e2e.percentile(50), 3),
            "e2e_p99_ms": round(self._h_e2e.percentile(99), 3),
            "step_p50_ms": round(self._h_step.percentile(50), 3),
            "step_p99_ms": round(self._h_step.percentile(99), 3),
            "prefill_p50_ms": round(self._h_prefill.percentile(50), 3),
            "prefill_p99_ms": round(self._h_prefill.percentile(99), 3),
        }

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
            self._step(zeros, zeros, np.full((B, T), -1, np.int32),
                       np.zeros((B,), np.bool_), None)
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
        raise _later_slice("page adoption (adopt_pages)")

    @property
    def ready(self) -> bool:
        return self.sched.accepting and self._running and self._warmed

    @property
    def queue_depth(self) -> int:
        return self.sched.queue_depth

    # -- the tick -----------------------------------------------------------
    def run_once(self) -> int:
        """One synchronous scheduler tick: expire, admit+prefill, one
        ragged decode step, harvest. Returns a work count (prefills +
        tokens emitted + expiries) — 0 means nothing advanced."""
        work = len(self.sched.expire_queued(self._clock()))
        while True:
            req = self.sched.pop_for_prefill()
            if req is None:
                break
            work += self._prefill_one(req)
        active = self.sched.active()
        if active:
            work += self._decode_once(active)
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
        return torch.from_numpy(g).to(self.device)

    @torch.no_grad()
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
        # least one suffix token remains to produce the next logits
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
        write_ids = torch.tensor(pages, dtype=torch.int32)
        write_ids[:len(shared)] = 0
        write_ids = write_ids.to(self.device)
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
                          write_ids: torch.Tensor) -> int:
        """Dense forward over the context, K/V scattered into the pages
        (zero rows past the context), first token drawn."""
        cfg = self.config
        S = self.pool.page_size
        ctx = len(ctx_tokens)
        toks = torch.tensor([ctx_tokens], dtype=torch.int32,
                            device=self.device)
        lens = torch.tensor([ctx], dtype=torch.int32, device=self.device)
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
                    self._v_scales[i], write_ids, ki, vi)
            else:
                paged_prefill_write(self._k_pages[i], self._v_pages[i],
                                    write_ids, ki, vi)
        if sampling:
            nxt = fused_sample(nxt, self._noise(1), self._temperature,
                               self._top_k, self._top_p)
        return int(nxt[0])

    def _reset_pool(self) -> None:
        """Recover from a failed dispatch, which may have left the pool
        half written: preempt every running sequence onto the queue
        (their emitted tokens ride the re-prefill, so greedy outputs are
        preserved) and re-allocate a zeroed pool."""
        while self.sched.preempt_youngest() is not None:
            pass
        self._alloc_pool()

    def _maybe_cow(self, rs: RunningSeq) -> None:
        """Copy-on-write guard before this slot's write: prefix sharing
        only ever shares FULL prompt pages and writes land past the
        context, so an organic hit is impossible by construction — but
        a table bug must corrupt a private copy, not a page other
        sequences are reading."""
        if not self.pool.needs_cow(rs.seq_id, rs.length):
            return
        res = self.pool.cow_page(rs.seq_id, rs.length)
        if res is None or res == -1:
            return   # already private / pool dry (preempt soon)
        src, dst = res
        self._count("kv_cow_copies")
        self._k_pages[:, dst] = self._k_pages[:, src]
        self._v_pages[:, dst] = self._v_pages[:, src]
        if self._k_scales is not None:
            self._k_scales[:, dst] = self._k_scales[:, src]
            self._v_scales[:, dst] = self._v_scales[:, src]

    @torch.no_grad()
    def _decode_once(self, active: Dict[int, RunningSeq]) -> int:
        # grow page tables for this step's writes; pool pressure
        # preempts the youngest slot (requeued, outputs preserved)
        for slot_id in sorted(active):
            rs = active[slot_id]
            if slot_id not in self.sched.slots:
                continue   # preempted below while we iterated
            self._maybe_cow(rs)
            while self.pool.append_token(rs.seq_id, rs.length + 1) == -1:
                victim = self.sched.preempt_youngest()
                if victim is None or victim is rs.req:
                    break
        active = self.sched.active()
        if not active:
            return 0
        B, T = self.max_batch, self.pool.max_pages_per_seq
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
                nxt = self._step(tokens, positions, table, mask, noise)
        except Exception as e:
            tspan.fail(e)
            # no silent hang: every live request fails TYPED, and the
            # possibly half-written pool is rebuilt so queued requests
            # keep serving
            for slot_id, rs in active.items():
                self._count("decode_failed")
                self._finish(slot_id, rs, error=RequestFailed(
                    f"decode step dispatch failed: "
                    f"{type(e).__name__}: {e}"))
            self._reset_pool()
            return len(active)
        step_s = time.perf_counter() - t0
        tspan.end()
        self._h_step.observe(step_s * 1e3)
        self._count("decode_steps")
        with self._stats_lock:
            self._fill_rows += len(active)
            self._fill_capacity += B
            fill = round(100.0 * self._fill_rows
                         / max(1, self._fill_capacity), 2)
        self._gauge("decode_batch_fill_pct", fill)
        now = self._clock()
        emitted = 0
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
        return emitted

    def _step(self, tokens, positions, table, mask, noise) -> np.ndarray:
        """One decode step on the device (greedy when ``noise`` is
        None); returns the (B,) next tokens on the host (the fetch
        synchronises with the device)."""
        dev = self.device
        positions_t = torch.from_numpy(positions).to(dev)
        out = decode_forward(
            self.config, self.params, torch.from_numpy(tokens).to(dev),
            positions_t, self._k_pages, self._v_pages,
            torch.from_numpy(table).to(dev), positions_t,
            torch.from_numpy(mask).to(dev), k_scales=self._k_scales,
            v_scales=self._v_scales, return_logits=noise is not None)
        if noise is not None:
            out = fused_sample(out, noise, self._temperature, self._top_k,
                               self._top_p)
        return out.cpu().numpy()

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
                        and not self.sched.slots:
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
            return True
        deadline = None if timeout is None else self._clock() + timeout
        while self.sched.pending():
            if deadline is not None and self._clock() >= deadline:
                return False
            self._sleep(0.01)
        self.stop()
        return True

    def stop(self) -> None:
        with self.sched.lock:
            self._running = False
            self.sched.accepting = False
            self.sched.lock.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            if not t.is_alive():
                self._thread = None
