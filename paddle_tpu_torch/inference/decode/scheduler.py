"""Continuous prefill/decode scheduling: admission control, decode
slots, and page-pool pressure policy — pure host-side logic, fully
deterministic under an injected clock.

A copy of ``paddle_tpu/inference/decode/scheduler.py``; the parking
hooks serve the engine's host KV tier.

The admission surface is the serving engine's, typed error for
typed error (``inference.serving``): a bounded queue and optional
token-bucket rate limit shed with ``Overloaded``; deadlines drop with
``DeadlineExceeded`` at admission (unmakeable), while queued, and at
harvest; after drain begins, ``submit`` raises ``EngineStopped``.

Past admission the policy is vLLM-shaped continuous batching:

- a fixed ladder of decode SLOTS (``max_batch``) — one compiled decode
  step serves whatever subset is live, ragged via the page table, no
  length padding;
- a queued request is promoted to a slot the moment one is free AND its
  prompt's pages fit the pool (prefill), so decode steps keep running
  while prefills trickle in;
- when a RUNNING sequence needs its next page and the pool is dry, the
  youngest slot is PREEMPTED: its pages are evicted
  (``kv_page_evictions``) and the request re-queues at the front with
  its already-emitted tokens folded into the prompt — greedy decoding
  makes the re-prefilled continuation identical, so preemption is
  invisible in the output;
- with a host KV tier attached (engine ``host_kv_bytes``), the dry-pool
  policy PARKS the COLDEST slot instead (``placed_at`` minimum — the
  most KV accumulated, hence the most expensive to recompute but the
  cheapest to ship): its pages move to host RAM intact, the request
  waits in a PARKED list (not the queue — ``queue_depth`` stays an
  admission signal), and resumes into a free slot with its pages
  restored h2d, no recompute, bitwise-identical continuation.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ...observability import tracing
from ..serving import (DeadlineExceeded, EngineStopped,  # noqa: F401
                       Overloaded, RequestFailed, ServingError)
from .kv_cache import PageTableManager

__all__ = ["DecodeRequest", "DecodeScheduler", "ParkedSeq",
           "RunningSeq"]


class _DecodeHandle:
    """Caller-side handle: ``result()`` blocks for the generated token
    list (or raises the typed error); ``stats()`` exposes the
    engine-recorded per-token timing (TTFT + inter-token gaps)."""

    __slots__ = ("_event", "_value", "_error", "meta")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.meta: Dict[str, float] = {}

    def _resolve(self, value=None, error: Optional[BaseException] = None):
        if self._event.is_set():
            return
        self._value, self._error = value, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError("decode request still in flight")
        if self._error is not None:
            raise self._error
        return self._value

    def stats(self) -> Dict[str, object]:
        """{"ttft_ms", "token_times"} — clock() stamps the engine
        recorded per emitted token (first entry = first token)."""
        return dict(self.meta)


class DecodeRequest:
    __slots__ = ("prompt", "max_new_tokens", "deadline", "t_submit",
                 "handle", "generated", "token_times", "preempted",
                 "span", "qspan")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 deadline: Optional[float], t_submit: float):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline          # absolute clock() time or None
        self.t_submit = t_submit
        self.handle = _DecodeHandle()
        self.generated: List[int] = []    # survives preemption
        self.token_times: List[float] = []
        self.preempted = 0
        # request-lifecycle trace: root span (admit -> respond; in the
        # flight recorder's in-flight table) + the open child for the
        # current queue wait (re-opened on preemption requeue)
        self.span: Optional[tracing.Span] = None
        self.qspan: Optional[tracing.Span] = None

    def trace_hex(self) -> Optional[str]:
        return format(self.span.trace_id, "016x") \
            if self.span is not None else None


class RunningSeq:
    """One live decode slot: the request plus its sequence id (the page
    table key) and current context length (prompt + generated so far,
    == the number of KV positions already written). ``placed_at`` is
    the placement sequence number — the preemption policy's recency
    key (a re-placed preemptee is YOUNG again, whatever its original
    submit time)."""

    __slots__ = ("req", "seq_id", "length", "next_token", "placed_at",
                 "pending", "fed")

    def __init__(self, req: DecodeRequest, seq_id: int, length: int,
                 next_token: int, placed_at: int = 0):
        self.req = req
        self.seq_id = seq_id
        self.length = length        # KV positions written (incl. in-flight)
        self.next_token = next_token  # pending input of the next step
        self.placed_at = placed_at
        # async-tick state: in-flight dispatched-not-yet-harvested tick
        # count for this slot (depth <= 1), and whether the device-side
        # token chain holds this slot's next input (so the dispatch can
        # feed it device->device instead of injecting from the host)
        self.pending = 0
        self.fed = False


class ParkedSeq:
    """A session parked in the host KV tier: everything needed to
    resume it bitwise — the request, the host-pool key (its sequence
    id at park time), the KV positions covered, and the pending next
    input token. Parked sessions live OUTSIDE the admission queue:
    they already hold state (host pages), so they resume ahead of new
    prefills and never count in ``queue_depth``."""

    __slots__ = ("req", "host_key", "length", "next_token", "n_pages")

    def __init__(self, req: DecodeRequest, host_key: int, length: int,
                 next_token: int, n_pages: int):
        self.req = req
        self.host_key = host_key
        self.length = length
        self.next_token = next_token
        self.n_pages = n_pages


class DecodeScheduler:
    """Admission queue + slot table + page-pool policy. The engine
    drives it; everything here is host arithmetic (testable without
    jax)."""

    def __init__(self, pool: PageTableManager, max_batch: int,
                 max_queue: int = 64,
                 rate_limit: Optional[float] = None,
                 burst: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 min_service_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.default_deadline_s = default_deadline_s
        self.min_service_s = float(min_service_s)
        self._clock = clock
        if rate_limit is not None and rate_limit <= 0:
            raise ValueError(
                f"rate_limit must be > 0 req/s (got {rate_limit}); "
                f"pass None to disable rate limiting")
        if burst is not None and burst < 1:
            raise ValueError(
                f"burst must be >= 1 token (got {burst}); omit it to "
                f"default to max(1, rate_limit)")
        self._rate = float(rate_limit) if rate_limit is not None else None
        self._burst = float(burst) if burst is not None \
            else max(1.0, self._rate or 0.0)
        self._tokens = self._burst
        self._t_refill = clock()
        self.lock = threading.Condition()
        self.queue: deque = deque()
        self.parked: deque = deque()   # ParkedSeq, FIFO resume order
        self.slots: Dict[int, RunningSeq] = {}
        # requests popped for prefill and not yet placed, requeued or
        # resolved: neither queued nor in a slot, but still pending
        self.prefilling = 0
        self.accepting = True
        self._next_seq_id = 0
        self._placements = 0
        self._count = lambda name, n=1: None  # engine installs its sink

    # -- admission ----------------------------------------------------------
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

    def max_request_tokens(self) -> int:
        return self.pool.max_pages_per_seq * self.pool.page_size

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_s: Optional[float] = None) -> _DecodeHandle:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("decode request carries an empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_request_tokens():
            raise ValueError(
                f"prompt+output of {total} tokens exceeds the "
                f"per-sequence page budget "
                f"({self.max_request_tokens()} = max_pages_per_seq x "
                f"page_size); shorten the request or grow the table")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        # created on the caller's thread: an ambient client context
        # (load_gen, an upstream service) parents the request tree
        root = tracing.Span("decode.request", clock=self._clock,
                            root=True, prompt_tokens=len(prompt),
                            max_new_tokens=int(max_new_tokens))
        try:
            with self.lock:
                now = self._clock()
                if not self.accepting:
                    raise EngineStopped(
                        "decode engine is draining/stopped; "
                        "not admitting")
                if deadline_s is not None \
                        and deadline_s <= self.min_service_s:
                    self._count("decode_deadline_expired")
                    raise DeadlineExceeded(
                        f"deadline {deadline_s}s cannot be met "
                        f"(min service estimate {self.min_service_s}s)")
                if len(self.queue) >= self.max_queue:
                    self._count("decode_shed")
                    raise Overloaded(
                        f"admission queue full ({self.max_queue})")
                if not self._take_token(now):
                    self._count("decode_shed")
                    raise Overloaded(
                        f"rate limit {self._rate} req/s exceeded "
                        f"(burst {int(self._burst)})")
                req = DecodeRequest(
                    prompt, max_new_tokens,
                    None if deadline_s is None else now + deadline_s,
                    now)
                req.span = root
                req.qspan = tracing.Span("decode.queue", parent=root,
                                         clock=self._clock)
                self.queue.append(req)
                self._count("decode_requests")
                self.lock.notify_all()
        except BaseException as e:
            # typed sheds must not leak the root span into the
            # in-flight table
            root.fail(e)
            raise
        return req.handle

    # -- queue maintenance ------------------------------------------------
    def expire_queued(self, now: float) -> List[DecodeRequest]:
        """Drop queued requests whose deadline already passed; the
        engine resolves their handles."""
        with self.lock:
            expired = [r for r in self.queue
                       if r.deadline is not None and now >= r.deadline]
            if expired:
                self.queue = deque(r for r in self.queue
                                   if r not in expired)
        for r in expired:
            self._count("decode_deadline_expired")
            err = DeadlineExceeded(
                f"deadline passed while queued "
                f"({now - r.t_submit:.3f}s since submit)")
            if r.qspan is not None:
                r.qspan.end(type(err).__name__)
            if r.span is not None:
                r.span.fail(err)
            r.handle._resolve(error=err)
        return expired

    # -- slot management --------------------------------------------------
    def free_slot_ids(self) -> List[int]:
        return [i for i in range(self.max_batch) if i not in self.slots]

    def pop_for_prefill(self) -> Optional[DecodeRequest]:
        """Head of the queue if a slot is free and its prompt's pages
        fit the pool right now; None otherwise (the engine may then
        preempt, or just keep decoding)."""
        with self.lock:
            if not self.queue or len(self.slots) >= self.max_batch:
                return None
            head = self.queue[0]
            ctx = len(head.prompt) + len(head.generated)
            if not self.pool.can_fit(ctx):
                return None
            self.prefilling += 1
            return self.queue.popleft()

    def prefill_done(self) -> None:
        """The request from :meth:`pop_for_prefill` is placed, requeued
        or resolved."""
        with self.lock:
            self.prefilling -= 1

    def place(self, req: DecodeRequest, seq_id: int, length: int,
              next_token: int) -> int:
        """Bind a just-prefilled request to the first free slot (the
        caller already allocated its pages under ``seq_id``).
        ``length`` is the KV positions already written (the prefilled
        context); ``next_token`` is the prefill's greedy output — the
        next decode step's input. Returns the slot id."""
        with self.lock:
            slot = self.free_slot_ids()[0]
            self._placements += 1
            self.slots[slot] = RunningSeq(req, seq_id, length,
                                          next_token,
                                          placed_at=self._placements)
            return slot

    def new_seq_id(self) -> int:
        with self.lock:
            self._next_seq_id += 1
            return self._next_seq_id

    def release(self, slot_id: int) -> int:
        """Free a finished/failed slot's pages; returns pages freed."""
        with self.lock:
            rs = self.slots.pop(slot_id, None)
        return self.pool.free_seq(rs.seq_id) if rs is not None else 0

    def preempt_youngest(self) -> Optional[DecodeRequest]:
        """Evict the most recently PLACED slot under pool pressure
        (``placed_at``, not submit time: the slot with the least KV
        accumulated since its last prefill loses the least work —
        evicting by submit time would repeatedly thrash the
        most-progressed sequence once any preemptee re-placed): pages
        counted as evictions, the request re-queued at the FRONT with
        its emitted tokens folded into the prompt (greedy decode
        regenerates the identical continuation)."""
        with self.lock:
            if not self.slots:
                return None
            slot = max(self.slots,
                       key=lambda s: self.slots[s].placed_at)
            rs = self.slots.pop(slot)
            self.pool.evict_seq(rs.seq_id)
            rs.req.preempted += 1
            if rs.req.span is not None:
                # preemption is an EVENT on the request's root span
                # (the request survives, its pages do not), and the
                # re-queue wait gets a fresh queue child span
                rs.req.span.event("preempted", slot=slot,
                                  generated=len(rs.req.generated))
                rs.req.qspan = tracing.Span(
                    "decode.queue", parent=rs.req.span,
                    clock=self._clock, requeued_after_preemption=True)
            self.queue.appendleft(rs.req)
            self._count("decode_preempted")
            return rs.req

    # -- host-tier parking ------------------------------------------------
    def coldest_slot(self, exclude_req: Optional[DecodeRequest] = None
                     ) -> Optional[int]:
        """The slot placed LONGEST ago (min ``placed_at``) — the park
        victim: it carries the most KV, which parking preserves intact
        while preemption would throw it away. ``exclude_req`` keeps
        the sequence whose growth triggered the pressure from parking
        itself."""
        with self.lock:
            cands = [s for s, rs in self.slots.items()
                     if rs.req is not exclude_req]
            if not cands:
                return None
            return min(cands, key=lambda s: self.slots[s].placed_at)

    def park(self, slot_id: int) -> Optional[ParkedSeq]:
        """Move a slot to the parked list: release its pages via
        :meth:`PageTableManager.park_seq` (the caller already
        snapshotted the KV to the host tier under ``seq_id``) and
        record what resume needs. Returns the record, or None for a
        vacated slot."""
        with self.lock:
            rs = self.slots.pop(slot_id, None)
            if rs is None:
                return None
            n_pages = self.pool.park_seq(rs.seq_id)
            pk = ParkedSeq(rs.req, rs.seq_id, rs.length,
                           rs.next_token, n_pages)
            self.parked.append(pk)
        if rs.req.span is not None:
            rs.req.span.event("parked", slot=slot_id, length=rs.length,
                              pages=n_pages)
        self._count("kv_sessions_parked")
        return pk

    def peek_parked(self) -> Optional[ParkedSeq]:
        """Head of the parked list when a slot is free to resume into;
        the caller pops with :meth:`pop_parked` only once the restore
        actually succeeded (pages allocated, KV written back)."""
        with self.lock:
            if not self.parked or len(self.slots) >= self.max_batch:
                return None
            return self.parked[0]

    def pop_parked(self) -> Optional[ParkedSeq]:
        with self.lock:
            return self.parked.popleft() if self.parked else None

    def expire_parked(self, now: float) -> List[ParkedSeq]:
        """Drop parked sessions whose deadline already passed; the
        engine resolves handles and frees the host-tier pages."""
        with self.lock:
            expired = [p for p in self.parked
                       if p.req.deadline is not None
                       and now >= p.req.deadline]
            if expired:
                self.parked = deque(p for p in self.parked
                                    if p not in expired)
        for p in expired:
            self._count("decode_deadline_expired")
            err = DeadlineExceeded(
                f"deadline passed while parked "
                f"({now - p.req.t_submit:.3f}s since submit)")
            if p.req.span is not None:
                p.req.span.fail(err)
            p.req.handle._resolve(error=err)
        return expired

    def active(self) -> Dict[int, RunningSeq]:
        with self.lock:
            return dict(self.slots)

    @property
    def queue_depth(self) -> int:
        with self.lock:
            return len(self.queue)

    def pending(self) -> bool:
        with self.lock:
            return bool(self.queue or self.slots or self.parked
                        or self.prefilling)
