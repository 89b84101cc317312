"""Paged KV cache: the device-resident pool of fixed-size KV pages and
the host-side page-table manager that owns allocation, free, eviction,
REFCOUNTED PREFIX SHARING and copy-on-write.

Port of ``paddle_tpu/inference/decode/kv_cache.py``. The DEVICE side is
two tensors per engine, ``k_pages`` / ``v_pages`` of shape ``(n_layers,
n_pages, page_size, heads, head_dim)``, made once by
:func:`alloc_kv_pool` and then updated IN PLACE by the page writes
(the JAX pool is donated through compiled steps instead). Under
``kv_codec="int8"`` the pools are int8 and :func:`alloc_kv_scales` adds
the per-token-row f32 scale planes ``(n_layers, n_pages, page_size)``.

The HOST side, :class:`PageTableManager`, is a copy of the JAX
package's: a free-list allocator with per-sequence page lists, per-page
refcounts, a chained-hash prefix index, a cached-page LRU and
copy-on-write. Page 0 is the RESERVED trash page for masked lanes.

Below the device pool sits the HOST tier, :class:`HostKVPool`, a copy
of the reference's: int8-encoded page records in host RAM, keyed by
parked session (every page of a sequence the engine parked under pool
pressure) and by prefix chain key (indexed pages the allocator
reclaimed, revivable at prefill). Pools of any dtype take the
``ps.codec`` per-token-row layout there; an int8 pool's records are
its own planes, so park -> resume is bitwise.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._device import resolve_device

__all__ = ["HostKVPool", "PageTableManager", "alloc_kv_pool",
           "alloc_kv_scales"]


def alloc_kv_pool(n_layers: int, n_pages: int, page_size: int,
                  heads: int, head_dim: int, dtype=torch.float32,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(k_pages, v_pages)`` of shape (n_layers, n_pages,
    page_size, heads, head_dim) on ``device`` (default: the card).
    ``dtype=torch.int8`` allocates the quantized pool (pair it with
    :func:`alloc_kv_scales`)."""
    dev = resolve_device(device)
    shape = (int(n_layers), int(n_pages), int(page_size), int(heads),
             int(head_dim))
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def alloc_kv_scales(n_layers: int, n_pages: int, page_size: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-row f32 scale planes for the int8 pool:
    ``(k_scales, v_scales)`` of shape (n_layers, n_pages, page_size)."""
    dev = resolve_device(device)
    shape = (int(n_layers), int(n_pages), int(page_size))
    return (torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev))


def _chain_keys(tokens: Sequence[int], n_blocks: int,
                page_size: int) -> List[bytes]:
    """Chained full-page content hashes: key_i covers tokens
    [0, (i+1)*page_size) — a page is only shareable when the WHOLE
    prefix up to it matches, so the chain folds the previous key in."""
    keys: List[bytes] = []
    prev = b""
    arr = np.asarray(list(tokens), np.int64)
    for i in range(n_blocks):
        block = arr[i * page_size:(i + 1) * page_size].tobytes()
        prev = hashlib.sha1(prev + block).digest()
        keys.append(prev)
    return keys


class HostKVPool:
    """Host-RAM offload tier for KV pages: int8-encoded page records
    keyed two ways — PARKED SESSIONS (every page of an idle sequence,
    restored wholesale on resume) and a PREFIX LRU (individual indexed
    pages the HBM allocator reclaimed, revivable by chain key at
    prefill time).

    A page record is ``(kq, ks, vq, vs)`` numpy arrays: int8 rows
    ``(n_layers, page_size, heads, head_dim)`` plus the per-token-row
    f32 scales ``(n_layers, page_size)`` — exactly the int8 pool's
    plane layout, so :attr:`page_nbytes` is the ps/codec closed form
    ``2 * L * encoded_nbytes(S*H*D, "int8", block=H*D)``.

    ``capacity_bytes`` bounds the tier. Parked sessions are load-
    bearing (a parked request WILL resume) so they evict prefix pages
    to make room but are never evicted themselves; prefix pages age
    out LRU-oldest first. Everything here is plain numpy on the host:
    no device, no locks beyond the caller's (the engine touches it from
    its scheduler thread only)."""

    def __init__(self, n_layers: int, page_size: int, heads: int,
                 head_dim: int, capacity_bytes: int):
        from ...ps.codec import encoded_nbytes

        self.n_layers = int(n_layers)
        self.page_size = int(page_size)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.capacity_bytes = int(capacity_bytes)
        row = self.heads * self.head_dim
        #: encoded bytes one page costs on the host: K and V planes,
        #: one f32 scale per token row per layer
        self.page_nbytes = 2 * self.n_layers * encoded_nbytes(
            self.page_size * row, "int8", block=row)
        self._seqs: Dict[int, List[tuple]] = {}
        self._prefix: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._spilled_pages = 0      # cumulative d2h page count
        self._restored_pages = 0     # cumulative h2d page count
        self._dropped_pages = 0      # refused/aged-out prefix pages

    # -- accounting -------------------------------------------------------
    @property
    def pages_host(self) -> int:
        """Pages resident in the host tier right now."""
        return (sum(len(p) for p in self._seqs.values())
                + len(self._prefix))

    @property
    def bytes_in_use(self) -> int:
        return self.pages_host * self.page_nbytes

    @property
    def spilled_pages(self) -> int:
        return self._spilled_pages

    @property
    def restored_pages(self) -> int:
        return self._restored_pages

    def room_for(self, n_pages: int) -> bool:
        """True when ``n_pages`` fit after aging out every prefix
        page — parked sessions are the only immovable tenants."""
        fixed = sum(len(p) for p in self._seqs.values())
        return (fixed + int(n_pages)) * self.page_nbytes \
            <= self.capacity_bytes

    def _make_room(self, n_pages: int) -> bool:
        """Age out LRU-oldest prefix pages until ``n_pages`` fit;
        False when parked sessions alone exceed the budget."""
        need = int(n_pages) * self.page_nbytes
        while self.bytes_in_use + need > self.capacity_bytes:
            if not self._prefix:
                return False
            self._prefix.popitem(last=False)
            self._dropped_pages += 1
        return True

    # -- parked sessions --------------------------------------------------
    def put_seq(self, key: int, records: Sequence[tuple]) -> bool:
        """Park a session's encoded pages; False when the tier can't
        hold them even after aging the prefix LRU out (caller falls
        back to preemption)."""
        if key in self._seqs:
            raise ValueError(f"session {key} already parked")
        records = list(records)
        if not self._make_room(len(records)):
            return False
        self._seqs[key] = records
        self._spilled_pages += len(records)
        return True

    def pop_seq(self, key: int) -> List[tuple]:
        """Take a parked session's pages back for restore; raises
        KeyError for an unknown session."""
        records = self._seqs.pop(key)
        self._restored_pages += len(records)
        return records

    def drop_seq(self, key: int) -> int:
        """Discard a parked session (deadline expiry, shutdown);
        returns the page count freed."""
        records = self._seqs.pop(key, [])
        self._dropped_pages += len(records)
        return len(records)

    def has_seq(self, key: int) -> bool:
        return key in self._seqs

    # -- prefix LRU -------------------------------------------------------
    def put_prefix(self, key: bytes, record: tuple) -> bool:
        """Spill one reclaimed prefix page under its chain key; the
        newest entry is the warmest. False when there is no room even
        after aging older prefixes out."""
        if key in self._prefix:
            self._prefix.move_to_end(key)
            return True
        if not self._make_room(1):
            self._dropped_pages += 1
            return False
        self._prefix[key] = record
        self._spilled_pages += 1
        return True

    def take_prefix(self, key: bytes) -> Optional[tuple]:
        """Pop a spilled prefix page for revival; None on miss."""
        record = self._prefix.pop(key, None)
        if record is not None:
            self._restored_pages += 1
        return record

    def has_prefix(self, key: bytes) -> bool:
        return key in self._prefix

    # -- views ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready host-tier state (the reference's tools/dump_kv.py
        reads this layout): residency
        per parked session, the prefix LRU in temperature order
        (oldest/coldest first), and the byte accounting."""
        return {
            "page_nbytes": self.page_nbytes,
            "capacity_bytes": self.capacity_bytes,
            "bytes_in_use": self.bytes_in_use,
            "pages_host": self.pages_host,
            "spilled_pages": self._spilled_pages,
            "restored_pages": self._restored_pages,
            "dropped_pages": self._dropped_pages,
            "sessions": {str(k): len(v)
                         for k, v in sorted(self._seqs.items())},
            "prefix_lru": [k.hex()[:12] for k in self._prefix],
        }


class PageTableManager:
    """Free-list page allocator + per-sequence page tables + refcounted
    prefix sharing.

    ``n_pages`` counts the whole pool; page 0 is reserved (trash page),
    so ``capacity`` — the allocatable budget — is ``n_pages - 1``.
    ``max_pages_per_seq`` bounds any one sequence's table row (the
    compiled step's static table width)."""

    def __init__(self, n_pages: int, page_size: int,
                 max_pages_per_seq: int):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (page 0 is the "
                             f"reserved trash page), got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._seqs: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}          # page -> live refcount
        self._index: Dict[bytes, int] = {}       # prefix hash -> page
        self._page_key: Dict[int, bytes] = {}    # page -> its index key
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._evicted_pages = 0
        self._parked_pages = 0
        self._prefix_hits = 0
        self._cached_reclaimed = 0
        self._peak_in_use = 0
        self._peak_shared = 0
        #: monotonic table-mutation epoch: bumped by every operation
        #: that can change a sequence's page list (alloc, append-page,
        #: COW, free/evict/park, adoption). The async decode engine
        #: compares epochs to prove a tick's page tables are unchanged
        #: and reuse device-resident control vectors instead of
        #: rebuilding + re-uploading them.
        self.mutations = 0
        #: optional ``(page, chain_key)`` hook fired just before an
        #: indexed cached page is reclaimed — the engine's host-tier
        #: spill (d2h snapshot of the rows). Purely an optimization:
        #: a raising sink never blocks the allocation.
        self.spill_sink: Optional[Callable[[int, bytes], None]] = None
        self._publish()

    # -- accounting -------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one live sequence (cached
        zero-ref prefix pages are reclaimable, so not in use)."""
        return self.capacity - len(self._free) - len(self._cached)

    @property
    def pages_free(self) -> int:
        """Allocatable budget right now: the free list plus the
        reclaimable cached-page LRU."""
        return len(self._free) + len(self._cached)

    @property
    def pages_cached(self) -> int:
        return len(self._cached)

    @property
    def pages_shared(self) -> int:
        """Pages currently backing more than one live sequence."""
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def evicted_pages(self) -> int:
        return self._evicted_pages

    @property
    def parked_pages(self) -> int:
        """Cumulative pages released by :meth:`park_seq` — kept apart
        from ``evicted_pages`` because parked KV survives on the host
        and needs no recompute."""
        return self._parked_pages

    @property
    def prefix_hits(self) -> int:
        """Cumulative pages served from the prefix index instead of a
        fresh allocation + recompute."""
        return self._prefix_hits

    @property
    def peak_pages_in_use(self) -> int:
        return self._peak_in_use

    @property
    def peak_pages_shared(self) -> int:
        return self._peak_shared

    def page_ref(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def _publish(self) -> None:
        from ... import profiler

        self.mutations += 1
        self._peak_in_use = max(self._peak_in_use, self.pages_in_use)
        self._peak_shared = max(self._peak_shared, self.pages_shared)
        profiler.set_counter("kv_pages_in_use", self.pages_in_use)
        profiler.set_counter("kv_page_evictions", self._evicted_pages)
        profiler.set_counter("kv_pages_shared", self.pages_shared)
        profiler.set_counter("kv_pages_cached", len(self._cached))

    # -- page plumbing ----------------------------------------------------
    def _drop_index(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None and self._index.get(key) == page:
            del self._index[key]

    def _take_page(self) -> Optional[int]:
        """One allocatable page: free list first, then reclaim the
        LRU-oldest cached prefix page (its index entry dies with it)."""
        if self._free:
            return self._free.pop()
        if self._cached:
            page, _ = self._cached.popitem(last=False)
            if self.spill_sink is not None:
                key = self._page_key.get(page)
                if key is not None:
                    try:
                        self.spill_sink(page, key)
                    except Exception:
                        pass   # spill is best-effort, never gates alloc
            self._drop_index(page)
            self._cached_reclaimed += 1
            return page
        return None

    def _release_page(self, page: int) -> bool:
        """Drop one reference; a zero-ref indexed page parks in the
        cached LRU (KV stays valid), an unindexed one returns to the
        free list. Returns True when the page actually left live use.
        A page with no recorded reference is a bookkeeping bug — the
        refcount must never go negative."""
        ref = self._refs.get(page)
        if ref is None or ref <= 0:
            raise ValueError(f"page {page} released below refcount 0")
        if ref > 1:
            self._refs[page] = ref - 1
            return False
        del self._refs[page]
        if page in self._page_key:
            self._cached[page] = None
            self._cached.move_to_end(page)
        else:
            self._free.append(page)
        return True

    # -- allocation -------------------------------------------------------
    def pages_for_tokens(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_fit(self, n_tokens: int) -> bool:
        n = self.pages_for_tokens(n_tokens)
        return n <= self.max_pages_per_seq and n <= self.pages_free

    def alloc_seq(self, seq_id: int, n_tokens: int) -> Optional[List[int]]:
        """Allocate the pages for a ``n_tokens``-long context; None when
        the pool (or the table width) can't hold it — the caller decides
        between shedding and evicting."""
        return self.alloc_seq_shared(seq_id, (), n_tokens)

    def alloc_seq_shared(self, seq_id: int, shared_pages: Sequence[int],
                         n_tokens: int) -> Optional[List[int]]:
        """Allocate a sequence whose first pages are SHARED prefix
        pages (from :meth:`match_prefix`): the shared pages gain a
        reference (revived out of the cached LRU when parked there) and
        only the suffix allocates fresh pages. ``shared_pages=()`` is
        the plain allocation path."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already has pages")
        shared = [int(p) for p in shared_pages]
        n = self.pages_for_tokens(n_tokens)
        fresh_n = n - len(shared)
        if fresh_n < 0 or n > self.max_pages_per_seq:
            return None
        # shared pages revived from the cache don't consume budget;
        # fresh ones must fit what's left after the revival
        budget = len(self._free) + len(
            [p for p in self._cached if p not in shared])
        if fresh_n > budget:
            return None
        for p in shared:
            if p in self._cached:
                del self._cached[p]
            self._refs[p] = self._refs.get(p, 0) + 1
        fresh: List[int] = []
        for _ in range(fresh_n):
            page = self._take_page()
            if page is None:     # raced below the budget estimate
                for q in fresh:
                    self._free.append(q)
                    del self._refs[q]
                for p in shared:
                    self._release_page(p)
                self._publish()
                return None
            self._refs[page] = 1
            fresh.append(page)
        pages = shared + fresh
        self._seqs[seq_id] = pages
        if shared:
            self._prefix_hits += len(shared)
            from ... import profiler

            profiler.bump_counter("kv_prefix_hits", len(shared))
        self._publish()
        return list(pages)

    def adopt_pages(self, seq_id: int, tokens: Sequence[int]
                    ) -> Optional[Tuple[List[int], List[Tuple[int, int]]]]:
        """Adopt SHIPPED prefill pages (serving/disagg.py migration):
        ``tokens`` is the full-page context a remote prefill worker
        computed KV for — a whole number of pages, chained-hash keyed
        exactly like :meth:`register_prefix` so shipped pages dedupe
        against locally prefilled ones.

        Per full page: an already-indexed page is SHARED (reference
        bumped, revived from the cached LRU, counted as a prefix hit —
        never duplicated); an unindexed one allocates a slot (free list
        first, then LRU reclaim) and is indexed immediately. Returns
        ``(pages, fresh)`` where ``fresh`` lists ``(block_index, page)``
        pairs whose KV the engine still has to write — shared pages
        already hold it. Returns None when the pool can't hold the
        fresh pages (caller falls back to local prefill); raises
        ValueError when ``seq_id`` already holds pages (double-adopt)
        or ``tokens`` is not a non-empty whole number of pages."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already has pages")
        toks = [int(t) for t in tokens]
        n_full, rem = divmod(len(toks), self.page_size)
        if n_full <= 0 or rem:
            raise ValueError(
                f"adoption ships whole pages: got {len(toks)} tokens "
                f"for page_size {self.page_size}")
        if n_full > self.max_pages_per_seq:
            return None
        pages: List[int] = []
        fresh: List[Tuple[int, int]] = []
        fresh_set: set = set()
        shared_n = 0
        for i, key in enumerate(_chain_keys(toks, n_full,
                                            self.page_size)):
            page = self._index.get(key)
            if page is not None:         # must share, not duplicate
                if page in self._cached:
                    del self._cached[page]
                self._refs[page] = self._refs.get(page, 0) + 1
                shared_n += 1
                pages.append(page)
                continue
            page = self._take_page()
            if page is None:             # pool dry: undo everything
                for q in reversed(pages):
                    if q in fresh_set:
                        self._drop_index(q)
                        del self._refs[q]
                        self._free.append(q)
                    else:
                        self._release_page(q)
                self._publish()
                return None
            self._refs[page] = 1
            self._index[key] = page
            self._page_key[page] = key
            fresh.append((i, page))
            fresh_set.add(page)
            pages.append(page)
        self._seqs[seq_id] = pages
        if shared_n:
            self._prefix_hits += shared_n
            from ... import profiler

            profiler.bump_counter("kv_prefix_hits", shared_n)
        self._publish()
        return list(pages), fresh

    def append_token(self, seq_id: int, new_len: int) -> Optional[int]:
        """Ensure the page holding position ``new_len - 1`` exists.
        Returns the newly allocated page id, None when the existing
        tail page covers it; raises KeyError for an unknown sequence
        and returns ``-1`` when the pool or table row is exhausted
        (caller evicts or preempts)."""
        pages = self._seqs[seq_id]
        need = self.pages_for_tokens(new_len)
        if need <= len(pages):
            return None
        if need > self.max_pages_per_seq:
            return -1
        page = self._take_page()
        if page is None:
            return -1
        self._refs[page] = 1
        pages.append(page)
        self._publish()
        return page

    # -- prefix sharing ---------------------------------------------------
    def match_prefix(self, tokens: Sequence[int],
                     limit: Optional[int] = None) -> List[int]:
        """Longest chain of indexed full-prefix pages for ``tokens``.
        ``limit`` caps the shareable page count — the prefill caller
        passes ``(ctx - 1) // page_size`` so at least one suffix token
        always remains to compute logits from."""
        n_full = len(tokens) // self.page_size
        if limit is not None:
            n_full = min(n_full, int(limit))
        if n_full <= 0:
            return []
        out: List[int] = []
        for key in _chain_keys(tokens, n_full, self.page_size):
            page = self._index.get(key)
            if page is None:
                break
            out.append(page)
        return out

    def is_indexed(self, key: bytes) -> bool:
        """True when a chain key already resolves to an HBM-resident
        page (shared or cached) — the host-tier revival path skips
        these."""
        return key in self._index

    def register_prefix(self, seq_id: int,
                        tokens: Sequence[int]) -> int:
        """Index every FULL page of ``tokens`` (the just-prefilled
        context) under its chained hash so later requests can share it.
        Pages already indexed (re-prefill over shared pages) keep their
        entry. Returns the number of pages newly indexed."""
        pages = self._seqs.get(seq_id)
        if pages is None:
            return 0
        n_full = min(len(tokens) // self.page_size, len(pages))
        added = 0
        for i, key in enumerate(
                _chain_keys(tokens, n_full, self.page_size)):
            page = pages[i]
            if key in self._index:
                continue       # an equivalent page already serves it
            if page in self._page_key:
                continue       # page already indexed under its own key
            self._index[key] = page
            self._page_key[page] = key
            added += 1
        return added

    # -- copy-on-write ----------------------------------------------------
    def needs_cow(self, seq_id: int, pos: int) -> bool:
        """True when writing position ``pos`` would land on a page this
        sequence does not exclusively own."""
        pages = self._seqs[seq_id]
        idx = int(pos) // self.page_size
        if idx >= len(pages):
            return False
        page = pages[idx]
        return self._refs.get(page, 0) > 1 or page in self._page_key

    def cow_page(self, seq_id: int, pos: int):
        """Make the page holding ``pos`` privately writable.

        Returns None when it already is (an indexed-but-exclusive page
        is un-indexed in place — the sole owner may mutate it), a
        ``(src, dst)`` page pair when a copy slot was allocated (the
        ENGINE copies src→dst on device before writing), or ``-1``
        when the pool is dry (caller preempts)."""
        pages = self._seqs[seq_id]
        idx = int(pos) // self.page_size
        page = pages[idx]
        ref = self._refs.get(page, 0)
        if ref <= 1:
            self._drop_index(page)
            return None
        dst = self._take_page()
        if dst is None:
            return -1
        self._refs[page] = ref - 1
        self._refs[dst] = 1
        pages[idx] = dst
        self._publish()
        return (page, dst)

    # -- free / evict -----------------------------------------------------
    def free_seq(self, seq_id: int) -> int:
        """Release a finished sequence's references; returns the number
        of pages this sequence held. Shared pages merely decrement;
        zero-ref indexed pages park in the cached LRU."""
        pages = self._seqs.pop(seq_id, [])
        for page in reversed(pages):
            self._release_page(page)
        self._publish()
        return len(pages)

    def evict_seq(self, seq_id: int) -> int:
        """Preempt a LIVE sequence: release its references and count
        the pages as evictions (the scheduler re-queues the sequence
        for a fresh prefill). A shared page is never reclaimed from
        under its other holders — eviction decrements like free."""
        pages = self._seqs.pop(seq_id, [])
        for page in reversed(pages):
            self._release_page(page)
        self._evicted_pages += len(pages)
        self._publish()
        return len(pages)

    def park_seq(self, seq_id: int) -> int:
        """Park a LIVE sequence into the host tier: release its
        references like :meth:`evict_seq` but WITHOUT counting
        evictions — the caller already snapshotted the KV to a
        :class:`HostKVPool`, so nothing needs recomputing and
        ``kv_page_evictions`` keeps meaning 'prefill again'."""
        pages = self._seqs.pop(seq_id, [])
        for page in reversed(pages):
            self._release_page(page)
        self._parked_pages += len(pages)
        self._publish()
        return len(pages)

    def install_cached(self, key: bytes) -> Optional[int]:
        """Re-enter a restored host-tier prefix page as a CACHED
        indexed page: allocate a slot, index it under ``key``, park it
        warmest in the reclaimable LRU with zero refs. The caller
        writes the page's KV rows on device before anything can match
        it. None when the key is already indexed (nothing to do) or
        the pool is dry."""
        if key in self._index:
            return None
        page = self._take_page()
        if page is None:
            return None
        self._index[key] = page
        self._page_key[page] = key
        self._cached[page] = None
        self._cached.move_to_end(page)
        self._publish()
        return page

    # -- views ------------------------------------------------------------
    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs.get(seq_id, ()))

    def table_row(self, seq_id: int) -> np.ndarray:
        """This sequence's page-table row, -1-padded to the static
        width."""
        row = np.full((self.max_pages_per_seq,), -1, np.int32)
        pages = self._seqs.get(seq_id, ())
        row[:len(pages)] = pages
        return row

    def utilization_pct(self) -> float:
        return round(100.0 * self.pages_in_use / max(1, self.capacity), 2)

    def snapshot(self) -> dict:
        """JSON-ready state for tools/dump_kv.py: pool geometry,
        per-sequence tables, refcounts, shared/cached/indexed pages."""
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "max_pages_per_seq": self.max_pages_per_seq,
            "pages_in_use": self.pages_in_use,
            "pages_free": len(self._free),
            "pages_cached": len(self._cached),
            "pages_shared": self.pages_shared,
            "utilization_pct": self.utilization_pct(),
            "evicted_pages": self._evicted_pages,
            "parked_pages": self._parked_pages,
            "prefix_hits": self._prefix_hits,
            "cached_reclaimed": self._cached_reclaimed,
            "peak_pages_in_use": self._peak_in_use,
            "peak_pages_shared": self._peak_shared,
            "seqs": {str(sid): list(pages)
                     for sid, pages in self._seqs.items()},
            "refs": {str(p): r for p, r in self._refs.items()},
            "cached": list(self._cached),
            "indexed": sorted(self._page_key),
        }
