"""Host-side bookkeeping for the continuous-batching serve loop.

A copy of the JAX package's ``serve/slots.py`` (pure numpy).

The device side is a fixed-capacity slot table: one sharded DecodeCache of
``n_slots`` rows plus per-slot pos/active vectors. This module tracks the
host mirror of that state — which request owns which slot, what its next
absolute position is, and which rows are live — so every ServeLoop tick
can assemble the (token, pos, active) vectors for one ``decode_step``
dispatch without touching device memory.

Mirrors the masked-tau scan in ``core/engine.client_update_many``: a
retired or never-filled slot is an exact device no-op, so one static-shape
program absorbs any mix of request lengths (DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request: ragged prompt + stop conditions."""

    rid: int
    tokens: np.ndarray  # [plen] int32 prompt ids
    max_new: int  # retire after this many generated tokens
    eos_id: Optional[int] = None  # retire early on this id (optional)
    arrival: int = 0  # tick at which the request becomes admissible
    patches: Optional[np.ndarray] = None  # [num_patches, vision_dim]
    #   vision input — REQUIRED for vlm models (serving them text-only
    #   would silently ignore the image)

    # filled in by the loop
    out: List[int] = dataclasses.field(default_factory=list)
    admit_tick: Optional[int] = None
    done_tick: Optional[int] = None
    failed: Optional[str] = None  # rejection reason (oversized request /
    #   impossible pool demand) — the loop records it and KEEPS SERVING
    #   instead of crashing the whole trace
    tok_walls: List[float] = dataclasses.field(default_factory=list)
    #   wall-clock (time.time()) at which each entry of ``out`` was
    #   recorded — tok_walls[0] is the first-token time (TTFT numerator),
    #   diffs are inter-token latencies (benchmarks/serve_slo.py)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")

    @property
    def plen(self) -> int:
        return int(self.tokens.size)

    def clone(self) -> "Request":
        """Fresh un-run copy (own token buffer, empty out/tick fields) —
        for replaying one trace through several loops (parity, warmup)."""
        return Request(self.rid, self.tokens.copy(), self.max_new,
                       self.eos_id, self.arrival,
                       None if self.patches is None else self.patches.copy())

    def finished(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        return self.eos_id is not None and len(self.out) > 0 \
            and self.out[-1] == self.eos_id


class RequestQueue:
    """Arrival-ordered queue; requests become visible at their tick."""

    def __init__(self, requests):
        self._pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))

    def __len__(self) -> int:
        return len(self._pending)

    def peek_arrived(self, tick: int) -> Optional[Request]:
        """Next admissible request WITHOUT removing it (admission
        backpressure peeks first: an admissible head stays queued when the
        page pool can't hold it yet)."""
        if self._pending and self._pending[0].arrival <= tick:
            return self._pending[0]
        return None

    def pop_arrived(self, tick: int) -> Optional[Request]:
        if self._pending and self._pending[0].arrival <= tick:
            return self._pending.popleft()
        return None


class SlotTable:
    """Host mirror of the device slot table: ``n_slots`` rows.

    ``pos[s]`` is the absolute position the NEXT decoded token of slot s
    will occupy; ``active[s]`` mirrors the device-side mask (False rows are
    exact no-ops in decode_step); ``last_tok[s]`` is the token fed into the
    next decode dispatch.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need n_slots >= 1")
        self.n_slots = n_slots
        self.req: List[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int32)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if not self.active[s]]

    def live_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.active[s]]

    def any_active(self) -> bool:
        return bool(self.active.any())

    def admit(self, slot: int, req: Request, first_tok: int, tick: int):
        """Bind `req` to `slot` with its prefill-produced first token."""
        assert not self.active[slot], f"slot {slot} is live"
        req.admit_tick = tick
        req.out.append(int(first_tok))
        req.tok_walls.append(time.time())
        self.req[slot] = req
        self.pos[slot] = req.plen  # the first generated token's position
        self.active[slot] = True
        self.last_tok[slot] = int(first_tok)

    def rebind(self, slot: int, req: Request):
        """Re-bind a PREEMPTED request whose pool pages were just restored:
        generation resumes mid-stream, so no first token is appended —
        ``pos`` picks up at ``plen + len(out) - 1`` (the position its next
        decoded token will occupy) and ``last_tok`` re-feeds the last
        emitted token. ``admit_tick`` keeps its original value (TTFT is a
        first-token property; preemption only stretches inter-token gaps)."""
        assert not self.active[slot], f"slot {slot} is live"
        assert req.out, "rebind needs an already-started request"
        self.req[slot] = req
        self.pos[slot] = req.plen + len(req.out) - 1
        self.active[slot] = True
        self.last_tok[slot] = int(req.out[-1])

    def append(self, slot: int, tok: int):
        """Record one decoded token for a live slot."""
        self.req[slot].out.append(int(tok))
        self.req[slot].tok_walls.append(time.time())
        self.pos[slot] += 1
        self.last_tok[slot] = int(tok)

    def retire(self, slot: int, tick: int) -> Request:
        """Free the slot (reusable by the next admission — the device row
        is left in place; active=False makes it an exact no-op)."""
        req = self.req[slot]
        req.done_tick = tick
        self.req[slot] = None
        self.active[slot] = False
        return req

    def evict(self, slot: int) -> Request:
        """Unbind a live slot WITHOUT finishing the request (preemption):
        the request keeps its emitted tokens and waits for rebind()."""
        req = self.req[slot]
        self.req[slot] = None
        self.active[slot] = False
        return req


class PageAllocator:
    """Host-side refcounted free-list allocator over the shared KV page pool.

    Pages are unit-granular (no splitting/coalescing, so external
    fragmentation cannot exist); the invariants that CAN break — and that
    ``check()`` asserts — are conservation (free + in-use == n_pages),
    disjointness, no double alloc/free, and refcount conservation (every
    page's refcount equals the number of owners referencing it).
    Allocation is all-or-nothing: a request either gets every page it
    asked for or none (admission backpressure, never a half-admitted slot).

    Refcounts (prefix caching, DESIGN.md §12.2): ``alloc`` hands out pages
    at refcount 1; ``share`` adds an owner to an in-use page (a page-table
    row aliasing a cached prefix page, or the prefix cache itself);
    ``free`` DROPS one reference per id and only returns a page to the
    free list when its count reaches 0 — shared read-only prefix pages
    survive their original owner's retirement until the cache lets go.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("need n_pages >= 1 and page_size >= 1")
        self.n_pages, self.page_size = n_pages, page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))  # pop() asc
        self._used: set = set()
        self._refs: Dict[int, int] = {}  # page id -> owner count (>= 1)
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._used)

    def pages_for(self, rows: int) -> int:
        """Pages covering `rows` KV rows."""
        return -(-max(rows, 0) // self.page_size)

    def refcount(self, page: int) -> int:
        """Current owner count of a page (0 = free)."""
        return self._refs.get(int(page), 0)

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """n page ids (int32) at refcount 1, or None if the pool can't
        cover it NOW (caller backpressures; retirement will free pages)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        assert not self._used.intersection(ids), "double allocation"
        self._used.update(ids)
        for i in ids:
            self._refs[i] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._used))
        return np.asarray(ids, np.int32)

    def share(self, ids) -> None:
        """Add one owner to each in-use page (prefix-cache aliasing)."""
        for i in ids:
            i = int(i)
            if i < 0:
                continue
            assert i in self._used, f"share of free page {i}"
            self._refs[i] += 1

    def free(self, ids) -> None:
        """Drop one reference per id; a page returns to the free list only
        at refcount 0 (shared prefix pages outlive individual owners)."""
        for i in ids:
            i = int(i)
            if i < 0:
                continue  # unallocated page-table slots ride along
            assert i in self._used, f"double free of page {i}"
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                self._used.discard(i)
                self._free.append(i)

    def check(self, page_tables=None, cached_pages=None) -> None:
        """Assert the free-list + refcount invariants (tests call this
        after every admit/preempt/retire storm).

        ``page_tables``: optional iterable of page-table rows (any array
        of page ids, -1 skipped) and ``cached_pages``: optional iterable
        of pages the prefix cache holds a reference to — when given,
        every in-use page's refcount must equal the number of rows
        referencing it plus its cache reference (refcount conservation),
        and no in-use page may be unreferenced (leak)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids on the free list"
        assert not free & self._used, "page both free and in use"
        assert len(free) + len(self._used) == self.n_pages, "pages leaked"
        assert all(0 <= i < self.n_pages for i in free | self._used)
        assert set(self._refs) == self._used, "refcount ledger out of sync"
        assert all(c >= 1 for c in self._refs.values()), "zombie refcount"
        if page_tables is None and cached_pages is None:
            return
        expect: Dict[int, int] = {}
        for row in (page_tables or ()):
            for i in np.asarray(row).reshape(-1):
                if int(i) >= 0:
                    expect[int(i)] = expect.get(int(i), 0) + 1
        for i in (cached_pages or ()):
            expect[int(i)] = expect.get(int(i), 0) + 1
        assert set(expect) == self._used, (
            f"referenced pages {sorted(set(expect) - self._used)} not in "
            f"use / in-use pages {sorted(self._used - set(expect))} "
            "unreferenced (leak)")
        for i, c in expect.items():
            assert self._refs[i] == c, (
                f"page {i}: refcount {self._refs[i]} != {c} references")


class PrefixCache:
    """Host-side content-addressed prefix cache over pool pages
    (DESIGN.md §12.2).

    Keys are the raw token-id bytes of page-aligned prompt prefixes
    (``tokens[:(j+1)*page_size].tobytes()`` — exact content addressing,
    no hash collisions); values are physical page ids. The cache itself
    holds one allocator reference per published page, so a cached page
    survives its publishing request's retirement and is only returned to
    the free list by ``evict_for`` (LRU, under pool pressure).

    Only decode-write-free pages are published: page ``j`` is shareable
    iff ``(j+1)*page_size <= plen`` — decode writes start at row
    ``plen``, i.e. page ``plen // page_size``, so published pages are
    read-only forever (no copy-on-write needed). ``lookup`` additionally
    caps the hit run at ``(plen-1) // page_size`` pages so at least one
    suffix token remains to prefill — the first generated token needs a
    forward pass.
    """

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.ps = allocator.page_size
        self._pages: Dict[bytes, int] = {}  # prefix bytes -> page id
        self._lru: Dict[bytes, int] = {}  # prefix bytes -> last-touch clock
        self._clock = 0

    def __len__(self) -> int:
        return len(self._pages)

    @property
    def pages(self) -> set:
        """Pages the cache currently holds a reference to."""
        return set(self._pages.values())

    def _key(self, tokens: np.ndarray, j: int) -> bytes:
        return tokens[: (j + 1) * self.ps].tobytes()

    def _touch(self, key: bytes) -> None:
        self._clock += 1
        self._lru[key] = self._clock

    def lookup(self, tokens) -> List[int]:
        """Longest run of cached full pages from page 0 (ids NOT yet
        ref'd — the caller ``share``s them before any eviction can run)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ids: List[int] = []
        for j in range((int(tokens.size) - 1) // self.ps):
            key = self._key(tokens, j)
            pid = self._pages.get(key)
            if pid is None:
                break
            self._touch(key)
            ids.append(pid)
        return ids

    def register(self, tokens, page_row, plen: int) -> None:
        """Publish a fully-prefilled prompt's decode-write-free pages.
        Already-known prefixes are just touched (their pages may belong
        to another slot); each newly published page gains the cache's
        reference."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        for j in range(int(plen) // self.ps):
            key = self._key(tokens, j)
            if key in self._pages:
                self._touch(key)
                continue
            pid = int(page_row[j])
            self._pages[key] = pid
            self.alloc.share([pid])
            self._touch(key)

    def evict_for(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` LRU entries whose page has no other
        owner (refcount 1 = cache-only), returning them to the free
        list; entries still aliased by live slots are skipped. Returns
        the number of pages actually freed."""
        freed = 0
        for key in sorted(self._lru, key=self._lru.get):
            if freed >= n_pages:
                break
            pid = self._pages[key]
            if self.alloc.refcount(pid) == 1:
                self.alloc.free([pid])
                del self._pages[key]
                del self._lru[key]
                freed += 1
        return freed
