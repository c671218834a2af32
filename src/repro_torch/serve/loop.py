"""Continuous-batching decode over a shared KV page pool (port of
``repro/serve/loop.py``: the ``ServeLoop`` base and ``PagedServeLoop``).

Each tick runs admit -> one paged decode step over every slot -> retire ->
admit again (``AdmissionScheduler.tick``). Admission prefills one request
(batch 1; full-attention prompts padded to a length bucket, SWA prompts at
their exact length) and copies its KV rows onto freshly allocated pool
pages; retired and never-filled slots ride along inactive and write
nothing. With ``cache_update="kernel"`` every decode tick launches the
paged-decode kernel once per layer and every admission launches the
paged-insert kernel once (CUDA tensors), or runs their plain versions
(CPU tensors).

Differences from the JAX loop: pools are updated in place (no donation);
the contiguous ``ServeLoop`` cache, ``SerialLoop``, the "mask" write,
sampled decode, prefix caching, chunked prefill, preemption and the
sanitizer lane are not ported yet (ROADMAP.md, "the rest of serving") and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.scheduler import AdmissionScheduler
from repro_torch.models.model import Model, decode_capability
from repro_torch.models.transformer import insert_cache_pages
from repro_torch.serve.sampling import GREEDY, SamplerConfig, make_sample_fn
from repro_torch.serve.slots import PageAllocator, Request, RequestQueue, SlotTable


class ServeUnsupportedError(RuntimeError):
    """Model has no decode path the port serves — carries the reason."""


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'the rest of serving')")


class ServeLoop(AdmissionScheduler):
    """Continuous-batching loop: admission + one decode step per tick.

    The base holds the admission, fold and commit logic and the prefill;
    the KV cache it drives is the subclass's (``PagedServeLoop``). The JAX
    package's contiguous-cache ``ServeLoop`` is not ported yet.

    Args:
      model, params: a ``Model`` and its params, on ``device``.
      device: where the loop runs; ``None`` means ``cuda`` (raises when no
        GPU is present).
      n_slots: decode batch rows.
      capacity: KV rows per slot for full attention (SWA models use their
        window). A request that can never fit is rejected, not fatal.
      bucket: prompt-length rounding for full-attention prefill.
      cache_update: "kernel" (CUDA kernels for CUDA tensors) or "scatter"
        (the plain versions on any device).
      sampler: greedy only (``GREEDY``).
    """

    def __init__(self, model: Model, params, *, device=None, n_slots: int = 8,
                 capacity: int = 256, bucket: int = 16,
                 cache_update: str = "kernel",
                 sampler: Optional[SamplerConfig] = None):
        if type(self) is ServeLoop:
            _not_ported("the contiguous-cache ServeLoop")
        super().__init__()
        ok, why = decode_capability(model)
        if not ok:
            raise ServeUnsupportedError(why)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, loop on {self.device}")
        if cache_update not in ("kernel", "scatter"):
            _not_ported(f"cache_update={cache_update!r}")
        cfg = model.config
        self.model, self.params, self.cfg = model, params, cfg
        self.n_slots, self.capacity, self.bucket = n_slots, capacity, bucket
        self.cache_update = cache_update
        self.sampler = sampler or GREEDY
        self._sample = make_sample_fn(self.sampler)
        # the SWA ring keeps the last W slots of the PADDED prompt, so SWA
        # models prefill at the exact prompt length
        self.exact_prefill = bool(cfg.sliding_window)
        self.reset()

    # -- subclass hooks -------------------------------------------------------
    def _init_cache(self):
        raise NotImplementedError

    def _insert_request(self, slot: int, req: Request, one):
        raise NotImplementedError

    def _decode_logits(self):
        raise NotImplementedError

    def reset(self):
        """Fresh slot table and cache."""
        self.cache = self._init_cache()
        self.table = SlotTable(self.n_slots)
        self.t = 0
        self._queue: Optional[RequestQueue] = None
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.prefilled_tokens = 0
        self.decode_s = 0.0  # host clock, each tick ends in a token readback
        self.prefill_s = 0.0  # prefill + first-token readback + insert enqueue
        self.rejected: List[Request] = []

    def _t(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- admission -------------------------------------------------------------
    def _admission_error(self, req: Request) -> Optional[str]:
        if not self.cfg.sliding_window and \
                req.plen + req.max_new - 1 > self.capacity:
            return (f"plen {req.plen} + max_new {req.max_new} exceeds "
                    f"cache capacity {self.capacity}")
        return None

    def _can_admit(self, req: Request) -> bool:
        return True

    def _prefill(self, req: Request):
        plen = req.plen
        padded = plen if self.exact_prefill else \
            min(_round_up(plen, self.bucket), self.capacity)
        toks = np.zeros((1, padded), np.int32)
        toks[0, :plen] = req.tokens
        kw = {"pad_to": self.capacity}
        if not self.exact_prefill:
            kw["length"] = self._t([plen], torch.int32)
        logits, one = self.model.prefill(
            self.params, {"tokens": self._t(toks, torch.int32)}, **kw)
        rid = self._t([req.rid], torch.int32)
        first = self._sample(logits, rid, torch.zeros_like(rid))
        self.prefill_dispatches += 1
        self.prefilled_tokens += plen
        return int(first[0]), one

    def _retire(self, slot: int):
        self.table.retire(slot, self.t)

    def _begin_request(self, slot: int, req: Request):
        t0 = time.perf_counter()
        first, one = self._prefill(req)
        self._insert_request(slot, req, one)
        self.prefill_s += time.perf_counter() - t0
        self.table.admit(slot, req, first, self.t)
        if req.finished():
            self._retire(slot)

    def _admit(self):
        """Fill free slots from the arrived queue (FIFO). Oversized requests
        are recorded as failed; a request that fits later stays queued."""
        queue = self._queue
        if queue is None:
            return
        while True:
            free = self.table.free_slots()
            if not free:
                return
            req = queue.peek_arrived(self.t)
            if req is None:
                return
            err = self._admission_error(req)
            if err is not None:
                queue.pop_arrived(self.t)
                req.failed = f"request {req.rid}: {err}"
                req.done_tick = self.t
                self.rejected.append(req)
                continue
            if not self._can_admit(req):
                return
            queue.pop_arrived(self.t)
            self._begin_request(free[0], req)

    # -- one tick ----------------------------------------------------------------
    def _has_work(self) -> bool:
        return self.table.any_active()

    def _pending(self) -> bool:
        return self._queue is not None and len(self._queue) > 0

    def _fold(self):
        table = self.table
        rid = self._t([r.rid if r else 0 for r in table.req], torch.int32)
        nstep = self._t([len(r.out) if r else 0 for r in table.req], torch.int32)
        t0 = time.perf_counter()
        nxt = self._sample(self._decode_logits(), rid, nstep).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_dispatches += 1
        return nxt

    def _commit(self, nxt_np) -> None:
        table = self.table
        for slot in table.live_slots():
            table.append(slot, int(nxt_np[slot]))
            if table.req[slot].finished():
                self._retire(slot)

    def tick(self, queue: Optional[RequestQueue] = None):
        if queue is not None:
            self._queue = queue
        super().tick()

    def _extra_stats(self) -> Dict:
        return {}

    def run(self, requests: Sequence[Request]) -> Dict:
        """Drive every request to completion from a fresh slot table;
        returns per-run stats."""
        self.reset()
        self._queue = RequestQueue(requests)
        t0 = time.perf_counter()
        self.drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        toks = sum(len(r.out) for r in requests)
        return dict(
            wall_s=wall,
            ticks=self.t,
            tokens=toks,
            tok_s=toks / max(wall, 1e-9),
            decode_dispatches=self.decode_dispatches,
            prefill_dispatches=self.prefill_dispatches,
            prefilled_tokens=self.prefilled_tokens,
            decode_s=self.decode_s,
            prefill_s=self.prefill_s,
            failed=len(self.rejected),
            failed_rids=[r.rid for r in self.rejected],
            **self._extra_stats(),
        )


class PagedServeLoop(ServeLoop):
    """Continuous batching over a shared KV page pool.

    The host ``PageAllocator`` hands each admitted request
    ``ceil(min(plen + max_new - 1, window or inf) / page_size)`` pages,
    recorded in its slot's page-table row, which rides into every decode
    step. When the pool cannot cover the head request it waits in the queue
    (FIFO backpressure); a request larger than the whole pool is rejected.
    Retirement returns the pages; a reused page is overwritten in full at
    the next admission and masked arithmetically until then.

    ``prefix_cache``, ``prefill_chunk``, ``preempt`` and ``sanitize`` are
    the JAX loop's front-end scheduler options; they are not ported yet and
    raise ``NotImplementedError`` when set.
    """

    def __init__(self, model: Model, params, *, device=None, n_slots: int = 8,
                 capacity: int = 256, page_size: int = 16,
                 n_pages: Optional[int] = None, bucket: int = 16,
                 cache_update: str = "kernel",
                 sampler: Optional[SamplerConfig] = None,
                 prefix_cache: bool = False, prefill_chunk: Optional[int] = None,
                 preempt: bool = False, sanitize=None):
        for name, val in (("prefix_cache", prefix_cache),
                          ("prefill_chunk", prefill_chunk),
                          ("preempt", preempt), ("sanitize", sanitize)):
            if val:
                _not_ported(f"PagedServeLoop({name}=...)")
        cfg = model.config
        self.page_size = page_size
        W = cfg.sliding_window
        self.pages_per_slot = -(-(W if W else capacity) // page_size)
        if not W:  # prefill pad_to must equal the paged logical capacity
            capacity = self.pages_per_slot * page_size
        self.n_pages = n_slots * self.pages_per_slot if n_pages is None else n_pages
        super().__init__(model, params, device=device, n_slots=n_slots,
                         capacity=capacity, bucket=bucket,
                         cache_update=cache_update, sampler=sampler)

    def _init_cache(self):
        self.allocator = PageAllocator(self.n_pages, self.page_size)
        self.page_table = np.full((self.n_slots, self.pages_per_slot), -1, np.int32)
        return self.model.init_paged_cache(self.n_slots, self.n_pages, self.page_size)

    def _rows_needed(self, req: Request) -> int:
        rows = req.plen + req.max_new - 1
        W = self.cfg.sliding_window
        return min(rows, W) if W else rows

    def _admission_error(self, req: Request) -> Optional[str]:
        err = super()._admission_error(req)
        if err is not None:
            return err
        need = self.allocator.pages_for(self._rows_needed(req))
        if need > self.n_pages:
            return (f"needs {need} pages ({self._rows_needed(req)} KV rows) "
                    f"but the pool has only {self.n_pages} — can never be "
                    "admitted")
        return None

    def _can_admit(self, req: Request) -> bool:
        return self.allocator.free_pages >= \
            self.allocator.pages_for(self._rows_needed(req))

    def _insert_request(self, slot: int, req: Request, one):
        need = self.allocator.pages_for(self._rows_needed(req))
        ids = self.allocator.alloc(need)
        if ids is None:
            raise RuntimeError("admission raced the page allocator")
        row = np.full(self.pages_per_slot, -1, np.int32)
        row[:need] = ids
        self.page_table[slot] = row
        insert_cache_pages(self.cache, one, slot, self._t(row, torch.int32),
                           cache_update=self.cache_update)

    def _retire(self, slot: int):
        self.allocator.free(self.page_table[slot])
        self.page_table[slot] = -1
        super()._retire(slot)

    def _decode_logits(self):
        table = self.table
        logits, self.cache = self.model.paged_decode_step(
            self.params, self.cache, self._t(self.page_table, torch.int32),
            self._t(table.last_tok, torch.int32), self._t(table.pos, torch.int32),
            cache_update=self.cache_update,
            active=self._t(table.active, torch.bool))
        return logits

    def check_invariants(self):
        """Refcount-conservation audit of the page allocator."""
        self.allocator.check(page_tables=list(self.page_table))

    def _extra_stats(self) -> Dict:
        return dict(
            n_pages=self.n_pages,
            page_size=self.page_size,
            kv_rows=self.n_pages * self.page_size,
            peak_pages=self.allocator.peak_in_use,
        )
