"""Continuous-batching decode (port of ``repro/serve/loop.py``): the
contiguous ``ServeLoop``, ``PagedServeLoop`` over a shared KV page pool with
its front-end scheduler, and ``SerialLoop``, the request-at-a-time parity
oracle.

Each tick runs admit -> one decode step over every slot -> retire -> admit
again (``AdmissionScheduler.tick``). Admission prefills one request (batch
1; full-attention KV-only prompts padded to a length bucket; SWA and
recurrent prompts at their exact length; VLM prompts with their patches)
and writes its cache into the slot's row (``ServeLoop``) or onto freshly
allocated pool pages (``PagedServeLoop``); retired and never-filled slots
ride along inactive and leave every cache leaf as it was. With
``cache_update="kernel"`` every paged decode tick launches the paged-decode
kernel once per layer, and every whole-prompt admission and every restore
of a preempted request launches the paged-insert kernel once (CUDA
tensors), or runs their plain versions (CPU tensors). No TPU kernel
touches the contiguous cache: ``ServeLoop`` writes it with "mask" or an
indexed write, as the JAX package does. The scheduler options (prefix
caching, chunked prefill, preemption) and sampled decode are the JAX
package's, with its gates and its integer behaviour.

Differences from the JAX loops: caches are updated in place (no donation);
chunk writes under ``"kernel"`` take the plain ``"scatter"`` write where
the JAX package takes ``"mask"`` (same bits; ``stats["extend_write"]``);
sampled streams are the port's own (``serve/sampling.py``). Under
``sanitize=`` (``analysis/sanitize.py``) ``run()`` drains cloned requests
first (the warm-up), marks the steady state, replays the trace and asserts
it; the paged loop audits its page refcounts every tick meanwhile.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.scheduler import AdmissionScheduler
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model, decode_capability
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import (DecodeCache, extend_write,
                                            insert_cache_pages, insert_cache_slot,
                                            warn_kernel_extend_fallback)
from repro_torch.serve.sampling import GREEDY, SamplerConfig, make_sample_fn
from repro_torch.serve.slots import (PageAllocator, PrefixCache, Request,
                                     RequestQueue, SlotTable)

CACHE_UPDATES = ("kernel", "scatter", "mask")


class ServeUnsupportedError(RuntimeError):
    """Model has no decode path the port serves — carries the reason."""


def _check_servable(model: Model):
    ok, why = decode_capability(model)
    if not ok:
        raise ServeUnsupportedError(why)


def _request_batch(cfg, req: Request, tokens, device) -> dict:
    """Prefill inputs of one request; VLM prompts must carry their patches
    (serving them text-only would silently ignore the vision input), which
    ride in as float32 ``[1, num_patches, vision_dim]``."""
    if cfg.vision_dim:
        if req.patches is None:
            raise ServeUnsupportedError(
                f"{cfg.name}: request {req.rid} has no `patches`; vlm "
                "prompts need the vision input alongside tokens "
                "(Request.patches)")
        if req.plen < cfg.num_patches:
            # embed_tokens splices patches in only when they fit inside the
            # prompt; bucket padding would make the batched and serial loops
            # disagree about whether they did
            raise ServeUnsupportedError(
                f"{cfg.name}: request {req.rid} prompt ({req.plen} tokens) "
                f"is shorter than num_patches={cfg.num_patches}; the image "
                "would be silently dropped")
    batch = {"tokens": tokens}
    if req.patches is not None:
        batch["patches"] = torch.as_tensor(np.asarray(req.patches, np.float32),
                                           device=device)[None]
    return batch


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


class ServeLoop(AdmissionScheduler):
    """Continuous-batching loop over one contiguous ``DecodeCache`` of
    ``n_slots`` rows: admission + one ``decode_step`` per tick.

    Admission writes the request's prefill cache into its slot's row in
    place (``insert_cache_slot``); inactive rows leave every leaf (KV, SSM
    state, xLSTM state) as it was. Greedy streams equal ``SerialLoop``'s
    for the dense, SWA, recurrent and VLM families. MoE capacity depends
    on which rows share a step (a static cap over the live batch), so a
    live MoE request's stream can part from its single-request run where
    experts overflow; retired and empty slots never influence one.

    Args:
      model, params: a ``Model`` and its params, on ``device``.
      device: where the loop runs; ``None`` means ``cuda`` (raises when no
        GPU is present).
      n_slots: decode batch rows.
      capacity: KV rows per slot for full attention (SWA models use their
        window). A request that can never fit is rejected, not fatal.
      bucket: prompt-length rounding for full-attention KV-only prefill.
      cache_update: "kernel", "scatter" or "mask". The paged loop's decode
        and insert run their CUDA kernels under "kernel" (CUDA tensors) and
        plain versions otherwise; the contiguous cache has no kernel, and
        writes with "mask" or, for any other value, an indexed write. All
        leave the same bits.
      sampler: ``SamplerConfig``: greedy (default) or temperature / top-k
        sampling with per-request streams of ``(seed, rid, n)``.
      unroll: the JAX package's scan-unrolling compile knob; ignored.
      sanitize: True or an ``analysis.sanitize.Sanitizer``: ``run()`` drains
        the trace twice inside it (cloned requests first, the warm-up; then
        the requests, which must build no library and take no new
        allocator segment), NaN trapped at the op that makes it.
    """

    def __init__(self, model: Model, params, *, device=None, n_slots: int = 8,
                 capacity: int = 256, bucket: int = 16,
                 cache_update: str = "kernel", unroll: int = 1,
                 sampler: Optional[SamplerConfig] = None, sanitize=None):
        del unroll
        super().__init__()
        self.sanitizer = _sanitize.coerce(sanitize, label="serve-loop")
        _check_servable(model)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, loop on {self.device}")
        if cache_update not in CACHE_UPDATES:
            raise ValueError(f"cache_update={cache_update!r}; expected one of {CACHE_UPDATES}")
        cfg = model.config
        self.model, self.params, self.cfg = model, params, cfg
        self.n_slots, self.capacity, self.bucket = n_slots, capacity, bucket
        self.cache_update = cache_update
        self.sampler = sampler or GREEDY
        self._sample = make_sample_fn(self.sampler)
        # exact-length prefill: recurrent state absorbs padded tokens, and
        # the SWA ring keeps the last W slots of the PADDED prompt
        self.exact_prefill = bool(cfg.sliding_window) or cfg.family == "ssm" \
            or cfg.hybrid_parallel_ssm
        self.reset()

    # -- the cache (PagedServeLoop overrides) ----------------------------------
    def _init_cache(self):
        return self.model.init_cache(self.n_slots, self.capacity)

    def _insert_request(self, slot: int, req: Request, one):
        insert_cache_slot(self.cache, one, slot)

    def _decode_logits(self):
        table = self.table
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._t(table.last_tok, torch.int32),
            self._t(table.pos, torch.int32), cache_update=self.cache_update,
            active=self._t(table.active, torch.bool))
        return logits

    def reset(self):
        """Fresh slot table and cache."""
        self.cache = self._init_cache()
        self.table = SlotTable(self.n_slots)
        self.t = 0
        self._queue: Optional[RequestQueue] = None
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.prefilled_tokens = 0  # real prompt rows sent through prefill
        self.decode_s = 0.0  # host clock, each tick ends in a token readback
        self.prefill_s = 0.0  # prefill + first-token readback + insert enqueue
        self.tick_walls: List[float] = []  # wall clock at each tick start
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
        kw = {} if self.cfg.family == "ssm" else {"pad_to": self.capacity}
        if not self.exact_prefill:
            kw["length"] = self._t([plen], torch.int32)
        batch = _request_batch(self.cfg, req, self._t(toks, torch.int32), self.device)
        logits, one = self.model.prefill(self.params, batch, **kw)
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
            if self._reject_if_oversized(req):
                continue
            if not self._can_admit(req):
                return
            queue.pop_arrived(self.t)
            self._begin_request(free[0], req)

    def _reject_if_oversized(self, req: Request) -> bool:
        """Pop and record ``req`` as failed if it can never be served."""
        err = self._admission_error(req)
        if err is None:
            return False
        self._queue.pop_arrived(self.t)
        req.failed = f"request {req.rid}: {err}"
        req.done_tick = self.t
        self.rejected.append(req)
        return True

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
        # tick_walls[t] = wall clock when tick t began: a request's time to
        # first token is req.tok_walls[0] - tick_walls[req.arrival]
        self.tick_walls.append(time.time())
        super().tick()

    def _extra_stats(self) -> Dict:
        return {}

    def run(self, requests: Sequence[Request]) -> Dict:
        """Drive every request to completion from a fresh slot table;
        returns per-run stats.

        Under ``sanitize=`` the trace runs twice: once on cloned requests
        (the warm-up: every kernel built, the allocator's pool filled),
        then on the requests with the steady state asserted. Stats and
        outputs come from the second pass."""
        if self.sanitizer is not None and not self.sanitizer.active:
            with self.sanitizer:
                self._drain_trace([r.clone() for r in requests])
                self.sanitizer.mark_steady()
                stats = self._drain_trace(requests)
                self.sanitizer.assert_steady_state()
            return stats
        return self._drain_trace(requests)

    def _drain_trace(self, requests: Sequence[Request]) -> Dict:
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


@dataclasses.dataclass
class _PrefillJob:
    """An admitted request whose prompt is still being chunk-prefilled: its
    slot holds pool pages and a page-table row but is not yet live in the
    SlotTable (decode skips it) until the last chunk lands."""
    req: Request
    done: int  # prompt rows already in the pool (prefix hits + chunks)


@dataclasses.dataclass
class _Preempted:
    """An evicted mid-decode request staged on the host: its pool pages were
    copied off the card and freed; restore allocates fresh pages, writes
    the staged rows back and rebinds the slot. Decode resumes with the same
    bits: content is addressed by position through the page table, and
    physical page ids never enter the arithmetic."""
    req: Request
    k: torch.Tensor  # [L, pages, page_size, Hkv, hd] on the host
    v: torch.Tensor
    ssm: Optional[SSMState]  # the hybrid family's SSM row [L, ...] on the host
    pages: int  # allocated pages to re-acquire on restore


class PagedServeLoop(ServeLoop):
    """Continuous batching over a shared KV page pool, with the JAX
    package's front-end scheduler.

    The host ``PageAllocator`` hands each admitted request
    ``ceil(min(plen + max_new - 1, window or inf) / page_size)`` pages,
    recorded in its slot's page-table row, which rides into every decode
    step. When the pool cannot cover the head request it waits in the queue
    (FIFO backpressure); a request larger than the whole pool is rejected.
    Retirement returns the pages; a reused page is overwritten in full at
    the next admission and masked arithmetically until then.

    Scheduler options (all off by default; none changes a greedy stream,
    and sampled streams depend only on ``(seed, rid, n)``):

      prefix_cache: admission looks up the prompt's page-aligned prefixes
        in a host ``PrefixCache``; hit pages are aliased read-only into the
        new slot's page table (refcounted) and only the suffix is prefilled
        straight into the pool (``Model.paged_prefill_chunk``).
      prefill_chunk: admission prefills at most ``prefill_chunk`` prompt
        tokens a tick, interleaved with decode.
      preempt: when the pool is exhausted and the queue's head has been
        blocked for ``preempt_after`` ticks, the youngest live request
        (most pages breaks ties) is evicted, its pages staged to the host,
        and restored with priority once pages free up.

    prefix_cache / prefill_chunk need full attention (the SWA ring wraps
    decode writes into early, possibly shared, pages), KV-only models
    (recurrent carries do not live in pool pages) and text-only prompts;
    preemption works for every paged family (the hybrid family's SSM row is
    staged beside its pages). The xLSTM family has no KV to page: it is
    served by ``ServeLoop``. ``unroll`` is the JAX package's
    scan-unrolling compile knob and is ignored. Under ``sanitize`` the
    loop also runs ``check_invariants()`` after every tick.
    """

    def __init__(self, model: Model, params, *, device=None, n_slots: int = 8,
                 capacity: int = 256, page_size: int = 16,
                 n_pages: Optional[int] = None, bucket: int = 16,
                 cache_update: str = "kernel", unroll: int = 1,
                 sampler: Optional[SamplerConfig] = None,
                 prefix_cache: bool = False, prefill_chunk: Optional[int] = None,
                 preempt: bool = False, preempt_after: int = 2, sanitize=None):
        _check_servable(model)
        cfg = model.config
        if cfg.family == "ssm" or model.init_paged_cache is None:
            raise ServeUnsupportedError(
                f"{cfg.name}: family={cfg.family!r} keeps O(1) recurrent "
                "state per slot — there is no KV cache to page; use the "
                "contiguous ServeLoop")
        self.page_size = page_size
        W = cfg.sliding_window
        self.pages_per_slot = -(-(W if W else capacity) // page_size)
        if not W:  # prefill pad_to must equal the paged logical capacity
            capacity = self.pages_per_slot * page_size
        self.n_pages = n_slots * self.pages_per_slot if n_pages is None else n_pages
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefix_cache_on = bool(prefix_cache)
        self.prefill_chunk = prefill_chunk
        self.preempt, self.preempt_after = bool(preempt), preempt_after
        # pool-direct suffix/chunk prefill (vs whole-prompt prefill, then
        # insert); preemption alone keeps the whole-prompt prefill
        self._use_extend = self.prefix_cache_on or prefill_chunk is not None
        self._sched_on = self._use_extend or self.preempt
        if self._use_extend:
            why = None
            if W:
                why = ("the SWA ring wraps KV writes into early (possibly "
                       "shared) pages")
            elif cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
                why = "recurrent carries do not live in pool pages"
            elif cfg.vision_dim:
                why = ("vlm patch splicing needs the whole prompt in one "
                       "prefill dispatch")
            if why is not None:
                raise ServeUnsupportedError(
                    f"{cfg.name}: prefix caching / chunked prefill is "
                    f"full-attention text-only — {why}")
            if cache_update == "kernel":
                warn_kernel_extend_fallback("serve.PagedServeLoop")
        self.extend_write = extend_write(cache_update) if self._use_extend else None
        super().__init__(model, params, device=device, n_slots=n_slots,
                         capacity=capacity, bucket=bucket, cache_update=cache_update,
                         unroll=unroll, sampler=sampler, sanitize=sanitize)

    def _init_cache(self):
        self.allocator = PageAllocator(self.n_pages, self.page_size)
        self.page_table = np.full((self.n_slots, self.pages_per_slot), -1, np.int32)
        return self.model.init_paged_cache(self.n_slots, self.n_pages, self.page_size)

    def reset(self):
        super().reset()
        self._prefilling: Dict[int, _PrefillJob] = {}
        self._preempted: deque = deque()
        self._blocked_since: Optional[int] = None
        self._chunk_left: Optional[int] = None
        self._admit_plan = None
        self._short_pages = 0
        self.prefix = PrefixCache(self.allocator) if self.prefix_cache_on else None
        self.prefix_hit_tokens = 0
        self.preemptions = 0
        self.extend_dispatches = 0
        self.restore_dispatches = 0
        self.extend_s = 0.0  # chunk prefill + first-token readback

    def tick(self, queue: Optional[RequestQueue] = None):
        self._chunk_left = self.prefill_chunk  # this tick's chunk token budget
        super().tick(queue)
        if self.sanitizer is not None and self.sanitizer.active:
            # the sanitize lane audits page refcounts every tick: a leaked
            # or doubly freed page fails at the tick that broke it
            self.check_invariants()

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

    def _bind_pages(self, slot: int, ids) -> np.ndarray:
        """Record ``ids`` as the first pages of ``slot``'s page-table row."""
        row = np.full(self.pages_per_slot, -1, np.int32)
        row[:len(ids)] = ids
        self.page_table[slot] = row
        return row

    def _insert_request(self, slot: int, req: Request, one):
        ids = self.allocator.alloc(self.allocator.pages_for(self._rows_needed(req)))
        if ids is None:
            raise RuntimeError("admission raced the page allocator")
        row = self._bind_pages(slot, ids)
        insert_cache_pages(self.cache, one, slot, self._t(row, torch.int32),
                           cache_update=self.cache_update)

    def _retire(self, slot: int):
        self.allocator.free(self.page_table[slot])
        self.page_table[slot] = -1
        super()._retire(slot)

    # -- front-end scheduler ---------------------------------------------------
    def _admit(self):
        """Scheduler admission order: (1) advance in-flight chunk-prefill
        jobs (they hold pages), (2) restore preempted requests FIFO (they
        already spent prefill work), (3) admit new requests FIFO. A blocked
        head first evicts cache-only prefix pages, then, after
        ``preempt_after`` stalled ticks, preempts a live slot."""
        if not self._sched_on:
            super()._admit()
            return
        self._advance_prefills()
        queue = self._queue
        while True:
            free = [s for s in self.table.free_slots() if s not in self._prefilling]
            if not free:
                return
            if self._preempted:
                ent = self._preempted[0]
                if not self._ensure_pages(ent.pages):
                    if not self._try_preempt(ent.pages):
                        return
                    continue
                self._preempted.popleft()
                self._blocked_since = None
                self._restore(free[0], ent)
                continue
            if queue is None:
                return
            req = queue.peek_arrived(self.t)
            if req is None:
                return
            if self._reject_if_oversized(req):
                continue
            if not self._plan_admission(req):
                if not self._try_preempt(self._short_pages):
                    return
                continue
            queue.pop_arrived(self.t)
            self._blocked_since = None
            if self._use_extend:
                self._start_job(free[0], req)
            else:
                self._admit_plan = None
                self._begin_request(free[0], req)

    def _plan_admission(self, req: Request) -> bool:
        """Can the head request start now? Pins its prefix-cache hits
        (``share`` before any eviction can free them), then checks that the
        pool covers the private remainder, evicting cache-only pages if
        short. On success the plan (shared pages, total need) is kept for
        ``_start_job``; on failure the pins are released."""
        need = self.allocator.pages_for(self._rows_needed(req))
        shared: List[int] = []
        if self.prefix is not None:
            shared = self.prefix.lookup(req.tokens)
            self.allocator.share(shared)
        if self._ensure_pages(need - len(shared)):
            self._admit_plan = (req.rid, shared, need)
            return True
        if shared:
            self.allocator.free(shared)
        self._short_pages = need - len(shared)
        return False

    def _ensure_pages(self, n: int) -> bool:
        """Free pool pages >= n, evicting LRU cache-only prefix pages
        (refcount 1) to close a shortfall."""
        short = n - self.allocator.free_pages
        if short > 0 and self.prefix is not None:
            self.prefix.evict_for(short)
        return self.allocator.free_pages >= n

    def _try_preempt(self, need_pages: int) -> bool:
        """The head has been refused pages: start (or continue) the blocked
        clock, and once it has stalled ``preempt_after`` ticks evict the
        youngest live request (most pages breaks ties: the youngest loses
        the least progress, the largest frees the most) until the head
        fits. True when pages were freed and the head now fits."""
        if self._blocked_since is None:
            self._blocked_since = self.t
        if not self.preempt or self.t - self._blocked_since < self.preempt_after:
            return False
        evicted = False
        while not self._ensure_pages(need_pages):
            victims = [s for s in self.table.live_slots() if s not in self._prefilling]
            if not victims:
                return False
            victim = max(victims, key=lambda s: (
                self.table.req[s].admit_tick, int((self.page_table[s] >= 0).sum()), s))
            self._evict(victim)
            evicted = True
        return evicted

    def _evict(self, slot: int):
        """Preempt a live slot: copy its allocated pool pages (and the hybrid
        family's SSM row) to the host before they are freed (the pool is
        updated in place, and a later admission may overwrite them), unbind
        the slot, free the pages. (The JAX loop stages the whole row, -1
        entries included, for a static shape; the rows it restores are
        these.)"""
        row = self.page_table[slot].copy()
        ids = self._t(row[row >= 0], torch.int64)  # a slot's pages lead its row
        ssm = self.cache.ssm
        self._preempted.append(_Preempted(
            req=self.table.evict(slot),
            k=self.cache.kv.k.index_select(1, ids).cpu(),
            v=self.cache.kv.v.index_select(1, ids).cpu(),
            ssm=None if ssm is None else SSMState(*(x[:, slot].cpu() for x in ssm)),
            pages=int(ids.numel())))
        self.allocator.free(row)
        self.page_table[slot] = -1
        self.preemptions += 1

    def _restore(self, slot: int, ent: _Preempted):
        """Re-admit a preempted request: fresh pages, the staged rows (and SSM
        row) written back verbatim through ``insert_cache_pages`` (the
        paged-insert kernel under ``"kernel"``), the slot rebound."""
        ids = self.allocator.alloc(ent.pages)
        if ids is None:
            raise RuntimeError("restore raced the page allocator")
        self._bind_pages(slot, ids)
        L, P, ps, Hkv, hd = ent.k.shape
        one = DecodeCache(
            kv=KVCache(k=ent.k.to(self.device).reshape(L, 1, P * ps, Hkv, hd),
                       v=ent.v.to(self.device).reshape(L, 1, P * ps, Hkv, hd),
                       pos=torch.zeros((L, 1, P * ps), dtype=torch.int32, device=self.device)),
            ssm=None if ent.ssm is None else SSMState(
                *(x.to(self.device)[:, None] for x in ent.ssm)))
        insert_cache_pages(self.cache, one, slot, self._t(ids, torch.int32),
                           cache_update=self.cache_update)
        self.table.rebind(slot, ent.req)
        self.restore_dispatches += 1

    def _start_job(self, slot: int, req: Request):
        """Begin pool-direct admission: bind the shared prefix pages and
        freshly allocated private pages into the slot's page-table row, then
        run the suffix through the chunk-prefill budget."""
        rid, shared, need = self._admit_plan
        if rid != req.rid:
            raise RuntimeError("admission plan raced the queue")
        self._admit_plan = None
        priv = self.allocator.alloc(need - len(shared))
        if priv is None:
            raise RuntimeError("admission raced the page allocator")
        self._bind_pages(slot, np.concatenate([np.asarray(shared, np.int32),
                                               np.asarray(priv, np.int32)]))
        hit = len(shared) * self.page_size
        self.prefix_hit_tokens += hit
        self._prefilling[slot] = _PrefillJob(req=req, done=hit)
        self._advance_job(slot)

    def _advance_prefills(self):
        for slot in list(self._prefilling):
            self._advance_job(slot)

    def _advance_job(self, slot: int):
        """Push one prefill job forward within this tick's chunk budget; on
        the last chunk (the one holding prompt row plen-1) its sampled
        logits seed the output stream and the slot goes live."""
        job = self._prefilling[slot]
        req, row = job.req, self.page_table[slot]
        first = None
        while job.done < req.plen:
            remaining = req.plen - job.done
            if self.prefill_chunk is None:  # the suffix in one bucketed shot
                step = remaining
                width = min(_round_up(remaining, self.bucket), self.capacity)
            else:
                if self._chunk_left is not None and self._chunk_left <= 0:
                    return  # budget spent; the job resumes next tick
                step = min(self.prefill_chunk, remaining)
                width = self.prefill_chunk  # fixed width, as the JAX loop compiles once
            toks = np.zeros((1, width), np.int32)
            toks[0, :step] = req.tokens[job.done:job.done + step]
            first = self._dispatch_extend(row, toks, job.done, step, req.rid)
            job.done += step
            self.prefilled_tokens += step
            if self._chunk_left is not None:
                self._chunk_left -= step
        del self._prefilling[slot]
        self.table.admit(slot, req, first, self.t)
        if self.prefix is not None:
            self.prefix.register(req.tokens, row, req.plen)
        if req.finished():  # max_new == 1 or an instant EOS
            self._retire(slot)

    def _dispatch_extend(self, row, toks, start: int, length: int, rid: int) -> int:
        t0 = time.perf_counter()
        logits, self.cache = self.model.paged_prefill_chunk(
            self.params, self.cache, self._t(row, torch.int32),
            self._t(toks, torch.int32), start, length, cache_update=self.extend_write)
        # the completion chunk holds row plen-1: its logits seed the stream at
        # sample index 0 (intermediate chunks' samples are discarded)
        r = self._t([rid], torch.int32)
        first = int(self._sample(logits, r, torch.zeros_like(r))[0])
        self.extend_s += time.perf_counter() - t0
        self.extend_dispatches += 1
        return first

    def _pending(self) -> bool:
        return super()._pending() or bool(self._prefilling) or bool(self._preempted)

    def _decode_logits(self):
        table = self.table
        logits, self.cache = self.model.paged_decode_step(
            self.params, self.cache, self._t(self.page_table, torch.int32),
            self._t(table.last_tok, torch.int32), self._t(table.pos, torch.int32),
            cache_update=self.cache_update,
            active=self._t(table.active, torch.bool))
        return logits

    def check_invariants(self):
        """Refcount-conservation audit: every in-use page's refcount equals
        its page-table references plus its prefix-cache pin."""
        self.allocator.check(page_tables=list(self.page_table),
                             cached_pages=self.prefix.pages if self.prefix else None)

    def _extra_stats(self) -> Dict:
        return dict(
            n_pages=self.n_pages,
            page_size=self.page_size,
            kv_rows=self.n_pages * self.page_size,
            peak_pages=self.allocator.peak_in_use,
            prefix_hit_tokens=self.prefix_hit_tokens,
            preemptions=self.preemptions,
            extend_dispatches=self.extend_dispatches,
            restore_dispatches=self.restore_dispatches,
            prefix_pages=len(self.prefix) if self.prefix else 0,
            extend_s=self.extend_s,
            extend_write=self.extend_write,
        )


# ---------------------------------------------------------------------------
# request-at-a-time baseline
# ---------------------------------------------------------------------------


class SerialLoop:
    """One request at a time: prefill [1, plen], then ``decode_step`` with
    batch 1 until EOS or ``max_new``. The parity oracle of the batched
    loops: their greedy streams must equal its streams token for token (and
    sampled ones too: the streams depend only on ``(seed, rid, n)``).

    ``capacity``: one KV capacity for every request; None sizes each
    request's cache exactly (``plen + max_new - 1``). A request that does
    not fit raises here (the oracle's semantics; the batched loops reject
    it and keep serving).
    """

    def __init__(self, model: Model, params, *, device=None, capacity: Optional[int] = None,
                 cache_update: str = "kernel", unroll: int = 1,
                 sampler: Optional[SamplerConfig] = None):
        del unroll
        _check_servable(model)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, loop on {self.device}")
        self.model, self.params, self.cfg = model, params, model.config
        self.capacity, self.cache_update = capacity, cache_update
        self.sampler = sampler or GREEDY
        self._sample = make_sample_fn(self.sampler)

    def _t(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def run(self, requests: Sequence[Request]) -> Dict:
        t0 = time.perf_counter()
        steps = 0
        for req in requests:
            cap = self.capacity or (req.plen + req.max_new - 1)
            if req.plen + req.max_new - 1 > cap and not self.cfg.sliding_window:
                # pos % W would wrap the full-attention cache and overwrite
                # live prompt KV
                raise ValueError(
                    f"request {req.rid}: plen {req.plen} + max_new "
                    f"{req.max_new} exceeds cache capacity {cap}")
            batch = _request_batch(self.cfg, req, self._t(req.tokens[None, :]), self.device)
            kw = {} if self.cfg.family == "ssm" else {"pad_to": cap}
            logits, cache = self.model.prefill(self.params, batch, **kw)
            rid = self._t([req.rid])
            req.out.append(int(self._sample(logits, rid, torch.zeros_like(rid))[0]))
            pos = req.plen
            while not req.finished():
                logits, cache = self.model.decode_step(
                    self.params, cache, self._t(req.out[-1:]), self._t([pos]),
                    cache_update=self.cache_update)
                req.out.append(int(self._sample(logits, rid, self._t([len(req.out)]))[0]))
                pos += 1
                steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        toks = sum(len(r.out) for r in requests)
        return dict(wall_s=wall, ticks=steps, tokens=toks, tok_s=toks / max(wall, 1e-9),
                    decode_dispatches=steps, prefill_dispatches=len(requests))


def serial_generate(model: Model, params, requests: Sequence[Request], *, device=None,
                    capacity: Optional[int] = None, cache_update: str = "kernel",
                    unroll: int = 1, sampler: Optional[SamplerConfig] = None) -> Dict:
    """Build a ``SerialLoop`` and drive ``requests`` through it."""
    return SerialLoop(model, params, device=device, capacity=capacity,
                      cache_update=cache_update, unroll=unroll, sampler=sampler).run(requests)
