"""AdmissionScheduler: the one admit -> fold -> commit tick (DESIGN.md §13).

A copy of the JAX package's ``core/scheduler.py`` (it imports nothing of
JAX; the port keeps its own copy and imports nothing of ``repro``).

The serving plane (``serve/loop.ServeLoop``) and the buffered training
plane (``core/buffered.BufferedRoundEngine``) are the same machine seen
from two workloads: work arrives continuously, is admitted into a FIXED
set of device slots (so every compiled program keeps one static shape),
folded into device state by masked in-place updates, and committed by a
step whose cadence is the scheduler's only real policy decision. This
module is that machine, stripped of both workloads:

  ============  ==============================  =============================
  hook          serving (ServeLoop)             buffered training
  ============  ==============================  =============================
  _admit        prefill queued requests into    claim streamed client
                free cache slots (masked        arrivals into free buffer
                insert, backpressure when the   slots (per-slot FIFO
                page pool is exhausted)         backpressure while occupied)
  _has_work     any slot holds a live request   every buffer slot is claimed
  _fold         one fixed-shape decode_step     masked elementwise folds of
                over all slots (retired rows    arrival waves into the
                are exact no-ops)               aggregate (age recorded)
  _commit       append sampled tokens, retire   one global model + controller
                finished requests               step over the filled buffer
  ============  ==============================  =============================

Each ``tick`` runs admit -> (fold -> commit) -> admit: the trailing
admission re-fills capacity freed by the commit (a retired request's
slot, a stepped buffer's slots) within the SAME tick, so freed capacity
never idles a full tick — the retire-then-admit property the serve loop
has relied on since PR 4, now shared by training.

The skeleton deliberately owns almost nothing: a tick counter and the
drain loop. Slots, queues, caches, and device buffers belong to the
subclasses — the contract here is the ORDER of the hooks, which is what
keeps both planes' "freed capacity is reused immediately" and "commit
sees a full fold" invariants true.
"""
from __future__ import annotations


class AdmissionScheduler:
    """Template for continuously-admitted fixed-slot execution.

    Subclasses implement the four hooks; ``tick`` fixes their order and
    advances the clock ``t`` (ticks are the scheduler's time unit:
    arrival times, retirement times, and staleness ages are measured in
    committed ticks).
    """

    def __init__(self):
        self.t = 0

    # -- hooks (subclass contract) ------------------------------------------
    def _admit(self) -> None:
        """Move waiting work into free slots; must backpressure (leave work
        queued), never fail, when capacity is short."""
        raise NotImplementedError

    def _has_work(self) -> bool:
        """Whether a fold/commit pair should run this tick."""
        raise NotImplementedError

    def _fold(self):
        """Advance every occupied slot by one fixed-shape device program;
        returns the fold's result for ``_commit`` (tokens, fold handles)."""
        raise NotImplementedError

    def _commit(self, folded) -> None:
        """Consume the fold: retire finished work, free slots, step global
        state. Freed capacity becomes visible to the trailing admit."""
        raise NotImplementedError

    def _pending(self) -> bool:
        """Whether un-admitted work is still waiting (drain condition)."""
        return False

    # -- the tick ------------------------------------------------------------
    def tick(self) -> None:
        """admit -> (fold -> commit) -> admit, then advance the clock."""
        self._admit()
        if self._has_work():
            self._commit(self._fold())
            self._admit()
        self.t += 1

    def drain(self, max_ticks: int | None = None) -> int:
        """Tick until no work is pending or live; returns ticks run."""
        n = 0
        while self._pending() or self._has_work():
            if max_ticks is not None and n >= max_ticks:
                break
            self.tick()
            n += 1
        return n
