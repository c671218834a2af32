"""BufferedRoundEngine: FedBuff-style asynchronous federated rounds (port
of ``repro/core/buffered.py``).

The synchronous round is a barrier: sample a cohort, wait for all m
clients, step. Here client updates stream in instead, on the serving
plane's own machine (``core/scheduler.AdmissionScheduler``): each arrival
is ADMITTED into one of m fixed buffer slots, FOLDED into a
device-resident aggregate by a masked elementwise select, and every m
arrivals the server COMMITS one global model + controller step over the
buffer, weighting each contribution by ``grad_decay ** age`` (age = the
global steps elapsed since its wave was dispatched).

**Waves.** Clients dispatched between two commits all see one params and
taus version, so each cohort runs as ONE batched call
(``RoundEngine.wave_update``: the client half of the fused round, with the
same tau clip, per-client draws and masked local loop). ``waves`` cohorts
are kept in flight; a simulated per-client latency (``LatencyModel``)
spreads each wave's m arrivals over time, so a commit generally mixes rows
of several params versions.

**Slot alignment.** Buffer slot j only ever takes wave row j, so the fold
is a per-leaf ``where(mask, wave, buf)``: no gather, no scatter. An
arrival whose slot is occupied waits in that slot's FIFO (admission
backpressure); each wave gives exactly one candidate a slot, so the
buffer always fills.

**The commit** is ``strategy.server_delta`` and the Eq. 8 reduce through
the engine's reduce (the vecavg kernel on the card: two launches a
commit), then the controller's step with the buffer's client ids as its
members.

**Sharded commits.** On a client-sharded engine (``RoundEngine(mesh=)``)
slot j is owned by the rank that owns wave row j, so the buffer size m
must divide over the K ranks (an indivisible buffer raises, as in the JAX
package) and each rank holds m/K slots. A commit is a shard-local vecavg
plus one all-reduce for each of the two reduces; the controller gathers
the buffer's statistics and steps on every rank. The JAX package reduces
sharded commits through its fallback tensordot under GSPMD: the same
partial-sum-then-all-reduce structure (ROADMAP.md P11).

**Under a model axis** (an engine with ``model_axis``) the buffer holds the
rank's pieces, the commit reduces through ``strategy.model_reduce`` (four
vecavg launches a commit where some leaves are sharded and some
replicated) and its norms complete over the model group. Waves, cohorts
and latency draws are host state, the same on every rank of a model group
by construction (one seed, one call order); each dispatch checks it with
one all-gather over the group.

**Parity.** With instant arrivals, ``waves=1`` and ``grad_decay=1.0`` the
buffered engine IS the synchronous engine: wave k fills the whole buffer
in cohort order, and the commit reproduces ``RoundEngine.run_fused``
bit for bit, because the waves take the port's ``TrainDriver``
discipline: one ``np.random.default_rng(seed)`` draws the cohorts and wave
w samples with ``round_key(seed, w)``.

**Latency draws** (ROADMAP.md P9) are the port's own counter-based stream:
an integer hash of (seed, stream tag, client id, dispatch count), as the
sampler's (``serve/sampling.py``, P7), since ``jax.random.fold_in`` cannot
be reproduced. A client's draw depends only on those four, never on the
cohort it shares.

``sanitize=`` runs the commits inside ``analysis.sanitize.Sanitizer``:
everything up to commit 0 is the warm-up, then no library build and no
new allocator segment (asserted after the last commit), NaN trapped at
the op that makes it.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import strict_fp32
from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.engine import RoundEngine
from repro_torch.core.fedveca import RoundStats
from repro_torch.core.scheduler import AdmissionScheduler
from repro_torch.core.strategy import global_sum, model_reduce, psum_reduce
from repro_torch.core.tree import tree_axpy, tree_sqnorm
from repro_torch.data.device import round_key
from repro_torch.metrics.logger import RunLogger
from repro_torch.serve.sampling import _hash32
from repro_torch.sharding.api import all_gather, all_reduce

LATENCY_KINDS = ("instant", "uniform", "exp", "hetero")


@dataclasses.dataclass
class LatencyModel:
    """Simulated client round-trip times (in scheduler ticks, float64).

    Each draw is a function of (seed, client id, how many times THAT client
    was dispatched) alone, so a client's latency trace does not depend on
    which other clients share its cohort. The uniforms are
    ``(m + 0.5) / 2^32`` of a 32-bit hash of (seed, tag, id, count), exact
    in float64 on any device; tag 0 is the per-dispatch jitter, tags 1 and
    2 the two uniforms of a client's persistent Box-Muller normal.

    kinds:
      * ``instant``: always 0 (the sync-parity mode);
      * ``uniform``: scale * U[0, 2) (mean ``scale``);
      * ``exp``: scale * Exp(1), by the inverse CDF;
      * ``hetero``: f_i * scale * Exp(1) with a persistent per-client speed
        factor f_i = exp(spread * N_i(0, 1)): lognormal heterogeneity on
        top of the per-dispatch jitter (f_i is keyed by client id only, so
        a slow client is slow every round).
    """

    kind: str = "instant"
    scale: float = 1.0
    spread: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in LATENCY_KINDS:
            raise ValueError(f"unknown latency kind {self.kind!r}; valid: {LATENCY_KINDS}")

    def _uniforms(self, tag: int, ids, counts) -> np.ndarray:
        key = _hash32(torch.tensor(self.seed & 0xFFFFFFFF, dtype=torch.int64))
        key = _hash32(key ^ tag)
        key = _hash32(key ^ (torch.as_tensor(ids, dtype=torch.int64) & 0xFFFFFFFF))
        bits = _hash32(key ^ (torch.as_tensor(counts, dtype=torch.int64) & 0xFFFFFFFF))
        return (bits.numpy().astype(np.float64) + 0.5) * 2.0 ** -32

    def draw(self, ids: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Latency of each of ``ids`` on its ``counts[i]``-th dispatch."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        counts = np.asarray(counts, np.int64).reshape(-1)
        if self.kind == "instant":
            return np.zeros(len(ids), np.float64)
        u = self._uniforms(0, ids, counts)
        if self.kind == "uniform":
            return self.scale * 2.0 * u
        e = self.scale * -np.log1p(-u)
        if self.kind == "exp":
            return e
        zero = np.zeros_like(ids)
        u1, u2 = self._uniforms(1, ids, zero), self._uniforms(2, ids, zero)
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return np.exp(self.spread * z) * e


@dataclasses.dataclass
class BufferedConfig:
    """Knobs of the buffered scheduler (the engine's ``EngineConfig`` still
    owns the round's math: mode, eta, tau_max, cohort_size = buffer size)."""

    waves: int = 1  # cohorts in flight; 1 + instant arrivals = sync parity
    grad_decay: float = 1.0  # staleness weight decay ** age on arrivals
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    seed: int = 0
    overlap: int = 1  # deferred diag readback depth (TrainDriver's discipline)


class BufferedRoundEngine(AdmissionScheduler):
    """Buffered asynchronous training over a ``RoundEngine``'s round math.

    The engine must be built with ``controller=ControllerCore`` and the
    device data path (``shards=``); SCAFFOLD keeps per-client server state
    the buffered fold does not model and is refused. ``p`` is the full-C
    client weight vector. One scheduler tick is one global step.
    """

    def __init__(
        self,
        engine: RoundEngine,
        p: np.ndarray,
        bcfg: Optional[BufferedConfig] = None,
        *,
        mode: Optional[str] = None,
        eval_fn: Optional[Callable] = None,
        eval_every: int = 1,
        on_row: Optional[Callable[[Dict[str, Any]], None]] = None,
        sanitize=None,
    ):
        super().__init__()
        if engine.controller is None:
            raise ValueError("BufferedRoundEngine needs an engine built "
                             "with controller=ControllerCore")
        if engine.shards is None:
            raise ValueError("BufferedRoundEngine needs the device data "
                             "path (build the engine with shards=)")
        if engine._strategy.uses_scaffold:
            raise ValueError(f"mode {engine.cfg.mode!r} keeps per-client "
                             "server state; buffered rounds don't support it")
        self.sanitizer = _sanitize.coerce(sanitize, label="buffered-rounds")
        self.engine = engine
        self.bcfg = bcfg or BufferedConfig()
        if self.bcfg.waves < 1:
            raise ValueError(f"waves must be >= 1, got {self.bcfg.waves}")
        if not 0.0 < self.bcfg.grad_decay <= 1.0:
            raise ValueError(f"grad_decay must be in (0, 1], got {self.bcfg.grad_decay}")
        C = engine.num_clients
        m = engine.cfg.cohort_size
        self.m = C if (m is None or m >= C) else int(m)
        self.full = self.m >= C  # full participation: p already sums to 1
        K = engine._n_shards
        if engine.sharded and self.m % K:
            raise ValueError(
                f"buffered buffer size m={self.m} must divide the {K} client-axis "
                "shards (slot j is owned by the shard that owns wave row j)")
        self._group = engine._group
        self._model_axis = engine.model_axis
        self._reduce = engine._reduce
        if self._model_axis is not None:
            self._reduce = model_reduce(self._reduce, self._model_axis)
        if engine.sharded:
            self._reduce = psum_reduce(self._reduce, self._group)
        self.m_local = self.m // K  # this rank's slots
        self._slots = slice(engine._shard * self.m_local, (engine._shard + 1) * self.m_local)
        self.p = np.asarray(p, np.float32)
        self.mode = mode or engine.cfg.mode
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.on_row = on_row
        self.lead = engine.mesh is None or engine.mesh.rank == 0  # logs the rows
        self.host_blocked_s = 0.0
        self.dispatch_s = 0.0
        self.tau_all = 0

    # -- the two device steps ------------------------------------------------
    def _fold_wave(self, wave, mask, age: float) -> None:
        """Masked elementwise select of one wave's rows into the buffer:
        slot j takes wave row j wherever ``mask`` [m] is set (this rank's
        slots of both, when sharded)."""
        buf, dev, n = self._buf, self._dev, self.m_local
        mask = torch.from_numpy(mask[self._slots]).to(dev, non_blocking=True)

        def sel(b, w):
            return torch.where(mask.reshape((n,) + (1,) * (b.dim() - 1)), w.to(b.dtype), b)

        ids = torch.from_numpy(wave["cohort"][self._slots]).to(dev, non_blocking=True)
        outs = wave["outs"]
        self._buf = dict(
            cum_g={k: sel(v, outs["cum_g"][k]) for k, v in buf["cum_g"].items()},
            g0={k: sel(v, outs["g0"][k]) for k, v in buf["g0"].items()},
            loss0=sel(buf["loss0"], outs["loss0"]),
            beta=sel(buf["beta"], outs["beta"]),
            delta=sel(buf["delta"], outs["delta"]),
            tau=sel(buf["tau"], outs["tau"]),
            ids=sel(buf["ids"], ids),
            age=sel(buf["age"], torch.full((n,), age, dtype=torch.float32, device=dev)),
        )

    def _step(self, params, cstate, buf):
        """One global model + controller step over the full buffer (this
        rank's slots, completed across the ranks, when sharded)."""
        eng = self.engine
        cfg = eng.cfg
        group = self._group
        decay = float(self.bcfg.grad_decay)
        with strict_fp32():
            taus_used = torch.clamp(cstate.taus, 1, cfg.tau_max)
            w = self._p[buf["ids"].long()]
            if decay != 1.0:
                w = w * torch.pow(torch.tensor(decay, dtype=torch.float32, device=w.device),
                                  buf["age"])
            pw = w / global_sum(w, group) if (decay != 1.0 or not self.full) else w
            tau_f = buf["tau"].float()
            delta_w = eng._strategy.server_delta(
                dict(cum_g=buf["cum_g"]), params, tau_f, pw, cfg.eta, self._reduce, group)
            new_params = tree_axpy(1.0, delta_w, params)
            global_grad, g0_sqn = self._reduce(buf["g0"], pw, 1.0)
            stats = RoundStats(
                loss0=buf["loss0"],
                beta=buf["beta"],
                delta=buf["delta"],
                g0_sqnorm=g0_sqn,
                tau=buf["tau"],
                tau_k=global_sum(pw * tau_f, group),
                global_grad=global_grad,
                update_sqnorm=tree_sqnorm(delta_w, self._model_axis),
                params_sqnorm=tree_sqnorm(params, self._model_axis),
                global_grad_sqnorm=tree_sqnorm(global_grad, self._model_axis),
            )
            # Theorem-2 clamp and Eq. 15 on the buffered statistics, the
            # buffer's client ids as the members, as the sync step does
            new_cstate, diag = eng.controller.step(cstate, stats, buf["ids"], taus_used)
            max_age = buf["age"].max()
            diag = dict(diag, train_loss=global_sum(pw * stats.loss0, group),
                        tau_k=stats.tau_k, tau_round_sum=global_sum(buf["tau"], group),
                        update_sqnorm=stats.update_sqnorm,
                        mean_age=global_sum(buf["age"], group) / self.m,
                        max_age=max_age if group is None else all_reduce(
                            [max_age], group, op="max")[0])
        return new_params, new_cstate, diag

    def _init_buffer(self, params):
        m, dev = self.m_local, self._dev

        def rows(v):
            return torch.zeros((m,) + v.shape, dtype=torch.float32, device=dev)

        zf = torch.zeros(m, dtype=torch.float32, device=dev)
        return dict(
            cum_g={k: rows(v) for k, v in params.items()},
            g0={k: rows(v) for k, v in params.items()},
            loss0=zf, beta=zf, delta=zf,
            tau=torch.ones(m, dtype=torch.int32, device=dev),
            ids=torch.zeros(m, dtype=torch.int32, device=dev),
            age=zf,
        )

    # -- wave dispatch and arrival simulation --------------------------------
    def _dispatch_wave(self) -> None:
        """Sample a cohort against the CURRENT (params, taus) version and
        run its batched local updates; schedule each row's arrival at now +
        latency(client, dispatch count)."""
        eng = self.engine
        cohort = eng.sample_cohort(self._rng)
        ids = (np.arange(self.m, dtype=np.int32) if cohort is None
               else np.asarray(cohort, np.int32))
        w = self._next_wave
        self._next_wave += 1
        t0 = time.perf_counter()
        outs = eng.wave_update(self._params, self._cstate.taus,
                               self._cstate.prev_grad_sqnorm, ids,
                               key=round_key(self.bcfg.seed, w))
        self.dispatch_s += time.perf_counter() - t0
        self.wave_dispatches += 1
        self._waves[w] = dict(version=self._version, cohort=ids, outs=outs, remaining=self.m)
        lat = self.bcfg.latency.draw(ids, self._counts[ids])
        if self._model_axis is not None:
            self._check_model_group_agrees(w, ids, lat)
        self._counts[ids] += 1
        for i in range(self.m):
            heapq.heappush(self._events, (self._now + float(lat[i]), next(self._seq), w, i))

    def _check_model_group_agrees(self, w: int, ids, lat) -> None:
        """The host state a wave is scheduled from (its number, cohort and
        latency draws) must be the same on every rank of a model group,
        whose ranks hold pieces of one model: checked with one all-gather,
        never assumed."""
        mine = torch.as_tensor(np.concatenate([[float(w)], ids, lat]), dtype=torch.float64,
                               device=self._dev)
        every = all_gather(mine[None], self._model_axis.group)
        if not bool((every == mine).all()):
            raise RuntimeError(f"wave {w}: the ranks of a model group drew different cohorts "
                               "or latencies (their seeds or call orders differ)")

    # -- AdmissionScheduler hooks --------------------------------------------
    def _admit(self) -> None:
        """Claim arrivals into free buffer slots: slots freed by the commit
        first re-admit from their FIFO (the oldest waiting arrival), then
        the event heap advances simulated time until the buffer is full or
        arrivals run out."""
        for i in range(self.m):
            if self._slot_from[i] is None and self._fifo[i]:
                self._slot_from[i] = self._fifo[i].popleft()
                self._filled += 1
        while self._filled < self.m and self._events:
            t, _, w, i = heapq.heappop(self._events)
            self._now = max(self._now, t)
            if self._slot_from[i] is None:
                self._slot_from[i] = w
                self._filled += 1
            else:
                self._fifo[i].append(w)

    def _has_work(self) -> bool:
        return self._filled == self.m

    def _pending(self) -> bool:
        return bool(self._events)

    def _fold(self):
        """Fold every claimed arrival, one masked select a contributing wave
        (a wave's claimed rows share one age)."""
        by_wave: Dict[int, list] = {}
        for i, w in enumerate(self._slot_from):
            by_wave.setdefault(w, []).append(i)
        t0 = time.perf_counter()
        for w in sorted(by_wave):
            slots = by_wave[w]
            wave = self._waves[w]
            mask = np.zeros(self.m, bool)
            mask[slots] = True
            self._buf_ids[slots] = wave["cohort"][slots]
            self._fold_wave(wave, mask, float(self._version - wave["version"]))
            self.fold_dispatches += 1
            wave["remaining"] -= len(slots)
            if wave["remaining"] == 0:  # retire: free the wave's outputs
                del self._waves[w]
        self.dispatch_s += time.perf_counter() - t0
        return None

    def _commit(self, _folded) -> None:
        """One global step over the full buffer; free every slot (the
        trailing admit re-fills them from the FIFOs) and dispatch a new
        wave against the FRESH params and taus."""
        t0 = time.perf_counter()
        self._params, self._cstate, diag = self._step(self._params, self._cstate, self._buf)
        self.dispatch_s += time.perf_counter() - t0
        k = self._version
        self._version += 1
        self._slot_from = [None] * self.m
        self._filled = 0
        ev = None
        if self.eval_fn and ((k % self.eval_every) == 0 or k == self._total_steps - 1):
            ev = self.eval_fn(self._params)
        self._pend.append((k, np.sort(self._buf_ids.copy()), diag, ev))
        while len(self._pend) > self.bcfg.overlap:
            self._finalize(self._pend.popleft())
        if self.wave_dispatches < self._total_steps:
            self._dispatch_wave()

    # -- driver loop ----------------------------------------------------------
    def run(self, params, steps: int, taus: np.ndarray,
            logger: Optional[RunLogger] = None) -> RunLogger:
        """Run ``steps`` buffered commits from ``params``/``taus``; returns
        the logger with ``.params``, ``.tau_all`` and ``.controller_state``
        (``TrainDriver``'s contract: one row a commit)."""
        eng = self.engine
        log = logger or RunLogger(None, name=self.mode)
        eng.reset_wire()  # fresh error-feedback residuals a run
        self._wire_bpc = eng.wire_bytes_per_client(params)
        self._dev = next(iter(params.values())).device
        self._p = torch.as_tensor(self.p, device=self._dev)
        self._rng = np.random.default_rng(self.bcfg.seed)
        self._cstate = eng.init_controller_state(params, taus)
        self._params = params
        self._buf = self._init_buffer(params)
        self._buf_ids = np.zeros(self.m, np.int32)
        self._counts = np.zeros(eng.num_clients, np.int64)
        self._waves: Dict[int, dict] = {}
        self._events: list = []
        self._seq = itertools.count()
        self._fifo = [deque() for _ in range(self.m)]
        self._slot_from = [None] * self.m
        self._filled = 0
        self._now = 0.0
        self._version = 0
        self._next_wave = 0
        self._total_steps = steps
        self._pend: deque = deque()
        self._log = log
        self.t = 0
        self.wave_dispatches = 0
        self.fold_dispatches = 0
        self.host_blocked_s = 0.0
        self.dispatch_s = 0.0
        self.tau_all = 0

        # under sanitize= everything up to commit 0 is the warm-up, inside
        # the context (the JAX package's order)
        with _sanitize.maybe(self.sanitizer):
            for _ in range(min(self.bcfg.waves, steps)):
                self._dispatch_wave()
            while self._version < steps:
                before = self._version
                self.tick()
                if self._version == before:
                    raise RuntimeError("buffered scheduler made no progress: buffer "
                                       "cannot fill (no arrivals left?)")
                if self.sanitizer is not None and before == 0:
                    # commit 0 ran every piece once: waves, folds, the commit step
                    self._sync()
                    self.sanitizer.mark_steady()
            while self._pend:
                self._finalize(self._pend.popleft())

            t0 = time.perf_counter()
            self._sync()
            self.host_blocked_s += time.perf_counter() - t0
            if self.sanitizer is not None and steps > 1:
                self.sanitizer.assert_steady_state()
        log.params = self._params  # type: ignore[attr-defined]
        log.tau_all = self.tau_all  # type: ignore[attr-defined]
        log.controller_state = self._cstate  # type: ignore[attr-defined]
        log.close()
        return log

    def _sync(self) -> None:
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    @property
    def sim_time(self) -> float:
        """Simulated time (ticks) consumed so far: the buffered analogue of
        the sum of round latencies behind the sync barrier."""
        return self._now

    # -- deferred device-to-host read and logging ----------------------------
    def _finalize(self, entry) -> None:
        k, cohort, diag, ev = entry
        t0 = time.perf_counter()
        host = {name: v.cpu().numpy() for name, v in diag.items()}  # blocks
        ev_host = None if ev is None else {n: float(v) for n, v in ev.items()}
        self.host_blocked_s += time.perf_counter() - t0

        self.tau_all += int(host["tau_round_sum"])
        row: Dict[str, Any] = dict(
            round=k,
            mode=self.mode,
            train_loss=float(host["train_loss"]),
            tau=host["tau_next"].copy(),
            tau_k=float(host["tau_k"]),
            tau_all=self.tau_all,
            beta=host["beta"],
            delta=host["delta"],
            cohort=cohort,
            A=host["A"],
            L=float(host["L"]),
            premise=float(host["premise"]),
            alpha_k=float(host["alpha_k"]),
            mean_age=float(host["mean_age"]),
            max_age=float(host["max_age"]),
            sim_time=self._now,
            wire=self.engine.wire_codec.name,
            wire_bytes=self._wire_bpc * self.m,
        )
        if ev_host:
            row.update(ev_host)
        if self.lead:
            self._log.log(**row)
            if self.on_row:
                self.on_row(row)
