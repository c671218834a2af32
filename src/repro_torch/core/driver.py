"""TrainDriver: the overlapped federated training loop (port of
``repro/core/driver.py``).

With the controller fused into the round (``RoundEngine.run_fused``), a
round's dispatch needs nothing from the previous round on the host: taus
and ||grad F(w_{k-1})||^2 live in the device-resident ``CoreState``.
CUDA runs the queued work asynchronously, so the driver overlaps:

  * round k+1's data draw and kernel launches (host) run while round k is
    still executing on the device;
  * the only device-to-host traffic per round is the small ``diag`` bundle
    (scalars + [C] vectors), fetched ``overlap`` rounds late, so the host
    usually blocks on a result the device has already finished;
  * eval is queued on the fresh params and its scalars are fetched at the
    same deferred point.

``overlap=0`` is the sync debugging mode. Any ``overlap`` gives
bit-identical results: the host RNG is consumed in dispatch order, and the
device's work does not depend on when results are read back.

``host_blocked_s`` accumulates the time the loop spends blocked on
device-to-host reads; ``dispatch_s`` the time inside the round calls
(on the CPU those run the round's compute).

On a client-sharded engine every rank runs this loop and dispatches every
round; the rows are built from the replicated scalars and the gathered
``[C]`` arrays, so they are the same on every rank, and rank 0 alone logs
them and calls ``on_row``. ``host_blocked_s`` is the rank's own.

``sanitize=`` (True or an ``analysis.sanitize.Sanitizer``) runs the loop
inside the sanitizer: NaN trapped at the op that makes it, round 0 the
warm-up, and after it no kernel library built or loaded and no new
allocator segment (``assert_steady_state`` after the last round).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import strict_fp32
from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.engine import RoundEngine
from repro_torch.data.device import format_batch, round_key
from repro_torch.data.synthetic import Dataset
from repro_torch.metrics.logger import RunLogger


def make_dataset_evaluator(loss_fn, data: Dataset, max_batch: int = 2048,
                           device=None) -> Callable:
    """Whole-dataset eval that only queues device work: params -> dict of
    device scalars (``test_loss``, and ``test_acc`` where the loss reports
    an accuracy; an LM's does not).

    The set is cut into equal [k, b, ...] chunks (plus one remainder
    batch) once and uploaded; each call evaluates the chunks and weights
    them by sample count exactly like the JAX package's evaluator (sum of
    per-chunk loss * chunk size / n). Integer ``data.x`` is an LM token
    set: its chunks are (tokens, targets) batches and ``data.y`` is unused.
    """
    n = len(data)
    b = min(n, max_batch)
    k, rem = divmod(n, b)
    lm = np.issubdtype(data.x.dtype, np.integer)

    def fmt(sl, shape):
        x = data.x[sl].reshape(shape + data.x.shape[1:])
        return format_batch(x, None if lm else data.y[sl].reshape(shape), device=device)

    main = fmt(slice(0, k * b), (k, b))
    tail = fmt(slice(k * b, n), (rem,)) if rem else None

    @torch.no_grad()
    def evaluate(params):
        with strict_fp32():
            losses, accs = [], []
            for i in range(k):
                loss, mets = loss_fn(params, {name: v[i] for name, v in main.items()})
                losses.append(loss)
                accs.append(mets.get("acc"))
            tot = torch.stack(losses).sum() * b
            acc_tot = None if accs[0] is None else torch.stack(accs).sum() * b
            if tail is not None:
                loss_r, mets_r = loss_fn(params, tail)
                tot = tot + loss_r * rem
                if acc_tot is not None:
                    acc_tot = acc_tot + mets_r["acc"] * rem
        out = {"test_loss": tot / n}
        if acc_tot is not None:
            out["test_acc"] = acc_tot / n
        return out

    return evaluate


def _sync(params) -> None:
    dev = next(iter(params.values())).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrainDriver:
    """K rounds of the fused round+controller step, pipelined against host.

    The engine must be built with ``controller=ControllerCore``. ``p`` is
    the full-C client weight vector; each round's cohort comes from
    ``engine.sample_cohort`` (all clients without ``cohort_size``) and is
    logged in its row; ``batches_fn(rng)`` (optional) supplies
    host-built batches per round; ``eval_fn(params)`` (optional, see
    ``make_dataset_evaluator``) must not block; ``on_row`` is called with
    each finalized row (printing, early stop).
    """

    def __init__(
        self,
        engine: RoundEngine,
        p: np.ndarray,
        *,
        overlap: int = 1,
        seed: int = 0,
        mode: str = "fedveca",
        eval_fn: Optional[Callable] = None,
        eval_every: int = 1,
        batches_fn: Optional[Callable] = None,
        on_row: Optional[Callable[[Dict[str, Any]], None]] = None,
        sanitize=None,
    ):
        if engine.controller is None:
            raise ValueError("TrainDriver needs an engine built with "
                             "controller=ControllerCore")
        if overlap < 0:
            raise ValueError(f"overlap must be >= 0, got {overlap}")
        self.sanitizer = _sanitize.coerce(sanitize, label="train-driver")
        self.engine = engine
        self.p = np.asarray(p, np.float32)
        self.overlap = overlap
        self.seed = seed
        self.mode = mode
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.batches_fn = batches_fn
        self.on_row = on_row
        self.lead = engine.mesh is None or engine.mesh.rank == 0  # logs the rows
        self.host_blocked_s = 0.0  # device-to-host readback waits
        self.dispatch_s = 0.0  # time inside the round calls themselves
        self.tau_all = 0

    # -- main loop ----------------------------------------------------------
    def run(self, params, rounds: int, taus: np.ndarray,
            logger: Optional[RunLogger] = None) -> RunLogger:
        """Run ``rounds`` fused rounds from ``params``/``taus``; returns the
        logger with ``.params`` (final), ``.tau_all`` and
        ``.controller_state`` (the final ``CoreState``)."""
        engine = self.engine
        log = logger or RunLogger(None, name=self.mode)
        engine.reset_wire()  # fresh error-feedback residuals a run
        # what one client's update costs on the wire under the engine's
        # codec (the dense float32 bytes for the identity codec)
        self._wire_bpc = engine.wire_bytes_per_client(params)
        dev = next(iter(params.values())).device
        p = torch.as_tensor(self.p, device=dev)  # device-resident once
        rng = np.random.default_rng(self.seed)
        cstate = engine.init_controller_state(params, taus)
        scaffold = None
        pending: deque = deque()
        self.host_blocked_s = 0.0
        self.dispatch_s = 0.0
        self.tau_all = 0

        # under sanitize= round 0 is the warm-up, inside the context (the
        # JAX package's order): it builds the kernels and fills the
        # allocator's pool; every later round must do neither
        with _sanitize.maybe(self.sanitizer):
            for k in range(rounds):
                # the cohort is drawn before the batches from the one RNG, as
                # the JAX package's driver draws them, so host batches stay in step
                cohort = engine.sample_cohort(rng)
                batches = self.batches_fn(rng) if self.batches_fn else None
                key = None if batches is not None else round_key(self.seed, k)
                t0 = time.perf_counter()
                params, cstate, scaffold, diag = engine.run_fused(
                    params, cstate, p, key=key, batches=batches, scaffold=scaffold,
                    cohort=cohort)
                self.dispatch_s += time.perf_counter() - t0
                ev = None
                if self.eval_fn and ((k % self.eval_every) == 0 or k == rounds - 1):
                    ev = self.eval_fn(params)
                pending.append((k, cohort, diag, ev))
                while len(pending) > self.overlap:
                    self._finalize(pending.popleft(), log)
                if self.sanitizer is not None and k == 0:
                    _sync(params)
                    self.sanitizer.mark_steady()
            while pending:
                self._finalize(pending.popleft(), log)

            t0 = time.perf_counter()
            _sync(params)
            self.host_blocked_s += time.perf_counter() - t0
            if self.sanitizer is not None and rounds > 1:
                self.sanitizer.assert_steady_state()
        log.params = params  # type: ignore[attr-defined]
        log.tau_all = self.tau_all  # type: ignore[attr-defined]
        log.controller_state = cstate  # type: ignore[attr-defined]
        log.close()
        return log

    # -- deferred device-to-host read + logging -----------------------------
    def _finalize(self, entry, log: RunLogger) -> None:
        k, cohort, diag, ev = entry
        t0 = time.perf_counter()
        host = {name: v.cpu().numpy() for name, v in diag.items()}  # blocks
        ev_host = None if ev is None else {name: float(v) for name, v in ev.items()}
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
            cohort=None if cohort is None else cohort.copy(),
            A=host["A"],
            L=float(host["L"]),
            premise=float(host["premise"]),
            alpha_k=float(host["alpha_k"]),
            wire=self.engine.wire_codec.name,
            wire_bytes=self._wire_bpc * (
                len(cohort) if cohort is not None else self.engine.controller.C),
        )
        if ev_host:
            row.update(ev_host)
        if self.lead:
            log.log(**row)
            if self.on_row:
                self.on_row(row)
