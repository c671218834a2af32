"""RoundEngine: the owner of the federated round (port of
``repro/core/engine.py``, single device).

The engine composes:

  * the round step (``core/fedveca.make_round_step``) specialized by a
    per-mode ``Strategy`` with a pluggable server reduce — the vecavg
    kernel, or the tree path when ``aggregator="fallback"`` is named;
  * the device data path (``data/device.DeviceShards``): minibatch
    indices are drawn on the device each round (``key=``), or host-built
    batches are passed in (``batches=``);
  * cohort sub-sampling: ``m <= C`` participating clients a round
    (``cohort=``, drawn by ``sample_cohort``) with their weights
    renormalised to sum to 1; SCAFFOLD's ``c_i`` rows stay keyed by
    client id, and the controller sees the cohort as its members;
  * the fused round + controller step (``run_fused``): the Alg. 1 update
    runs right after the round on the same device, so the next round's
    taus and ||grad F(w_{k-1})||^2 never visit the host;
  * the wire stage (``EngineConfig.wire``, ``core/wire.py``): a lossy
    codec compresses each client's update with error feedback, and the
    per-client residual rows (``[C, ...]``, built at the first round,
    dropped by ``reset_wire``) are engine state, gathered and scattered
    by client id under a cohort exactly like SCAFFOLD's ``c_i``; the
    identity codec bypasses the stage, bit for bit.

The message-passing prototype (``fed/prototype.py``) uses the engine's
half-round entry points: ``client_update`` (one client, ``tau`` trips),
``client_update_many`` (M clients in one batched call, masked taus) and
``server_aggregate`` / ``weighted_average``, which reduce through the
engine's reduce, so on the card they reach the vecavg kernel. The
buffered engine (``core/buffered.py``) uses ``wave_update``: the client
half of the fused round for one cohort against one params version.

The JAX package donates the params (and scaffold) buffers to its jitted
round; here the round is a plain functional update — a new params tree is
returned and the caller's is never modified.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP item: the
client-axis mesh (A18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import strict_fp32
from repro_torch.core.controller import ControllerCore
from repro_torch.core.fedveca import ScaffoldState, make_local_update, make_round_step
from repro_torch.core.strategy import get_strategy, global_sum, make_reduce
from repro_torch.core.tree import tree_axpy
from repro_torch.core.wire import make_codec, wire_fold
from repro_torch.data.device import DeviceShards


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item}); the port "
        "runs the synchronous single-device round")


@dataclasses.dataclass
class EngineConfig:
    mode: str = "fedveca"  # fedveca | fednova | fedavg | fedprox | scaffold
    eta: float = 0.01
    tau_max: int = 2
    mu: float = 0.0  # fedprox proximal coefficient
    batch_size: int = 32  # per-client per-step minibatch (device data path)
    cohort_size: Optional[int] = None  # m <= C participating clients; None = all
    aggregator: str = "auto"  # 'auto' | 'pallas' (vecavg kernel) | 'fallback'
    wire: Any = "none"  # client->server update codec (core/wire.py):
    #   'none'/'identity' | 'int8' | 'topk:K' | a WireCodec. Lossy codecs
    #   keep per-client error-feedback rows ([C, ...]) as engine state.


class RoundEngine:
    """Runs the round for one (loss_fn, config) pair.

    loss_fn(params, batch) -> (scalar, metrics dict).

    ``run_round`` executes one full round; pass ``key=`` to sample from the
    engine's device shards, or ``batches=`` (leaves [C, tau_max, b, ...]) to
    use host-built data. Batches are moved to the params' device.
    ``cohort=`` (host int ids [m]) restricts the round to a cohort.
    """

    def __init__(
        self,
        loss_fn: Callable,
        cfg: EngineConfig,
        *,
        shards: Optional[DeviceShards] = None,
        num_clients: Optional[int] = None,
        controller: Optional[ControllerCore] = None,
        mesh=None,
    ):
        if cfg.cohort_size is not None and cfg.cohort_size < 1:
            raise ValueError(f"cohort_size must be >= 1, got {cfg.cohort_size}")
        if mesh is not None:
            raise not_ported("mesh (client-axis sharding)", "A18")
        self.cfg = cfg
        self.shards = shards
        self.controller = controller
        self.num_clients = num_clients if num_clients is not None else (
            shards.num_clients if shards is not None else None)
        self._strategy = get_strategy(cfg.mode, mu=cfg.mu)
        self._reduce = make_reduce(cfg.aggregator)
        self.wire_codec = make_codec(cfg.wire)
        self._wire_active = not self.wire_codec.is_identity
        if self._wire_active and self._strategy.uses_scaffold:
            raise ValueError(
                f"mode {cfg.mode!r} aggregates parameter deltas, not cum_g; "
                "wire compression is not supported (use wire='none')")
        self._wire_res = None  # [C, ...] error-feedback rows, built lazily
        self._round = make_round_step(
            loss_fn, eta=cfg.eta, mode=cfg.mode, mu=cfg.mu, aggregator=self._reduce,
            wire=self.wire_codec if self._wire_active else None)
        self._local = make_local_update(loss_fn, eta=cfg.eta, strategy=self._strategy)

    # -- full round ---------------------------------------------------------
    def run_round(self, params, tau, p, gprev_sqnorm, *, key=None, batches=None,
                  scaffold: Optional[ScaffoldState] = None, cohort=None):
        """One round: (new_params, RoundStats over the cohort, scaffold)."""
        dev = self._device(params)
        tau = torch.as_tensor(np.asarray(tau), dtype=torch.int32, device=dev)
        C = int(tau.shape[0])
        ids, cohort = self._prep_cohort(cohort, C, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, C)
        residual = self._wire_state(params, C)
        with strict_fp32():
            new_params, stats, new_scaffold, _, self._wire_res = self._round_body(
                params, key, batches, tau, p, gprev_sqnorm, scaffold, ids, cohort, residual)
        return new_params, stats, new_scaffold

    # -- fused round + controller (core/driver.TrainDriver) -----------------
    def init_controller_state(self, params, taus):
        """Device-resident Alg. 1 state for ``run_fused`` (round 0)."""
        if self.controller is None:
            raise ValueError("engine built without controller=ControllerCore")
        return self.controller.init_state(params, taus)

    def run_fused(self, params, cstate, p, *, key=None, batches=None,
                  scaffold: Optional[ScaffoldState] = None, cohort=None):
        """One round + controller update, all on the params' device.

        Returns ``(new_params, new_cstate, new_scaffold, diag)`` where
        ``diag`` holds only small tensors (scalars + [C] vectors), still on
        the device: the caller decides when to read them back.
        """
        if self.controller is None:
            raise ValueError("engine built without controller=ControllerCore")
        dev = self._device(params)
        C = self.controller.C
        ids, cohort = self._prep_cohort(cohort, C, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, C)
        residual = self._wire_state(params, C)
        with strict_fp32():
            taus = torch.clamp(cstate.taus, 1, self.cfg.tau_max)
            new_params, stats, new_scaffold, pw, self._wire_res = self._round_body(
                params, key, batches, taus, p, cstate.prev_grad_sqnorm, scaffold, ids, cohort,
                residual)
            if cohort is None:
                members, tau_round_sum = torch.arange(C, dtype=torch.int32, device=dev), taus.sum()
            else:
                members, tau_round_sum = cohort, taus[cohort].sum()
            new_cstate, diag = self.controller.step(cstate, stats, members, taus)
            diag = dict(diag, train_loss=(pw * stats.loss0).sum(), tau_k=stats.tau_k,
                        tau_round_sum=tau_round_sum, update_sqnorm=stats.update_sqnorm)
        return new_params, new_cstate, new_scaffold, diag

    def _round_body(self, params, key, batches, tau, p, gprev_sqnorm, scaffold, ids, cohort,
                    residual):
        """The cohort's gathers and scatters around the round: full-C taus,
        weights, host batches, SCAFFOLD rows and wire residual rows in, the
        cohort's rows through the round (weights renormalised), ``c_i`` and
        residual rows back by client id. -> (new_params, stats,
        new_scaffold, the weights used, new_residual)."""
        dev = tau.device
        sub_scaffold, pw, res_rows = scaffold, p, residual
        if cohort is not None:
            tau = tau[cohort]
            pw = p[cohort] / global_sum(p[cohort])
            if scaffold is not None:
                sub_scaffold = ScaffoldState(
                    c=scaffold.c, c_i={k: v[cohort] for k, v in scaffold.c_i.items()})
            if residual is not None:
                res_rows = {k: v[cohort] for k, v in residual.items()}
        if batches is not None:
            batches = {k: v.to(dev) for k, v in batches.items()}
            if cohort is not None:
                batches = {k: v[cohort] for k, v in batches.items()}
        else:
            batches = self._sample(key, ids)
        new_residual = residual
        if residual is None:
            new_params, stats, new_scaffold = self._round(
                params, batches, tau, pw, gprev_sqnorm, sub_scaffold)
        else:
            new_params, stats, new_scaffold, new_residual = self._round(
                params, batches, tau, pw, gprev_sqnorm, sub_scaffold, res_rows)
            if cohort is not None:
                new_residual = _scatter_rows(residual, cohort, new_residual)
        if cohort is not None and scaffold is not None and new_scaffold is not None:
            new_scaffold = ScaffoldState(
                c=new_scaffold.c, c_i=_scatter_rows(scaffold.c_i, cohort, new_scaffold.c_i))
        return new_params, stats, new_scaffold, pw, new_residual

    # -- message-passing halves (fed/prototype.py) --------------------------
    def client_update(self, params, batches_c, tau: int, gprev_sqnorm):
        """Alg. 2 for ONE client: batches_c leaves [T, b, ...], T = tau.

        Returns dict(G, g0, beta, delta, loss0): the client's reply message,
        G = cum_g / tau (unstacked leaves, scalar statistics).
        """
        batches = {k: v[None] for k, v in batches_c.items()}
        out = self.client_update_many(params, batches, [int(tau)], gprev_sqnorm)
        return {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict) else v[0])
                for k, v in out.items()}

    def client_update_many(self, params, batches_stacked, taus, gprev_sqnorm):
        """Alg. 2 for M clients in one batched call: leaves
        [M, T, b, ...] (T trips, steps past tau_i are masked no-ops, so a
        stack padded to tau_max changes nothing), ``taus`` [M] int. The
        round's own batched local loop with zero drift variates.
        -> dict(G, g0 [M, ...] trees; beta, delta, loss0 [M])."""
        dev = self._device(params)
        taus = torch.as_tensor(np.asarray(taus, np.int32), device=dev)
        batches = {k: torch.as_tensor(v).to(dev) for k, v in batches_stacked.items()}
        gprev = torch.as_tensor(gprev_sqnorm, dtype=torch.float32, device=dev)
        M = int(taus.shape[0])
        with strict_fp32():
            out = self._local(params, batches, taus, gprev, *self._zero_variates(params, M))
            tau_f = taus.float()
            G = {k: x / tau_f.reshape((M,) + (1,) * (x.dim() - 1))
                 for k, x in out["cum_g"].items()}
        return dict(G=G, g0=out["g0"], beta=out["beta"], delta=out["delta"],
                    loss0=out["loss0"])

    def server_aggregate(self, params, G_stacked, tau, p):
        """Alg. 1 line 7 over stacked normalized vectors (leaves [C, ...])
        through the engine's reduce. -> (new_params, tau_k)."""
        dev = self._device(params)
        tau_f = torch.as_tensor(np.asarray(tau), device=dev).float()
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        with strict_fp32():
            delta_w = self._strategy.delta_from_normalized(
                G_stacked, tau_f, p, self.cfg.eta, self._reduce)
            return tree_axpy(1.0, delta_w, params), (p * tau_f).sum()

    def weighted_average(self, stacked, w):
        """sum_c w_c * stacked_c through the engine's reduce (Eq. 8)."""
        dev = next(iter(stacked.values())).device
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        with strict_fp32():
            return self._reduce(stacked, w, 1.0)[0]

    # -- one wave of the buffered engine (core/buffered.py) ------------------
    def wave_update(self, params, taus, gprev_sqnorm, cohort, *, key):
        """The client half of the fused round for the clients ``cohort``
        (host int ids [m]) against ONE params version, with the server's
        fold and step left to the caller: the same tau clip, the same
        per-client draws from the device shards (``key``, as the driver's
        ``round_key``) and the same masked local loop as ``run_fused``, so
        a wave committed at once reproduces the synchronous round bit for
        bit. ``taus`` [C] are the controller's. Under a lossy codec the
        clients' residual rows advance here, keyed by client id, so an
        arrival folded rounds later still composes with the client's next
        wave. -> dict(cum_g, g0 [m, ...] trees; loss0, beta, delta [m];
        tau [m] int), the raw accumulators (not divided by tau)."""
        dev = self._device(params)
        C = int(taus.shape[0])
        ids, rows = self._prep_cohort(cohort, C, dev)
        residual = self._wire_state(params, C)
        with strict_fp32():
            tau = torch.clamp(taus, 1, self.cfg.tau_max)[rows]
            batches = self._sample(key, ids)
            gprev = torch.as_tensor(gprev_sqnorm, dtype=torch.float32, device=dev)
            outs = self._local(params, batches, tau, gprev,
                               *self._zero_variates(params, len(ids)))
            cum_g = outs["cum_g"]
            if residual is not None:
                cum_g, new_rows = wire_fold(
                    self.wire_codec, cum_g, {k: v[rows] for k, v in residual.items()})
                self._wire_res = _scatter_rows(residual, rows, new_rows)
        return dict(cum_g=cum_g, g0=outs["g0"], loss0=outs["loss0"], beta=outs["beta"],
                    delta=outs["delta"], tau=tau)

    # -- wire stage state (core/wire.py) -------------------------------------
    @property
    def wire_active(self) -> bool:
        """True when a non-identity codec compresses the update wire."""
        return self._wire_active

    def reset_wire(self) -> None:
        """Drop the error-feedback residuals (start of a fresh run)."""
        self._wire_res = None

    def _wire_state(self, params, C: int):
        """The full-C residual rows ([C, ...] float32 zeros at first use),
        or None when the stage is off. Like SCAFFOLD's ``c_i`` they exist
        for every client from round 0, so cohort rows stay keyed by id."""
        if not self._wire_active:
            return None
        if self._wire_res is None:
            self._wire_res = {k: torch.zeros((C,) + v.shape, dtype=torch.float32,
                                             device=v.device) for k, v in params.items()}
        return self._wire_res

    def wire_bytes_per_client(self, params) -> int:
        """Wire bytes of ONE client's update under the codec (float32
        rows; the dense bytes for the identity codec)."""
        like = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
                for k, v in params.items()}
        return self.wire_codec.payload_nbytes(like)

    # -- cohort sub-sampling ------------------------------------------------
    def sample_cohort(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        """This round's participating clients (sorted int32 ids), or None
        for all of them; the JAX package's numpy calls, so one seed draws
        the same ids in both packages."""
        m, C = self.cfg.cohort_size, self.num_clients
        if m is None or C is None or m >= C:
            return None
        return np.sort(rng.choice(C, size=m, replace=False)).astype(np.int32)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _device(params) -> torch.device:
        return next(iter(params.values())).device

    @staticmethod
    def _prep_cohort(cohort, C: int, dev):
        """Host cohort ids -> (numpy int32 [m], int32 [m] tensor on ``dev``),
        or (None, None) for full participation."""
        if cohort is None:
            return None, None
        ids = np.asarray(cohort.cpu() if torch.is_tensor(cohort) else cohort, np.int32)
        ids = ids.reshape(-1)
        if ids.size == 0 or ids.min() < 0 or ids.max() >= C or np.unique(ids).size != ids.size:
            raise ValueError(f"cohort must hold distinct client ids in [0, {C}); got {ids}")
        # a pageable source is staged before the call returns
        return ids, torch.from_numpy(ids).to(dev, non_blocking=True)

    def _sample(self, key, ids):
        """Device shards + round key -> the cohort's (or every client's)
        batches."""
        if self.shards is None:
            raise ValueError("no device shards: pass batches= or build the "
                             "engine with shards=DeviceShards.from_datasets(...)")
        if key is None:
            raise ValueError("device data path needs key=")
        return self.shards.sample(key, self.cfg.tau_max, self.cfg.batch_size, ids)

    def _zero_variates(self, params, M: int):
        """Zero SCAFFOLD variates (a tree and [M, ...] rows) for the local
        loop of the half-round entry points; None for the other modes."""
        if not self._strategy.uses_scaffold:
            return None, None
        return ({k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                 for k, v in params.items()},
                {k: torch.zeros((M,) + v.shape, dtype=v.dtype, device=v.device)
                 for k, v in params.items()})

    def _materialize_scaffold(self, scaffold, params, C: int):
        if not self._strategy.uses_scaffold or scaffold is not None:
            return scaffold
        return ScaffoldState(
            c={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()},
            c_i={k: torch.zeros((C,) + v.shape, dtype=torch.float32, device=v.device)
                 for k, v in params.items()},
        )


def _scatter_rows(full, rows, new):
    """``full`` (leaves [C, ...]) with the rows ``rows`` (int [m]) replaced
    by ``new`` (leaves [m, ...]); a new tree, ``full`` is left as it was."""
    rows = rows.long()
    return {k: v.index_copy(0, rows, new[k].to(v.dtype)) for k, v in full.items()}
