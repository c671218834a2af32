"""RoundEngine: the owner of the federated round (port of
``repro/core/engine.py``).

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
    identity codec bypasses the stage, bit for bit;
  * client-axis sharding (``mesh=``, DESIGN.md §11): on each rank of a
    federated mesh the round runs only the rank's C/K clients, against
    only its data rows; the server reduce is the shard-local reduce (the
    vecavg kernel) completed by one all-reduce over the client-axis group,
    so ``new_params`` and the global gradient come back the same on every
    rank, and the per-client stats, SCAFFOLD's ``c_i`` rows and the wire
    residual rows stay with their rank. Cohorts carry GLOBAL ids and are
    drawn stratified, about m/K a rank; an imbalanced draw pads short
    ranks with the sentinel id C (weight 0, its data and state rows
    clamped to the rank's last client, dropped on scatter), and the
    cohort's weight normaliser is completed across the ranks;
  * the model axis (a mesh whose ``model`` extent exceeds 1, with
    ``model_axis=`` from the model built for it, ROADMAP.md A18b): the
    params are the rank's pieces, the round runs under
    ``sharding.api.logical_axis_rules(mesh)`` with its norms completed
    over the model group, and the client axis' collectives run over the
    ranks that share this rank's model coordinate. Client rows come from
    the client coordinates alone, so every model rank of a client slot
    holds the same clients and minibatches. A wire codec decides over each
    whole leaf (``core/wire.wire_fold(model_axis=)``); the error-feedback
    rows hold the rank's pieces (ROADMAP.md A18c).

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
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import strict_fp32
from repro_torch.core.controller import ControllerCore
from repro_torch.core.fedveca import ScaffoldState, make_local_update, make_round_step
from repro_torch.core.strategy import get_strategy, global_sum, make_reduce
from repro_torch.core.tree import tree_axpy
from repro_torch.core.wire import make_codec, wire_fold
from repro_torch.data.device import DeviceShards
from repro_torch.sharding.api import (
    client_group,
    client_rows,
    client_shard_count,
    logical_axis_rules,
    shard_index,
    validate_client_count,
)


class _Rows(NamedTuple):
    """The rows one call of the round runs on this process.

    ``ids`` (host int64 [n]) are the global client ids whose data the rows
    use (None: every held client, in order); ``sel`` indexes full-C arrays
    (taus, weights, host batches) and ``local`` this process's state rows
    (SCAFFOLD's ``c_i``, the wire residual), each None for the identity;
    ``keep`` (positions of the real rows) and ``mask`` (their 0/1 float
    weights) are None without pads; ``members`` are the rows' ids with the
    sentinel C on pads (the controller's view); ``cohort`` is the whole
    cohort's ids (None for full participation)."""

    ids: Optional[np.ndarray]
    sel: Optional[torch.Tensor]
    local: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    members: torch.Tensor
    cohort: Optional[torch.Tensor]


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

    ``mesh=`` (a federated mesh, ``launch/mesh.make_federated_mesh``)
    shards the client axis: C must divide evenly over the client-axis
    shards, and every rank calls the engine with the same arguments (the
    full-C taus, weights and cohort; host batches whole). The rank runs
    its clients; the returned stats' per-client fields are its rows.
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
        model_axis=None,
    ):
        if cfg.cohort_size is not None and cfg.cohort_size < 1:
            raise ValueError(f"cohort_size must be >= 1, got {cfg.cohort_size}")
        self.cfg = cfg
        self.shards = shards
        self.controller = controller
        self.num_clients = num_clients if num_clients is not None else (
            shards.num_clients if shards is not None else None)

        # -- client-axis sharding (DESIGN.md §11) ---------------------------
        self.mesh = mesh
        self._n_shards = 1 if mesh is None else client_shard_count(mesh)
        self.sharded = self._n_shards > 1
        self._group = None
        self._shard = 0 if mesh is None else shard_index(mesh)
        if self.sharded:
            C = self.num_clients
            if C is None:
                raise ValueError("sharded engine needs num_clients or shards=")
            validate_client_count(mesh, C)
            self._local_C = C // self._n_shards
            self._rows = client_rows(mesh, C)
            self._group = client_group(mesh)
            if shards is not None and shards.rows != self._rows:
                raise ValueError(f"shards hold clients {shards.rows}, this rank's are "
                                 f"{self._rows}: DeviceShards.from_datasets(..., mesh=mesh)")
            if controller is not None and controller.mesh is None:
                raise ValueError("a sharded engine's controller needs the same mesh "
                                 "(ControllerCore(..., mesh=mesh))")
        self.model_axis = model_axis
        if mesh is not None and mesh.model_size > 1 and model_axis is None:
            raise ValueError("a mesh with a model axis needs the model built for it: "
                             "RoundEngine(model.loss, ..., model_axis=model.model_axis) with "
                             "model = build_model(cfg, mesh=mesh)")
        if controller is not None and controller.model_axis is not model_axis:
            raise ValueError("the controller's norms need the engine's model axis: "
                             "ControllerCore(..., model_axis=model.model_axis)")
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
            wire=self.wire_codec if self._wire_active else None, axis_name=self._group,
            model_axis=model_axis)
        self._local = make_local_update(loss_fn, eta=cfg.eta, strategy=self._strategy,
                                        model_axis=model_axis)

    # -- full round ---------------------------------------------------------
    def run_round(self, params, tau, p, gprev_sqnorm, *, key=None, batches=None,
                  scaffold: Optional[ScaffoldState] = None, cohort=None):
        """One round: (new_params, RoundStats over the cohort, scaffold)."""
        dev = self._device(params)
        tau = torch.as_tensor(np.asarray(tau), dtype=torch.int32, device=dev)
        C = int(tau.shape[0])
        rows = self._prep_cohort(cohort, C, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, C)
        residual = self._wire_state(params, C)
        with strict_fp32():
            new_params, stats, new_scaffold, _, self._wire_res = self._round_body(
                params, key, batches, tau, p, gprev_sqnorm, scaffold, rows, residual)
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
        rows = self._prep_cohort(cohort, C, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, C)
        residual = self._wire_state(params, C)
        with strict_fp32():
            taus = torch.clamp(cstate.taus, 1, self.cfg.tau_max)
            new_params, stats, new_scaffold, pw, self._wire_res = self._round_body(
                params, key, batches, taus, p, cstate.prev_grad_sqnorm, scaffold, rows, residual)
            tau_round_sum = taus.sum() if rows.cohort is None else taus[rows.cohort].sum()
            new_cstate, diag = self.controller.step(cstate, stats, rows.members, taus)
            diag = dict(diag, train_loss=global_sum(pw * stats.loss0, self._group),
                        tau_k=stats.tau_k, tau_round_sum=tau_round_sum,
                        update_sqnorm=stats.update_sqnorm)
        return new_params, new_cstate, new_scaffold, diag

    def _round_body(self, params, key, batches, tau, p, gprev_sqnorm, scaffold, rows: _Rows,
                    residual):
        """The rows' gathers and scatters around the round: full-C taus,
        weights and host batches, this process's SCAFFOLD and wire residual
        rows in; the rows through the round (a cohort's weights
        renormalised over the whole cohort, pads weighing 0); ``c_i`` and
        residual rows back by client id. -> (new_params, stats,
        new_scaffold, the weights used, new_residual)."""
        dev = tau.device
        sub_scaffold, pw, res_rows = scaffold, p, residual
        if rows.sel is not None:
            tau = tau[rows.sel]
            pw = p[rows.sel]
            if rows.mask is not None:
                pw = pw * rows.mask
            if rows.cohort is not None:
                pw = pw / global_sum(pw, self._group)
        if rows.local is not None:
            if scaffold is not None:
                sub_scaffold = ScaffoldState(
                    c=scaffold.c, c_i={k: v[rows.local] for k, v in scaffold.c_i.items()})
            if residual is not None:
                res_rows = {k: v[rows.local] for k, v in residual.items()}
        if batches is not None:
            batches = {k: v.to(dev) for k, v in batches.items()}
            if rows.sel is not None:
                batches = {k: v[rows.sel] for k, v in batches.items()}
        else:
            batches = self._sample(key, rows.ids)
        new_residual = residual
        with self._context():
            out = self._round(params, batches, tau, pw, gprev_sqnorm, sub_scaffold,
                              *(() if residual is None else (res_rows,)))
        new_params, stats, new_scaffold = out[:3]
        if residual is not None:
            new_residual = out[3]
            if rows.local is not None:
                new_residual = _scatter_kept(residual, rows, new_residual)
        if rows.local is not None and scaffold is not None and new_scaffold is not None:
            new_scaffold = ScaffoldState(
                c=new_scaffold.c, c_i=_scatter_kept(scaffold.c_i, rows, new_scaffold.c_i))
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
        tau [m] int), the raw accumulators (not divided by tau). Sharded:
        this rank's rows of the cohort (the cohort's ids of its clients, in
        order; pads as in the round)."""
        dev = self._device(params)
        C = int(taus.shape[0])
        rows = self._prep_cohort(np.asarray(cohort), C, dev)
        residual = self._wire_state(params, C)
        with strict_fp32():
            tau = torch.clamp(taus, 1, self.cfg.tau_max)[rows.sel]
            batches = self._sample(key, rows.ids)
            gprev = torch.as_tensor(gprev_sqnorm, dtype=torch.float32, device=dev)
            with self._context():
                outs = self._local(params, batches, tau, gprev,
                                   *self._zero_variates(params, len(rows.ids)))
            cum_g = outs["cum_g"]
            if residual is not None:
                cum_g, new_rows = wire_fold(
                    self.wire_codec, cum_g, {k: v[rows.local] for k, v in residual.items()},
                    self.model_axis)
                self._wire_res = _scatter_kept(residual, rows, new_rows)
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
        """The residual rows of every client held here ([C, ...] float32
        zeros at first use; a rank's [C/K, ...] when sharded), or None when
        the stage is off. Like SCAFFOLD's ``c_i`` they exist for every
        client from round 0, so cohort rows stay keyed by id."""
        if not self._wire_active:
            return None
        if self._wire_res is None:
            n = self._state_rows(C)
            self._wire_res = {k: torch.zeros((n,) + v.shape, dtype=torch.float32,
                                             device=v.device) for k, v in params.items()}
        return self._wire_res

    def wire_bytes_per_client(self, params) -> int:
        """Wire bytes of ONE client's update under the codec (float32
        rows; the dense bytes for the identity codec), the whole leaves'
        under a model axis."""
        cuts = {} if self.model_axis is None else self.model_axis.cuts
        like = {k: torch.empty(cuts[k].shape if k in cuts else v.shape, dtype=torch.float32,
                               device="meta") for k, v in params.items()}
        return self.wire_codec.payload_nbytes(like)

    # -- cohort sub-sampling ------------------------------------------------
    def sample_cohort(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        """This round's participating clients (sorted int32 ids), or None
        for all of them; the JAX package's numpy calls, so one seed draws
        the same ids in both packages (and on every rank).

        Sharded engines draw STRATIFIED cohorts: about m/K clients from
        each shard's own id range, so a rank's rows are its own clients.
        When K does not divide m (or m < K) the draw degrades to an
        imbalanced split, ``m % K`` randomly chosen shards drawing one
        more, with a warning; ``_prep_cohort`` pads the short ranks."""
        m, C = self.cfg.cohort_size, self.num_clients
        if m is None or C is None or m >= C:
            return None
        if not self.sharded:
            return np.sort(rng.choice(C, size=m, replace=False)).astype(np.int32)
        K, C_loc = self._n_shards, self._local_C
        base, extra = divmod(m, K)
        counts = np.full(K, base, np.int64)
        if extra:
            warnings.warn(
                f"cohort_size={m} does not divide the {K} client-axis shards: degrading to "
                f"an imbalanced per-shard split ({extra} shards draw {base + 1} clients, the "
                f"rest {base}); pad rows are masked no-ops", RuntimeWarning, stacklevel=2)
            counts[rng.choice(K, size=extra, replace=False)] += 1
        rows = [s * C_loc + np.sort(rng.choice(C_loc, size=int(counts[s]), replace=False))
                for s in range(K)]
        return np.concatenate(rows).astype(np.int32)

    # -- helpers ------------------------------------------------------------
    def _context(self):
        """The model axis' logical-axis context (nothing without one)."""
        if self.model_axis is None:
            return contextlib.nullcontext()
        return logical_axis_rules(self.mesh)

    @staticmethod
    def _device(params) -> torch.device:
        return next(iter(params.values())).device

    def _state_rows(self, C: int) -> int:
        """How many clients' state rows (``c_i``, wire residuals) live here."""
        return self._local_C if self.sharded else C

    def _prep_cohort(self, cohort, C: int, dev) -> _Rows:
        """Host cohort ids (or None) -> the rows this process runs.

        One device: the cohort's rows (or every client). Sharded: this
        rank's clients of the cohort (grouped by owner, so a rank never
        touches another's data), padded with the sentinel id C up to the
        largest rank's count; a pad's data and state rows are the rank's
        last client's, it weighs 0 and its scatter is dropped."""
        if cohort is None and not self.sharded:
            return _Rows(None, None, None, None, None,
                         torch.arange(C, dtype=torch.int32, device=dev), None)
        full = None
        if cohort is not None:
            ids = np.asarray(cohort.cpu() if torch.is_tensor(cohort) else cohort, np.int32)
            ids = ids.reshape(-1)
            if (ids.size == 0 or ids.min() < 0 or ids.max() >= C
                    or np.unique(ids).size != ids.size):
                raise ValueError(f"cohort must hold distinct client ids in [0, {C}); got {ids}")
            # a pageable source is staged before the call returns
            full = torch.from_numpy(ids).to(dev, non_blocking=True)
            if not self.sharded:
                return _Rows(ids, full, full, None, None, full, full)
        K, C_loc, lo = self._n_shards, self._local_C, self._rows.start
        if cohort is None:
            mine = np.arange(lo, lo + C_loc, dtype=np.int32)
            sel = torch.from_numpy(mine).to(dev, non_blocking=True)
            return _Rows(mine, sel, None, None, None, sel, None)
        per = int(np.bincount(ids // C_loc, minlength=K).max())
        mine = np.sort(ids[ids // C_loc == lo // C_loc])
        members = np.full(per, C, np.int32)  # C = masked-pad sentinel
        members[: mine.size] = mine
        gids = np.where(members < C, members, lo + C_loc - 1).astype(np.int32)
        sel = torch.from_numpy(gids).to(dev, non_blocking=True)
        keep = mask = None
        if mine.size < per:
            keep = torch.arange(mine.size, device=dev)
            mask = torch.from_numpy((members < C).astype(np.float32)).to(dev, non_blocking=True)
        return _Rows(gids, sel, sel - lo, keep, mask,
                     torch.from_numpy(members).to(dev, non_blocking=True), full)

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
        C = self._state_rows(C)
        return ScaffoldState(
            c={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()},
            c_i={k: torch.zeros((C,) + v.shape, dtype=torch.float32, device=v.device)
                 for k, v in params.items()},
        )


def _scatter_kept(full, rows: _Rows, new):
    """``full`` (a process's state rows) with the real rows of ``new``
    (leaves [n, ...], one a row of ``rows``) written at their client's
    row; pads are dropped."""
    if rows.keep is None:
        return _scatter_rows(full, rows.local, new)
    return _scatter_rows(full, rows.local[rows.keep], {k: v[rows.keep] for k, v in new.items()})


def _scatter_rows(full, rows, new):
    """``full`` (leaves [C, ...]) with the rows ``rows`` (int [m]) replaced
    by ``new`` (leaves [m, ...]); a new tree, ``full`` is left as it was."""
    rows = rows.long()
    return {k: v.index_copy(0, rows, new[k].to(v.dtype)) for k, v in full.items()}
