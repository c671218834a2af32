"""Federated simulator (port of ``repro/fed/simulator.py``): K rounds of
the fused round+controller step via ``core/driver.TrainDriver``.

Implements the paper's experimental protocol (§IV-A):
  * FedVeca: adaptive tau via the controller (Alg. 1);
  * FedAvg / FedNova baselines with fixed tau_i = floor(E_avg * D_i / B)
    derived from a recorded FedVeca run for a fair comparison (§IV-A1);
  * centralized SGD trained for the same total iteration count tau_all;
  * per-round test loss/accuracy, premise value eta*tau_k*L, and the
    (tau_i, beta_i, delta_i, A_i, L_k) traces of Fig. 6.

The round and the controller run on the model's device (``build_model``
defaults to the card). The server reduce is the vecavg kernel unless
``aggregator="fallback"`` is named. Float32 work runs in full float32
(``repro_torch.strict_fp32``: no TF32 convolutions). Partial participation
is a config knob (``cohort_size``): each round's cohort is drawn by the
engine, and the controller sees staleness-weighted statistics, where
non-participants decay from their last observed beta/delta toward the
observed mean (``stats_decay``; ``core/controller.CohortStats``).

Client and test sets are vision datasets (float ``x``, labels ``y``) or LM
token sets (integer ``x`` of ``[n, L+1]`` sequences, from
``data.synthetic.make_lm_tokens``); rows carry ``train_loss`` and
``test_loss`` either way, and ``test_acc`` for the vision models.

``run(params=...)`` and ``centralized_sgd(..., params=...)`` take a params
tree (e.g. carried over from the JAX package with ``repro_torch.bridge``,
whose ``jax.random`` init cannot be reproduced here); without one they
init from a ``torch.Generator`` seeded with ``cfg.seed``.

``wire`` compresses each client's update with error feedback
(``core/wire.py``; the residual rows are engine state) and the rows carry
``wire`` and ``wire_bytes``. ``buffered=True`` hands the run to
``core/buffered.BufferedRoundEngine`` (FedBuff-style continuous admission
instead of the synchronous barrier; ``buffer_waves=1``, ``instant``
latency and ``grad_decay=1.0`` reproduce the synchronous driver bit for
bit); it needs the device data path.

``mesh`` (a federated mesh, ``launch/mesh.make_federated_mesh``) shards
the client axis, SPMD style: each rank builds the simulator with the same
arguments and its mesh, holds only its clients' data, and runs the
sharded round (``core/engine.RoundEngine(mesh=)``); evaluation runs on
rank 0's params (the same on every rank), and rank 0 alone logs the rows.
``run_on_ranks`` starts K ranks and runs one such simulation on each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch import strict_fp32
from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel
from repro_torch.core.controller import ControllerConfig, ControllerCore, FedVecaController
from repro_torch.core.driver import TrainDriver, make_dataset_evaluator
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data.device import DeviceShards, format_batch, host_stacked_batches
from repro_torch.data.synthetic import Dataset
from repro_torch.metrics.logger import RunLogger


@dataclasses.dataclass
class FedSimConfig:
    mode: str = "fedveca"  # fedveca | fednova | fedavg | fedprox | scaffold
    eta: float = 0.01  # paper §IV-A4
    alpha: float = 0.95
    tau_max: int = 50
    tau_init: int = 2
    batch_size: int = 32
    rounds: int = 100
    seed: int = 0
    mu: float = 0.01  # fedprox
    fixed_tau: Optional[np.ndarray] = None  # fedavg/fednova per-client tau
    eval_every: int = 1
    log_dir: Optional[str] = None
    aggregator: str = "auto"  # 'auto' | 'pallas' (vecavg kernel) | 'fallback'
    data_path: str = "device"  # 'device' (resident shards) | 'host' (numpy batches)
    overlap: int = 1  # in-flight rounds before host sync; 0 = sync mode
    cohort_size: Optional[int] = None  # m <= C participating clients a round
    stats_decay: float = 0.9  # staleness retention for unobserved clients
    wire: str = "none"  # client->server codec: none | int8 | topk:K
    # -- buffered asynchronous rounds (core/buffered.py) ----------------------
    buffered: bool = False  # continuous admission instead of the barrier
    buffer_waves: int = 1  # cohorts in flight
    grad_decay: float = 1.0  # staleness weight decay ** age on arrivals
    latency_kind: str = "instant"  # instant | uniform | exp | hetero
    latency_scale: float = 1.0
    latency_spread: float = 1.0  # hetero: per-client lognormal spread
    # -- client-axis sharding (DESIGN.md §11) ---------------------------------
    mesh: Optional[object] = None  # federated mesh: shard the clients over
    #   ('pod','data'); None = the single-device round


class FederatedSimulator:
    def __init__(self, model, client_data: List[Dataset], cfg: FedSimConfig,
                 test_data: Optional[Dataset] = None):
        if cfg.buffered and cfg.data_path != "device":
            raise ValueError("buffered rounds need data_path='device' "
                             "(arrival waves sample from the device shards)")
        self.model = model
        self.device = model.device
        self.client_data = client_data
        self.cfg = cfg
        self.test_data = test_data
        self.C = len(client_data)
        sizes = np.array([len(d) for d in client_data], np.float64)
        self.p = (sizes / sizes.sum()).astype(np.float32)

        if cfg.mesh is not None and cfg.mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {cfg.mesh.device}, the model on "
                             f"{self.device}")
        shards = (DeviceShards.from_datasets(client_data, device=self.device, mesh=cfg.mesh)
                  if cfg.data_path == "device" else None)
        ctrl_cfg = ControllerConfig(eta=cfg.eta, alpha=cfg.alpha, tau_max=cfg.tau_max,
                                    tau_init=cfg.tau_init, decay=cfg.stats_decay)
        self.engine = RoundEngine(
            model.loss,
            EngineConfig(mode=cfg.mode, eta=cfg.eta, tau_max=cfg.tau_max, mu=cfg.mu,
                         batch_size=cfg.batch_size, cohort_size=cfg.cohort_size,
                         aggregator=cfg.aggregator, wire=cfg.wire),
            shards=shards,
            num_clients=self.C,
            controller=ControllerCore(ctrl_cfg, self.C, adapt=(cfg.mode == "fedveca"),
                                      mesh=cfg.mesh, model_axis=model.model_axis),
            mesh=cfg.mesh,
            model_axis=model.model_axis,
        )
        # the numpy twin stays constructible, as in the JAX package
        self.controller = FedVecaController(ctrl_cfg, self.C)
        # evaluates and logs; under a model axis every rank evaluates (the
        # forward's collectives span the model group)
        lead = cfg.mesh is None or cfg.mesh.rank == 0 or cfg.mesh.model_size > 1
        eval_fn = (make_dataset_evaluator(model.loss, test_data, device=self.device)
                   if test_data is not None and lead else None)
        self.driver = TrainDriver(
            self.engine, self.p,
            overlap=cfg.overlap, seed=cfg.seed, mode=cfg.mode,
            eval_fn=eval_fn, eval_every=cfg.eval_every,
            batches_fn=self._host_batches if cfg.data_path == "host" else None,
        )
        self.buffered_engine = None
        if cfg.buffered:
            self.buffered_engine = BufferedRoundEngine(
                self.engine, self.p,
                BufferedConfig(
                    waves=cfg.buffer_waves, grad_decay=cfg.grad_decay,
                    latency=LatencyModel(cfg.latency_kind, scale=cfg.latency_scale,
                                         spread=cfg.latency_spread, seed=cfg.seed),
                    seed=cfg.seed, overlap=max(cfg.overlap, 1)),
                mode=cfg.mode, eval_fn=eval_fn, eval_every=cfg.eval_every)

    # -- data ---------------------------------------------------------------
    def _host_batches(self, rng: np.random.Generator):
        """Host path: leaves [C, tau_max, b, ...] drawn with numpy."""
        return host_stacked_batches(self.client_data, rng, self.cfg.tau_max,
                                    self.cfg.batch_size, device=self.device)

    def evaluate(self, params, max_batch: int = 2048) -> Dict[str, float]:
        """Blocking whole-test-set evaluation -> host floats (``test_loss``,
        and ``test_acc`` where the loss reports one), chunked at
        ``max_batch`` and weighted by chunk size as the JAX package's."""
        if self.test_data is None:
            return {}
        d = self.test_data
        losses, accs, n = [], [], 0
        with torch.no_grad(), strict_fp32():
            for s in range(0, len(d), max_batch):
                sl = slice(s, s + max_batch)
                batch = format_batch(d.x[sl], d.y[sl], device=self.device)
                loss, mets = self.model.loss(params, batch)
                bs = len(next(iter(batch.values())))
                losses.append(float(loss) * bs)
                if "acc" in mets:
                    accs.append(float(mets["acc"]) * bs)
                n += bs
        out = {"test_loss": sum(losses) / n}
        if accs:
            out["test_acc"] = sum(accs) / n
        return out

    # -- main loop ----------------------------------------------------------
    def init_taus(self) -> np.ndarray:
        cfg = self.cfg
        if cfg.mode == "fedveca":
            return np.full(self.C, cfg.tau_init, np.int32)
        taus = (np.asarray(cfg.fixed_tau, np.int32) if cfg.fixed_tau is not None
                else np.full(self.C, cfg.tau_init, np.int32))
        return np.clip(taus, 1, cfg.tau_max)

    def run(self, params=None, rounds: Optional[int] = None) -> RunLogger:
        cfg = self.cfg
        rounds = rounds or cfg.rounds
        if params is None:
            params = self.model.init(cfg.seed)
        params = {k: v.to(self.device) for k, v in params.items()}
        log = RunLogger(cfg.log_dir, name=f"{cfg.mode}")
        if self.buffered_engine is not None:
            return self.buffered_engine.run(params, rounds, self.init_taus(), logger=log)
        return self.driver.run(params, rounds, self.init_taus(), logger=log)


def run_on_ranks(world: int, backend: str, arch, client_data: List[Dataset],
                 cfgs: List[FedSimConfig], *, device=None,
                 params=None) -> List[List[dict]]:
    """Simulations sharded over ``world`` new ranks (``launch/mesh.spawn``):
    rank r builds ``arch``'s model on its device (``device`` under gloo,
    None meaning the card; ``cuda:r`` under nccl) and the mesh
    ``make_federated_mesh()``, then runs a simulator for each
    config of ``cfgs``, each from ``params`` (host tensors; None: the
    model's init from the config's seed); the first run also warms the
    ranks' processes. Returns, for each rank, a dict a config: ``rows``
    (rank 0's, empty elsewhere), ``params`` (host tensors, the same on
    every rank), the controller's per-client statistics ``vals``,
    ``ms_per_round`` (host clock over ``run`` ending in a sync),
    ``host_blocked_s``, the kernels' ``launches`` and the ``collectives``
    of the run, ``peak_mem_gb`` (the card's, 0 on the CPU) and
    ``all_reduce_ms`` (``sharding.api.time_all_reduce`` at the model's
    size, after the runs)."""
    from repro_torch.launch.mesh import spawn

    return spawn(_simulate_rank, world, backend, arch, device, client_data, list(cfgs),
                 params)


def _simulate_rank(arch, device, client_data, cfgs, params):
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.vecavg import ops as va_ops
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding import api

    mesh = make_federated_mesh(device=device)
    model = build_model(arch, device=mesh.device)
    cuda = mesh.device.type == "cuda"
    outs = []
    for cfg in cfgs:
        sim = FederatedSimulator(model, client_data, dataclasses.replace(cfg, mesh=mesh))
        if cuda:
            torch.cuda.synchronize(mesh.device)
            torch.cuda.reset_peak_memory_stats(mesh.device)
        va_ops.reset_launches()
        rn_ops.reset_launches()
        api.reset_collectives()
        t0 = time.perf_counter()
        log = sim.run(params=params)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        ms = 1e3 * (time.perf_counter() - t0) / cfg.rounds
        outs.append(dict(
            rows=log.rows, params={k: v.cpu() for k, v in log.params.items()},
            vals={k: v.cpu().numpy() for k, v in log.controller_state.vals.items()},
            ms_per_round=ms, host_blocked_s=(sim.buffered_engine or sim.driver).host_blocked_s,
            launches=dict(va_ops.launches, **rn_ops.launches), collectives=dict(api.collectives),
            peak_mem_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9 if cuda else 0.0))
    numel = sum(v.numel() for v in outs[-1]["params"].values())
    ar = api.time_all_reduce(numel, mesh.group, mesh.device) if mesh.size > 1 else 0.0
    return [dict(o, all_reduce_ms=ar) for o in outs]


def fair_fixed_tau(tau_all: int, rounds: int, batch: int, sizes: np.ndarray) -> np.ndarray:
    """§IV-A1: E_avg = tau_all/K * B/D; tau_i = floor(E_avg * D_i / B)."""
    D = float(sizes.sum())
    e_avg = (tau_all / rounds) * batch / D
    return np.maximum(1, np.floor(e_avg * sizes / batch)).astype(np.int32)


def centralized_sgd(model, data: Dataset, iterations: int, batch: int, eta: float,
                    test_data: Optional[Dataset] = None, seed: int = 0, params=None):
    """The paper's centralized baseline: tau_all SGD iterations on pooled
    data, drawn with numpy ``RandomState(seed)`` as the JAX package draws
    them. Returns (params, test metrics)."""
    rng = np.random.RandomState(seed)
    dev = model.device
    params = model.init(seed) if params is None else params
    params = {k: v.to(dev) for k, v in params.items()}
    gv = grad_and_value(model.loss, has_aux=True)
    with strict_fp32():
        for _ in range(iterations):
            idx = rng.randint(0, len(data), size=batch)
            g, _ = gv(params, format_batch(data.x[idx], data.y[idx], device=dev))
            params = {k: (w.float() - eta * g[k].float()).to(w.dtype)
                      for k, w in params.items()}
    if test_data is None:
        return params, {}
    ev = make_dataset_evaluator(model.loss, test_data, device=dev)(params)
    return params, {k: float(v) for k, v in ev.items()}
