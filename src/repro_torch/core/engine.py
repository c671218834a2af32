"""RoundEngine: the owner of the federated round (port of
``repro/core/engine.py``: the synchronous, full-participation,
single-device round).

The engine composes:

  * the round step (``core/fedveca.make_round_step``) specialized by a
    per-mode ``Strategy`` with a pluggable server reduce — the vecavg
    kernel, or the tree path when ``aggregator="fallback"`` is named;
  * the device data path (``data/device.DeviceShards``): minibatch indices
    are drawn on the device each round (``key=``), or host-built batches
    are passed in (``batches=``);
  * the fused round + controller step (``run_fused``): the Alg. 1 update
    runs right after the round on the same device, so the next round's
    taus and ||grad F(w_{k-1})||^2 never visit the host.

The JAX package donates the params (and scaffold) buffers to its jitted
round; here the round is a plain functional update — a new params tree is
returned and the caller's is never modified.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
cohorts (``cohort_size``, ``cohort=``: A16), the engine's message-passing
and buffered halves (``client_update``, ``client_update_many``,
``server_aggregate``, ``wave_update``: A16), wire codecs (A17) and the
client-axis mesh (A18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import strict_fp32
from repro_torch.core.controller import ControllerCore
from repro_torch.core.fedveca import ScaffoldState, make_round_step
from repro_torch.core.strategy import get_strategy
from repro_torch.data.device import DeviceShards


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item}); the port "
        "runs the synchronous, full-participation, single-device round")


@dataclasses.dataclass
class EngineConfig:
    mode: str = "fedveca"  # fedveca | fednova | fedavg | fedprox | scaffold
    eta: float = 0.01
    tau_max: int = 2
    mu: float = 0.0  # fedprox proximal coefficient
    batch_size: int = 32  # per-client per-step minibatch (device data path)
    cohort_size: Optional[int] = None  # partial participation: ROADMAP A16
    aggregator: str = "auto"  # 'auto' | 'pallas' (vecavg kernel) | 'fallback'
    wire: Any = "none"  # client->server codecs: ROADMAP A17


class RoundEngine:
    """Runs the round for one (loss_fn, config) pair.

    loss_fn(params, batch) -> (scalar, metrics dict).

    ``run_round`` executes one full round; pass ``key=`` to sample from the
    engine's device shards, or ``batches=`` (leaves [C, tau_max, b, ...]) to
    use host-built data. Batches are moved to the params' device.
    """

    def __init__(
        self,
        loss_fn: Callable,
        cfg: EngineConfig,
        *,
        shards: Optional[DeviceShards] = None,
        controller: Optional[ControllerCore] = None,
        mesh=None,
    ):
        if cfg.cohort_size is not None:
            raise not_ported("cohort_size (partial participation)", "A16")
        if cfg.wire not in ("none", "identity", None):
            raise not_ported(f"wire={cfg.wire!r}", "A17")
        if mesh is not None:
            raise not_ported("mesh (client-axis sharding)", "A18")
        self.cfg = cfg
        self.shards = shards
        self.controller = controller
        self._strategy = get_strategy(cfg.mode, mu=cfg.mu)
        self._round = make_round_step(
            loss_fn, eta=cfg.eta, mode=cfg.mode, mu=cfg.mu, aggregator=cfg.aggregator)

    # -- full round ---------------------------------------------------------
    def run_round(self, params, tau, p, gprev_sqnorm, *, key=None, batches=None,
                  scaffold: Optional[ScaffoldState] = None, cohort=None):
        """One round: (new_params, RoundStats, scaffold)."""
        if cohort is not None:
            raise not_ported("cohort=", "A16")
        dev = self._device(params)
        batches = self._resolve_data(batches, key, dev)
        tau = torch.as_tensor(np.asarray(tau), dtype=torch.int32, device=dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, int(tau.shape[0]))
        with strict_fp32():
            return self._round(params, batches, tau, p, gprev_sqnorm, scaffold)

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
        if cohort is not None:
            raise not_ported("cohort=", "A16")
        dev = self._device(params)
        batches = self._resolve_data(batches, key, dev)
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        scaffold = self._materialize_scaffold(scaffold, params, self.controller.C)
        with strict_fp32():
            taus = torch.clamp(cstate.taus, 1, self.cfg.tau_max)
            new_params, stats, new_scaffold = self._round(
                params, batches, taus, p, cstate.prev_grad_sqnorm, scaffold)
            new_cstate, diag = self.controller.step(cstate, stats, taus)
            diag = dict(diag, train_loss=(p * stats.loss0).sum(), tau_k=stats.tau_k,
                        tau_round_sum=taus.sum(), update_sqnorm=stats.update_sqnorm)
        return new_params, new_cstate, new_scaffold, diag

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _device(params) -> torch.device:
        return next(iter(params.values())).device

    def _resolve_data(self, batches, key, dev):
        """Host batches (moved to ``dev``) XOR device shards + round key."""
        if batches is not None:
            return {k: v.to(dev) for k, v in batches.items()}
        if self.shards is None:
            raise ValueError("no device shards: pass batches= or build the "
                             "engine with shards=DeviceShards.from_datasets(...)")
        if key is None:
            raise ValueError("device data path needs key=")
        return self.shards.sample(key, self.cfg.tau_max, self.cfg.batch_size)

    def _materialize_scaffold(self, scaffold, params, C: int):
        if not self._strategy.uses_scaffold or scaffold is not None:
            return scaffold
        return ScaffoldState(
            c={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()},
            c_i={k: torch.zeros((C,) + v.shape, dtype=torch.float32, device=v.device)
                 for k, v in params.items()},
        )

    # -- not ported yet -----------------------------------------------------
    def client_update(self, *args, **kwargs):
        raise not_ported("RoundEngine.client_update (message-passing prototype)", "A16")

    def client_update_many(self, *args, **kwargs):
        raise not_ported("RoundEngine.client_update_many (message-passing prototype)",
                           "A16")

    def server_aggregate(self, *args, **kwargs):
        raise not_ported("RoundEngine.server_aggregate (message-passing prototype)", "A16")

    def wave_update(self, *args, **kwargs):
        raise not_ported("RoundEngine.wave_update (buffered rounds)", "A16")
