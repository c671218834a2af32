"""FedVeca server controller (Algorithm 1), port of the device-resident
``ControllerCore`` of ``repro/core/controller.py``: L estimation,
A_(k,i), the Theorem-2 step-size bound, the Eq. (15) tau prediction.

``ControllerCore.step`` is pure tensor math over a ``CoreState`` that
lives on the round's device (including the two retained global-gradient
trees), run right after the round by ``core/engine.RoundEngine.run_fused``,
so the next round's taus never leave the device.

The scalar math is float32 in the JAX package's order of operations,
including the float32 ``alpha_k`` (ROADMAP R3): every op involved
(mul/div/sqrt/floor/min/max) is correctly rounded in IEEE float32, so on
the same inputs the two controllers give the same taus.

The port runs full participation only: every client reports every round,
so the JAX package's staleness view of partial participation
(``CohortStats``, and the ``ever``/``stale_w``/``vals`` fields of its
``CoreState``) reduces to this round's statistics and is not carried;
cohorts come with ROADMAP A16. With finite statistics the weighting it
applies, ``1 * v + 0 * mean``, is ``v`` exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.fedveca import RoundStats
from repro_torch.core.tree import tree_norm, tree_sub


@dataclasses.dataclass
class ControllerConfig:
    eta: float
    alpha: float = 0.95  # paper's default (1 - alpha_k = 0.05, Fig. 7)
    tau_max: int = 50  # paper §IV-A4
    tau_min: int = 2  # paper resets tau<=1 -> 2 (Alg. 1 lines 19-21)
    eps: float = 1e-12


class CoreState(NamedTuple):
    """Alg. 1 server state, on the round's device. ``taus`` is the tau
    vector the NEXT round will use."""

    round: torch.Tensor  # int32 scalar, k
    L: torch.Tensor  # f32 scalar, running max L estimate
    prev_global_grad: Any  # grad F(w_{k-1}) tree
    prev2_global_grad: Any  # grad F(w_{k-2}) tree
    prev_grad_sqnorm: torch.Tensor  # f32 ||grad F(w_{k-1})||^2
    params0_sqnorm: torch.Tensor  # f32 ||w_0||^2
    prev_update_sqnorm: torch.Tensor  # f32 ||w_k - w_{k-1}||^2
    prev2_update_sqnorm: torch.Tensor  # f32 ||w_{k-1} - w_{k-2}||^2
    taus: torch.Tensor  # [C] int32 taus for the upcoming round


class ControllerCore:
    """The Alg. 1 update as tensor math. ``adapt=False`` keeps taus fixed
    (FedAvg/FedNova baselines) while still tracking L for the premise
    value eta * tau_k * L."""

    def __init__(self, cfg: ControllerConfig, num_clients: int, *, adapt: bool = True):
        self.cfg = cfg
        self.C = num_clients
        self.adapt = adapt

    def init_state(self, params_like, taus) -> CoreState:
        """Fresh round-0 state; ``params_like`` fixes the gradient trees'
        structure and device (zeros, so the k=1/k=2 L branches are
        NaN-free)."""
        dev = next(iter(params_like.values())).device

        def f32():
            return torch.zeros((), dtype=torch.float32, device=dev)

        def zeros():
            return {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                    for k, v in sorted(params_like.items())}

        return CoreState(
            round=torch.zeros((), dtype=torch.int32, device=dev),
            L=f32(), prev_global_grad=zeros(), prev2_global_grad=zeros(),
            prev_grad_sqnorm=f32(), params0_sqnorm=f32(), prev_update_sqnorm=f32(),
            prev2_update_sqnorm=f32(),
            taus=torch.as_tensor(np.asarray(taus, np.int32), device=dev),
        )

    def step(self, state: CoreState, stats: RoundStats, taus_used: torch.Tensor):
        """(state, this round's stats, the taus it used) -> (new state,
        diag dict of small device tensors)."""
        cfg = self.cfg
        # Python scalars enter each op as float32 kernel arguments (jnp's
        # float32 constants); a tensor made from one would cost a
        # host-to-device copy that waits for the stream.
        eps = cfg.eps
        k = state.round
        beta = stats.beta.float()
        delta = stats.delta.float()

        # ---- L estimation, one-round delay (Alg. 1 lines 11-16) ----------
        L1 = torch.sqrt(state.prev_grad_sqnorm) / torch.clamp_min(
            torch.sqrt(state.params0_sqnorm), eps)
        num = tree_norm(tree_sub(state.prev_global_grad, state.prev2_global_grad))
        den = torch.sqrt(state.prev2_update_sqnorm)
        L2 = num / torch.clamp_min(den, eps)
        L_obs = torch.where(k == 1, L1, L2)
        L = torch.where(k >= 1, torch.maximum(state.L, L_obs), state.L)

        # ---- A_(k,i) = eta * beta^2 * delta (Theorem 1) -------------------
        A = cfg.eta * beta.square() * delta  # [C]

        # ---- Eq. (15): tau prediction -------------------------------------
        A_safe = torch.clamp_min(A, eps)
        A_min = A_safe.min()
        bound = 2.0 * L / torch.clamp_min(A_min, eps)
        alpha = float(np.float32(cfg.alpha))
        alpha_k = torch.where(bound < 1.0, torch.clamp_max(0.999 * bound, alpha),
                              torch.full_like(bound, alpha))
        denom = A_safe - alpha_k * A_min
        tau_f = torch.where(denom > eps, torch.floor(A_safe / torch.clamp_min(denom, eps)),
                            float(cfg.tau_max))
        tau_f = torch.where(tau_f <= 1.0, float(cfg.tau_min), tau_f)
        tau_pred = torch.clamp(tau_f, cfg.tau_min, cfg.tau_max).to(torch.int32)
        use_pred = (k >= 1) & torch.isfinite(A).all() & (A > eps).any()
        taus_used = taus_used.to(torch.int32)
        tau_next = torch.where(use_pred, tau_pred, taus_used) if self.adapt else taus_used

        grad_sqnorm = stats.global_grad_sqnorm
        new_state = CoreState(
            round=k + 1,
            L=L,
            prev_global_grad=stats.global_grad,
            prev2_global_grad=state.prev_global_grad,
            prev_grad_sqnorm=grad_sqnorm,
            params0_sqnorm=torch.where(k == 0, stats.params_sqnorm, state.params0_sqnorm),
            prev_update_sqnorm=stats.update_sqnorm,
            prev2_update_sqnorm=state.prev_update_sqnorm,
            taus=tau_next,
        )
        diag = dict(
            L=L,
            premise=cfg.eta * stats.tau_k * L,
            A=A,
            alpha_k=alpha_k,
            tau_next=tau_next,
            beta=beta,
            delta=delta,
            grad_sqnorm=grad_sqnorm,
        )
        return new_state, diag
