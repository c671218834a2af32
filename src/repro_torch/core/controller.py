"""FedVeca server controller (Algorithm 1), port of
``repro/core/controller.py``: L estimation, A_(k,i), the Theorem-2
step-size bound, the Eq. (15) tau prediction, and the staleness view of
partial participation.

Two implementations of the same control law, as in the JAX package:

  * ``ControllerCore``: tensor math over a ``CoreState`` that lives on the
    round's device (including the two retained global-gradient trees),
    run right after the round by ``core/engine.RoundEngine.run_fused``, so
    the next round's taus never leave the device;
  * ``FedVecaController`` + ``CohortStats``: the host-side numpy oracle
    (the message-passing prototype's controller, ``fed/prototype.py``).

With a cohort only m <= C clients report each round. Both scatter the
cohort's statistics into a per-client view: a client never observed
reads the mean of the observed ones, and one last observed ``age`` rounds
ago reads ``decay^age * last_seen + (1 - decay^age) * mean``. With every
client observed every round the weighting is ``1 * v + 0 * mean``, which
is ``v`` exactly for finite statistics.

With a client-axis mesh (``ControllerCore(mesh=)``) every rank steps the
whole controller: ``step`` takes the rank's rows of the round's members
and statistics, all-gathers them (a few hundred bytes) and runs the
unsharded step, so every rank holds the same full-C state and the tau
traces equal the unsharded ones. The JAX package shards the ``[C]``
arrays under GSPMD instead; the arithmetic is the same (ROADMAP.md P10).

The scalar math is float32 in the JAX package's order of operations,
including the float32 ``alpha_k`` (ROADMAP R3): every op involved
(mul/div/sqrt/floor/min/max) is correctly rounded in IEEE float32, so on
the same inputs the controllers give the same taus.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.fedveca import RoundStats
from repro_torch.core.tree import tree_norm, tree_sub
from repro_torch.sharding.api import all_gather, client_group, validate_client_count

_STAT_KEYS = ("loss0", "beta", "delta", "g0_sqnorm")


def _check_decay(decay: float) -> None:
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"decay must be in (0, 1], got {decay}")


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _f32(x) -> np.float32:
    """A scalar tensor (on any device), array or float -> numpy float32."""
    return np.float32(_host(x))


class CohortStats:
    """Full-C per-client statistics under partial participation (host-side
    numpy twin of ``CoreState``'s ``ever``/``stale_w``/``vals``).

    Eq. 15 needs (beta, delta) for every client, but a cohort observes only
    m <= C of them a round. Clients never observed read the mean of the
    observed ones (zeros would make A_min 0); clients observed ``age``
    rounds ago read ``decay^age * last_seen + (1 - decay^age) * mean``,
    the weight kept as one float32 multiply a round, as the device core
    keeps it. ``decay=1.0`` freezes clients at their last-seen values.
    """

    _keys = _STAT_KEYS

    def __init__(self, num_clients: int, decay: float = 0.9):
        _check_decay(decay)
        self.C = num_clients
        self.decay = decay
        self.ever = np.zeros(num_clients, bool)
        self.w = np.zeros(num_clients, np.float32)  # decay^age, 0 if never seen
        self.vals = {k: np.zeros(num_clients, np.float32) for k in self._keys}

    def scatter(self, stats: RoundStats, members, taus) -> RoundStats:
        """Cohort-sized stats + this round's members -> full-C RoundStats
        (the per-client fields and ``tau`` as numpy arrays)."""
        members = _host(members)
        self.w *= np.float32(self.decay)
        for k in self._keys:
            self.vals[k][members] = _host(getattr(stats, k)).astype(np.float32)
        self.ever[members] = True
        self.w[members] = 1.0
        out = {k: v.copy() for k, v in self.vals.items()}
        ever_f = self.ever.astype(np.float32)
        n_obs = np.maximum(np.sum(ever_f), np.float32(1.0))
        for k in ("beta", "delta"):
            mean_k = np.sum(out[k] * ever_f) / n_obs
            out[k] = self.w * out[k] + (np.float32(1.0) - self.w) * mean_k
        return stats._replace(tau=_host(taus), **out)


@dataclasses.dataclass
class ControllerConfig:
    eta: float
    alpha: float = 0.95  # paper's default (1 - alpha_k = 0.05, Fig. 7)
    tau_max: int = 50  # paper §IV-A4
    tau_init: int = 2
    tau_min: int = 2  # paper resets tau<=1 -> 2 (Alg. 1 lines 19-21)
    eps: float = 1e-12
    decay: float = 0.9  # staleness retention a round (CohortStats)


@dataclasses.dataclass
class ControllerState:
    round: int = 0
    L: float = 0.0
    prev_global_grad: Any = None  # grad F(w_{k-1}) tree
    prev2_global_grad: Any = None  # grad F(w_{k-2})
    prev_grad_sqnorm: float = 0.0  # ||grad F(w_{k-1})||^2 broadcast to clients
    params0_sqnorm: float = 0.0  # ||w_0||^2 (k=1 L estimate)
    prev_update_sqnorm: float = 0.0  # ||w_k - w_{k-1}||^2
    prev2_update_sqnorm: float = 0.0  # ||w_{k-1} - w_{k-2}||^2


class FedVecaController:
    """Predicts tau_(k+1,i) from round-k statistics (Eq. 15), numpy oracle.

    ``stats`` may hold tensors on any device (a tree norm is taken where
    the gradient trees lie, as the device core takes it) or numpy arrays.
    """

    def __init__(self, cfg: ControllerConfig, num_clients: int):
        self.cfg = cfg
        self.C = num_clients

    def init_taus(self) -> np.ndarray:
        return np.full((self.C,), self.cfg.tau_init, np.int32)

    def init_state(self) -> ControllerState:
        return ControllerState()

    def update(self, state: ControllerState, stats: RoundStats, _unused=None):
        """Consume round-k stats (measured at w_k); emit tau for round k+1.
        -> (new state, tau_next [C] int32, diag dict)."""
        cfg = self.cfg
        k = state.round
        eps = np.float32(cfg.eps)

        # ---- L estimation, one-round delay (Alg. 1 lines 11-16) ----------
        L_obs = None
        if k == 1 and state.prev_global_grad is not None:
            L_obs = np.sqrt(np.float32(state.prev_grad_sqnorm)) / np.maximum(
                np.sqrt(np.float32(state.params0_sqnorm)), eps)
        elif k >= 2:
            num = _f32(tree_norm(tree_sub(state.prev_global_grad, state.prev2_global_grad)))
            den = np.sqrt(np.float32(state.prev2_update_sqnorm))
            L_obs = num / np.maximum(den, eps)
        L = np.maximum(np.float32(state.L), L_obs) if L_obs is not None else np.float32(state.L)

        # ---- A_(k,i) = eta * beta^2 * delta (Theorem 1) -------------------
        beta = _host(stats.beta).astype(np.float32)
        delta = _host(stats.delta).astype(np.float32)
        A = np.float32(cfg.eta) * np.square(beta) * delta  # [C]

        tau_k = _f32(stats.tau_k)
        diag: Dict[str, Any] = {
            "round": k, "L": float(L), "A": A, "beta": beta, "delta": delta,
            "tau_k": float(tau_k), "premise": float(np.float32(cfg.eta) * tau_k * L),
        }

        # ---- Eq. (15): tau prediction -------------------------------------
        if k < 1 or not np.all(np.isfinite(A)) or not np.any(A > eps):
            tau_next = _host(stats.tau).astype(np.int32).copy()
        else:
            A_safe = np.maximum(A, eps)
            A_min = A_safe.min()
            bound = np.float32(2.0) * L / np.maximum(A_min, eps)
            alpha = np.float32(cfg.alpha)
            alpha_k = np.minimum(alpha, np.float32(0.999) * bound) if bound < 1.0 else alpha
            denom = A_safe - alpha_k * A_min
            tau_f = np.where(denom > eps, np.floor(A_safe / np.maximum(denom, eps)),
                             np.float32(cfg.tau_max))
            tau_f = np.where(tau_f <= 1.0, np.float32(cfg.tau_min), tau_f)  # 19-21
            tau_next = np.clip(tau_f, cfg.tau_min, cfg.tau_max).astype(np.int32)
            diag["alpha_k"] = float(alpha_k)
            diag["direction"] = np.sign(denom)  # the bi-directional vector's sign

        new_state = ControllerState(
            round=k + 1,
            L=float(L),
            prev_global_grad=stats.global_grad,
            prev2_global_grad=state.prev_global_grad,
            prev_grad_sqnorm=float(_f32(stats.global_grad_sqnorm)),
            params0_sqnorm=float(_f32(stats.params_sqnorm)) if k == 0 else state.params0_sqnorm,
            prev_update_sqnorm=float(_f32(stats.update_sqnorm)),
            prev2_update_sqnorm=state.prev_update_sqnorm,
        )
        diag["tau_next"] = tau_next
        return new_state, tau_next, diag


class CoreState(NamedTuple):
    """Alg. 1 server state and the per-client statistics view, on the
    round's device. ``taus`` is the tau vector the NEXT round will use;
    ``ever``/``stale_w``/``vals`` are the device twin of ``CohortStats``."""

    round: torch.Tensor  # int32 scalar, k
    L: torch.Tensor  # f32 scalar, running max L estimate
    prev_global_grad: Any  # grad F(w_{k-1}) tree
    prev2_global_grad: Any  # grad F(w_{k-2}) tree
    prev_grad_sqnorm: torch.Tensor  # f32 ||grad F(w_{k-1})||^2
    params0_sqnorm: torch.Tensor  # f32 ||w_0||^2
    prev_update_sqnorm: torch.Tensor  # f32 ||w_k - w_{k-1}||^2
    prev2_update_sqnorm: torch.Tensor  # f32 ||w_{k-1} - w_{k-2}||^2
    taus: torch.Tensor  # [C] int32 taus for the upcoming round
    ever: torch.Tensor  # [C] bool, observed at least once
    stale_w: torch.Tensor  # [C] f32 decay^age (one multiply a round)
    vals: Dict[str, torch.Tensor]  # last-seen per-client stats, [C] f32 each


class ControllerCore:
    """The Alg. 1 update as tensor math: scatters a cohort's RoundStats into
    the full-C view, applies the staleness weighting, then runs the L
    estimate, the Theorem-2 alpha clamp and Eq. 15. ``adapt=False`` keeps
    taus fixed (FedAvg/FedNova baselines) while still tracking L for the
    premise value eta * tau_k * L.

    With ``mesh`` (a federated mesh, ``launch/mesh.make_federated_mesh``)
    C must divide over the client-axis shards, and ``step`` takes this
    rank's rows (see the module docstring). With ``model_axis`` (the
    model's, ``build_model(cfg, mesh=).model_axis``) the global gradients
    are the rank's pieces and the L estimate's norm completes over the
    model group, so every model rank takes the same taus."""

    def __init__(self, cfg: ControllerConfig, num_clients: int, *, adapt: bool = True,
                 mesh=None, model_axis=None):
        _check_decay(cfg.decay)
        self.cfg = cfg
        self.C = num_clients
        self.adapt = adapt
        self.mesh = mesh
        self.model_axis = model_axis
        validate_client_count(mesh, num_clients)
        self._group = None if mesh is None else client_group(mesh)

    def init_state(self, params_like, taus) -> CoreState:
        """Fresh round-0 state; ``params_like`` fixes the gradient trees'
        structure and device (zeros, so the k=1/k=2 L branches are
        NaN-free)."""
        dev = next(iter(params_like.values())).device

        def f32(shape=()):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def zeros():
            return {k: f32(v.shape) for k, v in sorted(params_like.items())}

        return CoreState(
            round=torch.zeros((), dtype=torch.int32, device=dev),
            L=f32(), prev_global_grad=zeros(), prev2_global_grad=zeros(),
            prev_grad_sqnorm=f32(), params0_sqnorm=f32(), prev_update_sqnorm=f32(),
            prev2_update_sqnorm=f32(),
            taus=torch.as_tensor(np.asarray(taus, np.int32), device=dev),
            ever=torch.zeros(self.C, dtype=torch.bool, device=dev),
            stale_w=f32(self.C), vals={k: f32(self.C) for k in _STAT_KEYS},
        )

    def step(self, state: CoreState, stats: RoundStats, members: torch.Tensor,
             taus_used: torch.Tensor):
        """(state, cohort stats, member ids [m], full-C taus used this round)
        -> (new state, diag dict of small device tensors).

        Sharded: ``members`` and the per-client fields of ``stats`` are this
        rank's rows; a member id of C marks a pad row (an imbalanced
        cohort's), which is dropped."""
        cfg = self.cfg
        # Python scalars enter each op as float32 kernel arguments (jnp's
        # float32 constants); a tensor made from one would cost a
        # host-to-device copy that waits for the stream.
        eps = cfg.eps
        k = state.round

        # ---- CohortStats scatter + staleness weighting --------------------
        if self._group is None:
            idx = members.long()
            rows = {key: getattr(stats, key).float() for key in _STAT_KEYS}
            stale_w = (state.stale_w * cfg.decay).index_fill(0, idx, 1.0)
            vals = {key: state.vals[key].index_copy(0, idx, rows[key]) for key in _STAT_KEYS}
            ever = state.ever.index_fill(0, idx, True)
        else:
            idx, rows = self._gather(members, stats)
            # pad rows (id C) land in a scratch row C that is cut off
            stale_w = _pad1(state.stale_w * cfg.decay).index_fill(0, idx, 1.0)[:-1]
            vals = {key: _pad1(state.vals[key]).index_copy(0, idx, rows[key])[:-1]
                    for key in _STAT_KEYS}
            ever = _pad1(state.ever).index_fill(0, idx, True)[:-1]
        ever_f = ever.float()
        n_obs = torch.clamp_min(ever_f.sum(), 1.0)
        weighted = {}
        for key in ("beta", "delta"):
            mean_k = (vals[key] * ever_f).sum() / n_obs
            weighted[key] = stale_w * vals[key] + (1.0 - stale_w) * mean_k

        # ---- L estimation, one-round delay (Alg. 1 lines 11-16) ----------
        L1 = torch.sqrt(state.prev_grad_sqnorm) / torch.clamp_min(
            torch.sqrt(state.params0_sqnorm), eps)
        num = tree_norm(tree_sub(state.prev_global_grad, state.prev2_global_grad),
                        self.model_axis)
        den = torch.sqrt(state.prev2_update_sqnorm)
        L2 = num / torch.clamp_min(den, eps)
        L_obs = torch.where(k == 1, L1, L2)
        L = torch.where(k >= 1, torch.maximum(state.L, L_obs), state.L)

        # ---- A_(k,i) = eta * beta^2 * delta (Theorem 1) -------------------
        A = cfg.eta * weighted["beta"].square() * weighted["delta"]  # [C]

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
            ever=ever,
            stale_w=stale_w,
            vals=vals,
        )
        diag = dict(
            L=L,
            premise=cfg.eta * stats.tau_k * L,
            A=A,
            alpha_k=alpha_k,
            tau_next=tau_next,
            beta=vals["beta"],
            delta=vals["delta"],
            grad_sqnorm=grad_sqnorm,
        )
        return new_state, diag

    def _gather(self, members, stats):
        """Every rank's member ids and per-client statistics, in rank order
        (one all-gather: the ids ride as float32 bits beside the stats)."""
        local = torch.stack([members.to(torch.int32).view(torch.float32)]
                            + [getattr(stats, key).float() for key in _STAT_KEYS])
        full = all_gather(local.t(), self._group).t()  # [1 + 4, K * n]
        idx = full[0].contiguous().view(torch.int32).long()
        return idx, {key: full[1 + i].contiguous() for i, key in enumerate(_STAT_KEYS)}


def _pad1(v: torch.Tensor) -> torch.Tensor:
    """``v`` [C] with one scratch row appended (the pad rows' target)."""
    return torch.cat([v, v[:1]])
