"""FedVeca core: the vectorized federated round (port of
``repro/core/fedveca.py``).

The paper's round (Alg. 1 lines 3-7 + Alg. 2) in one call:

  * every client's local loop is a fixed-trip loop of ``tau_max`` SGD
    steps with per-client masks (step ``l`` is a no-op when ``l >= tau_i``),
    so one program serves any mix of step sizes;
  * clients are vectorized: each step takes every client's minibatch
    gradient at once with ``torch.func.vmap`` over
    ``torch.func.grad_and_value`` along a leading client axis C;
  * the bi-directional vector is the step-size-normalized local gradient
    G_i = (1/tau_i) sum_l grad F_i(w^l) (Eq. 5, FedNova update rule), and
    the global step is w_{k+1} = w_k - eta * tau_k * sum_i p_i G_i;
  * the Assumption-3/4 statistics (beta_(k,i), delta_(k,i)) of Alg. 2
    lines 15-18 are estimated inside the same loop from parameter/gradient
    norms, in float32 and in the JAX package's order of operations.

Mode specialization lives in ``core/strategy.py``; the server reduce is
the vecavg kernel unless ``aggregator="fallback"`` is named.

Under a model axis (``model_axis``, ROADMAP.md A18b) the params are this
rank's pieces: every norm the statistics and the controller read is
completed over the model group (``core/tree.model_complete``; the local
loop's three per-client sums a step in ONE all-reduce), so every model
rank takes the same decisions; the reduce is ``strategy.model_reduce``,
and a wire codec decides over each whole leaf (``core/wire.wire_fold``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.strategy import (
    MODES,
    Strategy,
    get_strategy,
    global_sum,
    make_reduce,
    model_reduce,
    psum_reduce,
)
from repro_torch.core.tree import tree_axpy, tree_sqnorm, tree_sub, tree_zeros_like
from repro_torch.core.wire import wire_fold
from repro_torch.sharding.api import all_reduce

__all__ = ["MODES", "RoundStats", "ScaffoldState", "make_local_update", "make_round_step"]


class RoundStats(NamedTuple):
    """Per-round observables the server controller consumes (Alg. 1)."""

    loss0: torch.Tensor  # [C] F_i(w_k) (step-0 minibatch estimate)
    beta: torch.Tensor  # [C] max_l ||gF_i(w_k)-gF_i(w^l)|| / ||w_k-w^l||
    delta: torch.Tensor  # [C] max_l ||sum_s g^s||^2 / ((l+1)*||gF(w_{k-1})||^2)
    g0_sqnorm: torch.Tensor  # [C] ||grad F_i(w_k)||^2
    tau: torch.Tensor  # [C] step sizes used this round
    tau_k: torch.Tensor  # scalar sum_i p_i tau_i
    global_grad: Any  # tree: grad F(w_k) = sum_i p_i grad F_i(w_k)  (Eq. 8)
    update_sqnorm: torch.Tensor  # ||w_{k+1} - w_k||^2
    params_sqnorm: torch.Tensor  # ||w_k||^2 (round-start; L estimate at k=1)
    global_grad_sqnorm: torch.Tensor  # ||grad F(w_k)||^2


class ScaffoldState(NamedTuple):
    c: Any  # server control variate (tree)
    c_i: Any  # per-client control variates (leaves [C, ...])


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[C] -> broadcastable against a [C, ...] leaf."""
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def _remap(tree, f: Callable, *others):
    """``tree_map(f, tree, *others)`` that drops each old leaf of ``tree`` as
    soon as its new one exists (``tree``, a dict of the caller's own, is
    emptied): the local loop's trees are model-sized [C, ...] stacks, and a
    whole second copy of one would add a stack to the round's peak."""
    out = {}
    for k in sorted(tree):
        out[k] = f(tree.pop(k), *(o[k] for o in others))
    return out


def _sqdist_per_client(a, b, keys) -> torch.Tensor:
    """``tree_sqnorm_per_client(tree_sub(a, b))`` over ``keys`` (sorted) a
    leaf at a time, in the same order of operations, without the
    difference tree; ``b`` None: ``a``'s own norms."""
    return sum(((a[k] - b[k]) if b is not None else a[k]).float().square()
               .reshape(a[k].shape[0], -1).sum(1) for k in keys)


def _step_sums(pairs, keys, model_axis):
    """The local step's per-client squared distances ``pairs`` ((a, b) of
    stacked trees) over every leaf: the plain sums without a model axis;
    under one, the sharded leaves' partial sums of all of them completed
    in ONE all-reduce of [len(pairs), C], plus the replicated leaves'."""
    if model_axis is None:
        return [_sqdist_per_client(a, b, keys) for a, b in pairs]
    sh = [k for k in keys if k in model_axis.sharded]
    rep = [k for k in keys if k not in model_axis.sharded]
    out = [None] * len(pairs)
    if sh:
        part = torch.stack([_sqdist_per_client(a, b, sh) for a, b in pairs])
        out = list(all_reduce([part], model_axis.group)[0])
    if rep:
        out = [r if o is None else o + r
               for o, r in zip(out, (_sqdist_per_client(a, b, rep) for a, b in pairs))]
    return out


def make_local_update(loss_fn: Callable, *, eta: float, strategy: Strategy,
                      model_axis=None, stat_dtype=torch.float32) -> Callable:
    """Build the clients' local loops (Alg. 2 lines 3-19), batched over C.

    local_update(params0, batches, tau, gprev_sqnorm, c_server, c_client)
      params0: the global model (unstacked); batches: leaves [C, T, b, ...]
      (T trips of the loop, the round's tau_max); tau [C] int; c_client [C, ...]
      -> dict(params, g0, cum_g [C, ...] trees; beta, delta, loss0 [C])

    The JAX package builds this un-vmapped per client and vmaps the whole
    loop; here only the gradient is vmapped and the loop's statistics are
    written over the stacked client axis, with the same operations.
    ``stat_dtype`` is the g0 / cum_g accumulators' type (the JAX
    package's); ``model_axis`` completes the statistics' norms.
    """
    vg = vmap(grad_and_value(loss_fn, has_aux=True))

    def local_update(params0, batches, tau, gprev_sqnorm, c_server, c_client):
        C = tau.shape[0]
        dev = tau.device
        T = next(iter(batches.values())).shape[1]
        start = {k: v.expand((C,) + v.shape) for k, v in params0.items()}
        keys = sorted(params0)
        zeros = {k: torch.zeros((C,) + v.shape, dtype=stat_dtype, device=dev)
                 for k, v in params0.items()}
        params, g0, cum_g = dict(start), zeros, dict(zeros)
        beta = torch.zeros(C, dtype=torch.float32, device=dev)
        delta, loss0 = beta, beta
        for lam in range(T):
            active = (lam < tau).float()
            g, (loss, _) = vg(params, {k: v[:, lam] for k, v in batches.items()})
            is0 = float(lam == 0)
            g0 = _remap(g0, lambda a, b: (a.float() + is0 * b.float()).to(a.dtype), g)
            loss0 = loss0 + is0 * loss.float()

            # --- Assumption-3/4 statistics (masked, lam >= 1 only) --------
            lam_ge1 = float(lam >= 1) * active
            cum_g = _remap(
                cum_g, lambda a, b: (a.float() + _col(active, b) * b.float()).to(a.dtype), g)
            # ||w^l - w_k||^2, ||g^l - g^0||^2, ||sum_s g^s||^2
            dist_sq, gdiff_sq, cumsum_sq = _step_sums(
                [(params, start), (g, g0), (cum_g, None)], keys, model_axis)
            beta_l = torch.sqrt(gdiff_sq / torch.clamp_min(dist_sq, 1e-20))
            beta = torch.maximum(beta, lam_ge1 * beta_l)
            denom = (float(lam) + 1.0) * torch.clamp_min(gprev_sqnorm, 1e-20)
            delta = torch.maximum(delta, lam_ge1 * (cumsum_sq / denom))

            # --- local SGD update (Eq. 1), strategy-adjusted --------------
            drift = tree_sub(params, start) if strategy.uses_drift else None  # w^l - w_k
            upd = strategy.local_direction(g, drift, c_server, c_client)
            step = eta * active
            params = _remap(
                params, lambda w, u: (w.float() - _col(step, u) * u.float()).to(w.dtype), upd)
            del g, drift, upd  # not held through the next gradient call
        return dict(params=params, g0=g0, cum_g=cum_g, beta=beta, delta=delta, loss0=loss0)

    return local_update


def make_round_step(
    loss_fn: Callable,
    *,
    eta: float,
    mode: str = "fedveca",
    mu: float = 0.0,  # fedprox proximal coefficient
    aggregator="auto",  # 'auto' | 'pallas' (the vecavg kernel) | 'fallback' | Reduce
    wire=None,  # a WireCodec (core/wire.py): the per-client cum_g rows pass
    #   through an error-feedback encode/decode before the reduce; None or
    #   identity is the round without the stage, bit for bit
    axis_name=None,  # the client-axis process group when the round runs on
    #   one rank of a client-sharded world: the client-axis arguments hold
    #   only the rank's clients, the server reduce becomes the shard-local
    #   reduce plus one all-reduce, and every cross-client scalar (tau_k,
    #   the global gradient) is completed across the ranks (DESIGN.md §11)
    model_axis=None,  # a sharding.partition.ModelAxis when the params are
    #   this rank's pieces of a model-axis layout: the statistics' norms
    #   complete over its group and the reduce is strategy.model_reduce
    stat_dtype=torch.float32,  # the g0 / cum_g accumulators' type
) -> Callable:
    """Build the federated round.

    loss_fn(params, batch) -> (scalar, metrics dict).

    round_step(params, batches, tau, p, gprev_sqnorm, scaffold=None)
      params:  global model tree (never modified; a new tree is returned)
      batches: per-client per-step minibatches, leaves [C, tau_max, ...]
      tau:     [C] int, 1 <= tau_i <= tau_max
      p:       [C] client weights (D_i / D)
      gprev_sqnorm: scalar ||grad F(w_{k-1})||^2 (server broadcast, Alg. 2
                    line 14/17); 0 in round 0 (delta falls back to 1)
      -> (new_params, RoundStats, new_scaffold)

    With ``wire`` a trailing ``residual`` argument (leaves [C, ...], the
    clients' error-feedback rows) is consumed and the return grows to
    ``(new_params, stats, new_scaffold, new_residual)``: the raw ``cum_g``
    rows are folded through the codec (``core/wire.wire_fold``) before the
    strategy reduces them, so every mode and both reduces see decoded
    dense rows and stay as they are.

    The server reduce runs twice a round (the global step and the Eq. 8
    global gradient), so the vecavg kernel launches twice a round (four
    under a model axis that shards some leaves and replicates others:
    ``strategy.model_reduce`` launches once over each kind).

    With ``axis_name`` the same contract holds on each rank: C is the
    rank's client count, the per-client stats come back rank-sized, and
    the model-sized outputs (new_params, global_grad) are the same on
    every rank.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; valid: {MODES}")
    if wire is not None and wire.is_identity:
        wire = None  # identity short-circuits: the round without the stage
    if wire is not None and mode == "scaffold":
        raise ValueError(
            "wire compression applies to the cum_g update; scaffold "
            "aggregates parameter deltas and is not supported with a "
            "non-identity wire codec")
    strategy = get_strategy(mode, mu=mu)
    reduce = make_reduce(aggregator)
    if model_axis is not None:
        reduce = model_reduce(reduce, model_axis)
    if axis_name is not None:
        reduce = psum_reduce(reduce, axis_name)
    local_update = make_local_update(loss_fn, eta=eta, strategy=strategy,
                                     model_axis=model_axis, stat_dtype=stat_dtype)

    def round_step(params, batches, tau, p, gprev_sqnorm,
                   scaffold: Optional[ScaffoldState] = None, residual=None):
        C = tau.shape[0]
        tau_f = tau.float()
        gprev_sqnorm = torch.as_tensor(gprev_sqnorm, dtype=torch.float32, device=tau.device)
        # the control variates exist for SCAFFOLD alone: every other mode's
        # local direction ignores them, and two zero trees of the model's
        # size (one of them [C, ...]) would only take memory
        c_server = c_client = None
        if strategy.uses_scaffold:
            c_server = scaffold.c if scaffold is not None else tree_zeros_like(params)
            c_client = (scaffold.c_i if scaffold is not None else
                        {k: torch.zeros((C,) + v.shape, dtype=v.dtype, device=v.device)
                         for k, v in params.items()})
        outs = local_update(params, batches, tau, gprev_sqnorm, c_server, c_client)
        new_residual = residual
        if wire is not None:
            decoded, new_residual = wire_fold(wire, outs["cum_g"], residual, model_axis)
            outs = dict(outs, cum_g=decoded)

        tau_k = global_sum(p * tau_f, axis_name)
        delta_w = strategy.server_delta(outs, params, tau_f, p, eta, reduce, axis_name)
        new_params = tree_axpy(1.0, delta_w, params)

        new_scaffold = scaffold
        if strategy.uses_scaffold:
            new_scaffold = strategy.update_scaffold(
                outs, params, ScaffoldState(c=c_server, c_i=c_client), tau_f, eta, axis_name)

        # Eq. (8): global gradient + per-client ||g0||^2 from the same reduce
        global_grad, g0_sqn = reduce(outs["g0"], p, 1.0)
        stats = RoundStats(
            loss0=outs["loss0"],
            beta=outs["beta"],
            delta=outs["delta"],
            g0_sqnorm=g0_sqn,
            tau=tau,
            tau_k=tau_k,
            global_grad=global_grad,
            update_sqnorm=tree_sqnorm(delta_w, model_axis),
            params_sqnorm=tree_sqnorm(params, model_axis),
            global_grad_sqnorm=tree_sqnorm(global_grad, model_axis),
        )
        if wire is not None:
            return new_params, stats, new_scaffold, new_residual
        return new_params, stats, new_scaffold

    return round_step
