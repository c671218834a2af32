"""Per-mode federated update strategies + pluggable server reduces (port of
``repro/core/strategy.py``, single device).

The paper's "generalized update rules" (Eq. 2-3) specialize along two
seams, both on one ``Strategy`` per mode:

  * the client half — how a client turns its minibatch gradient into the
    local SGD direction (Alg. 2 line 7): plain SGD, FedProx's proximal
    pull, SCAFFOLD's control-variate correction;
  * the server half — how the stacked per-client accumulators reduce into
    the global step (Alg. 1 line 7 / Eq. 3+5): step-size-normalized
    (FedVeca/FedNova, Eq. 5), unnormalized sums (FedAvg/FedProx, Eq. 4),
    or parameter-delta averaging (SCAFFOLD).

In the port the client half sees the whole client axis at once: ``g``,
``drift`` and ``c_client`` are stacked trees ``[C, ...]`` and ``c_server``
is unstacked (it broadcasts).

Every server half routes through a ``reduce(stacked, w, scale, div=None)
-> (tree, sqnorms)`` callable; ``div`` [C] divides each client's row first
(FedVeca's and FedNova's G_i = cum_g_i / tau_i, which the JAX package
materialises as a tree). ``kernel_reduce`` is the vecavg kernel — one
launch over every leaf where it lies, the division folded in, that also
yields the per-client squared norms — and, like every kernel wrapper,
dispatches by device: a CPU tensor takes its plain version (which divides
first, as the JAX package does), a CUDA tensor the kernel.
``fallback_reduce`` is the per-leaf tree path, and is taken only when asked
for by name.

**The client axis** (DESIGN.md §11). On one rank of a client-sharded round
the stacked trees hold only the rank's clients, and ``axis_name`` is the
client-axis process group (``sharding.api.client_group``; None on one
device): ``psum_reduce`` completes the shard-local reduce with one
all-reduce of its output, ``global_sum`` completes a sum over the clients,
and SCAFFOLD's client count and mean control-variate delta are completed
the same way. The per-client squared norms stay with their rank.

**The model axis** (``model_reduce``): on a rank that holds pieces of the
sharded leaves the reduce launches once over those leaves (their
per-client squared norms all-reduced over the model group) and once over
the replicated ones, whose norms count once; the delta is elementwise and
needs no model collective. The client axis' all-reduce then runs over the
ranks that share this rank's model coordinate (they hold the same
pieces).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core.tree import (
    tree_axpy,
    tree_map,
    tree_scale,
    tree_sqnorm_per_client,
    tree_weighted_sum,
)
from repro_torch.kernels.vecavg.ops import vecavg_tree
from repro_torch.sharding.api import all_reduce, all_reduce_tree

MODES = ("fedveca", "fednova", "fedavg", "fedprox", "scaffold")

# reduce(stacked [C,...] tree, w [C], scale scalar, div [C] or None)
#   -> (scale * sum_c w_c * u_c, per-client ||u_c||^2), u_c = stacked_c / div_c
Reduce = Callable[..., Tuple[Any, torch.Tensor]]


def fallback_reduce(stacked, w, scale, div=None):
    """Per-leaf weighted reduction (tensordot) in plain PyTorch, after the
    per-leaf division by ``div``."""
    if div is not None:
        stacked = tree_map(lambda x: x / _per_client(div, x), stacked)
    out = tree_scale(tree_weighted_sum(stacked, w), scale)
    return out, tree_sqnorm_per_client(stacked)


def psum_reduce(base: Reduce, axis_name) -> Reduce:
    """Client-axis-sharded reduce: ``base`` (the kernel or the fallback)
    computes this rank's partial weighted sum and one all-reduce over the
    client-axis group completes it. The per-client squared norms stay
    shard-local ([C_local])."""

    def reduce(stacked, w, scale, div=None):
        out, sqn = base(stacked, w, scale, div=div)
        return all_reduce_tree(out, axis_name), sqn

    return reduce


def model_reduce(base: Reduce, model_axis) -> Reduce:
    """A reduce over a tree partitioned on ``model_axis``: ``base`` once
    over the sharded leaves, whose per-client squared norms complete with
    one all-reduce over the model group, and once over the replicated
    ones (two vecavg launches where there is one)."""

    def reduce(stacked, w, scale, div=None):
        sh, rep = model_axis.split(stacked)
        out, sqn = {}, None
        if sh:
            o, s = base(sh, w, scale, div=div)
            out.update(o)
            sqn = all_reduce([s], model_axis.group)[0]
        if rep:
            o, s = base(rep, w, scale, div=div)
            out.update(o)
            sqn = s if sqn is None else sqn + s
        return {k: out[k] for k in stacked}, sqn

    return reduce


def global_sum(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    """sum(x) over the (possibly sharded) client axis: the local sum, then
    an all-reduce over the client-axis group when ``axis_name`` is one."""
    s = x.sum()
    return s if axis_name is None else all_reduce([s], axis_name)[0]


def kernel_reduce(stacked, w, scale, div=None):
    """The vecavg kernel: one pass over every leaf, norms ride along."""
    # vecavg computes -scale * p @ U, so negate to match reduce's contract.
    return vecavg_tree(stacked, w, -scale, div=div)


def make_reduce(spec) -> Reduce:
    """'auto' | 'pallas' (both the kernel reduce) | 'fallback' | callable.

    The JAX package's 'auto' picks its fallback off the TPU; here 'auto'
    is the kernel reduce on every device, so nothing on the card reaches
    the tree path unless ``'fallback'`` is named."""
    if callable(spec):
        return spec
    if spec in ("auto", "pallas"):
        return kernel_reduce
    if spec == "fallback":
        return fallback_reduce
    raise ValueError(f"unknown aggregator {spec!r}; valid: 'auto', 'pallas', 'fallback'")


def _per_client(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast [C] over the trailing dims of a [C, ...] leaf."""
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


class Strategy:
    """One federated mode: client-side direction + server-side reduce."""

    name: str = "base"
    uses_scaffold: bool = False
    uses_drift: bool = False  # local_direction reads w^l - w_k (FedProx)

    # -- client half (Alg. 2 line 7) ----------------------------------------
    def local_direction(self, g, drift, c_server, c_client):
        """Gradient -> local SGD direction, stacked over the clients.

        g: minibatch gradients [C, ...]; drift: w^l - w_k [C, ...] (None
        unless ``uses_drift``);
        c_server [...] / c_client [C, ...]: SCAFFOLD control variates (None
        for the other modes, which ignore them).
        """
        return g

    # -- server half (Alg. 1 line 7) ----------------------------------------
    # ``axis_name`` is the client-axis group when the round runs on one
    # rank of a client-sharded world (tau_f/p/outs then hold only the
    # rank's clients and ``reduce`` is psum-wrapped); None on one device.
    def delta_from_normalized(self, G, tau_f, p, eta, reduce: Reduce, axis_name=None):
        """Global step from *normalized* client vectors G_i = cum_g_i/tau_i.

        This is the message-passing server's entry point: the wire carries
        G_i (Eq. 5), not raw accumulators.
        """
        raise NotImplementedError(
            f"mode {self.name!r} aggregates no normalized client vectors")

    def server_delta(self, outs, params, tau_f, p, eta, reduce: Reduce, axis_name=None):
        """Global step from the round's stacked outputs dict."""
        raise NotImplementedError

    def update_scaffold(self, outs, params, scaffold, tau_f, eta, axis_name=None):
        return scaffold


class FedVecaStrategy(Strategy):
    """Eq. 5: w' = w - eta * tau_k * sum_i p_i G_i (FedNova update rule,
    driven by the adaptive bi-directional tau controller)."""

    name = "fedveca"

    def delta_from_normalized(self, G, tau_f, p, eta, reduce, axis_name=None):
        tau_k = global_sum(p * tau_f, axis_name)
        delta_w, _ = reduce(G, p, -eta * tau_k)
        return delta_w

    def server_delta(self, outs, params, tau_f, p, eta, reduce, axis_name=None):
        tau_k = global_sum(p * tau_f, axis_name)
        # G_i = cum_g_i / tau_i, divided inside the reduce
        delta_w, _ = reduce(outs["cum_g"], p, -eta * tau_k, div=tau_f)
        return delta_w


class FedNovaStrategy(FedVecaStrategy):
    """Same aggregation algebra as FedVeca; tau is fixed, not adapted."""

    name = "fednova"


class FedAvgStrategy(Strategy):
    """Eq. 4: unnormalized sums, w' = w - eta * sum_i p_i sum_l g_i^l."""

    name = "fedavg"

    def delta_from_normalized(self, G, tau_f, p, eta, reduce, axis_name=None):
        cum_g = tree_map(lambda x: x * _per_client(tau_f, x), G)
        delta_w, _ = reduce(cum_g, p, -eta)
        return delta_w

    def server_delta(self, outs, params, tau_f, p, eta, reduce, axis_name=None):
        delta_w, _ = reduce(outs["cum_g"], p, -eta)
        return delta_w


class FedProxStrategy(FedAvgStrategy):
    """FedAvg aggregation + proximal local objective (mu/2)||w - w_k||^2."""

    name = "fedprox"
    uses_drift = True

    def __init__(self, mu: float = 0.0):
        self.mu = mu

    def local_direction(self, g, drift, c_server, c_client):
        return tree_axpy(self.mu, drift, g)


class ScaffoldStrategy(Strategy):
    """SCAFFOLD: variance-reduced local steps, parameter-delta averaging."""

    name = "scaffold"
    uses_scaffold = True

    def local_direction(self, g, drift, c_server, c_client):
        return tree_map(lambda gg, cs, ci: gg.float() + cs.float() - ci.float(),
                        g, c_server, c_client)

    def server_delta(self, outs, params, tau_f, p, eta, reduce, axis_name=None):
        local_delta = tree_map(lambda wc, w0: wc.float() - w0.float()[None],
                               outs["params"], params)
        delta_w, _ = reduce(local_delta, p, 1.0)
        return delta_w

    def update_scaffold(self, outs, params, scaffold, tau_f, eta, axis_name=None):
        # c_i' = c_i - c + (w_k - w_i^tau)/(tau_i * eta); c' = c + mean(dc)
        from repro_torch.core.fedveca import ScaffoldState

        C = tau_f.shape[0]
        C_total = global_sum(torch.ones_like(tau_f), axis_name)
        c_server, c_client = scaffold.c, scaffold.c_i
        inv = 1.0 / (tau_f * eta)
        c_i_new = tree_map(
            lambda ci, cs, wc, w0: (
                ci.float() - cs.float()[None]
                + (w0.float()[None] - wc.float()) * inv.reshape((C,) + (1,) * w0.dim())
            ).to(ci.dtype),
            c_client, c_server, outs["params"], params,
        )
        dc = tree_map(torch.sub, c_i_new, c_client)
        mean_dc = tree_weighted_sum(dc, torch.full((C,), 1.0, device=tau_f.device) / C_total)
        if axis_name is not None:
            mean_dc = all_reduce_tree(mean_dc, axis_name)
        return ScaffoldState(c=tree_axpy(1.0, mean_dc, c_server), c_i=c_i_new)


def get_strategy(mode: str, *, mu: float = 0.0) -> Strategy:
    if mode == "fedveca":
        return FedVecaStrategy()
    if mode == "fednova":
        return FedNovaStrategy()
    if mode == "fedavg":
        return FedAvgStrategy()
    if mode == "fedprox":
        return FedProxStrategy(mu)
    if mode == "scaffold":
        return ScaffoldStrategy()
    raise ValueError(f"unknown mode {mode!r}; valid: {MODES}")
