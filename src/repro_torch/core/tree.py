"""Small tree math helpers of the federated core (port of
``repro/core/tree.py``), over flat dicts of tensors.

A "tree" here is a ``{keypath: tensor}`` dict (``repro_torch.bridge``'s
layout). Reductions over a tree walk its keys in sorted order, the order in
which ``jax.tree`` flattens a dict, so sums over leaves add up in the JAX
package's order. A "stacked" tree has a leading client axis ``[C, ...]`` on
every leaf.

Under a model axis (``model_axis``, a ``sharding.partition.ModelAxis``) a
rank holds pieces of the sharded leaves: the norms and dots sum those
leaves' partial values, complete them with one all-reduce over the model
group, and add the replicated leaves once (not once a rank).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.sharding.api import all_reduce

Tree = Dict[str, torch.Tensor]


def leaves(t: Tree):
    """The leaves in ``jax.tree`` order (sorted keys)."""
    return [t[k] for k in sorted(t)]


def tree_map(f: Callable, *ts: Tree) -> Tree:
    return {k: f(*(t[k] for t in ts)) for k in sorted(ts[0])}


def tree_zeros_like(t: Tree) -> Tree:
    return tree_map(torch.zeros_like, t)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: (x.float() * s).to(x.dtype), a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """y + alpha * x, computed in fp32 and cast back to y's dtypes."""
    return tree_map(lambda xi, yi: (yi.float() + alpha * xi.float()).to(yi.dtype), x, y)


def model_complete(part: Callable, keys, model_axis=None):
    """``sum(part(k) for k in keys)`` (sorted keys) over a tree partitioned
    on ``model_axis``: the sharded keys' partial sum all-reduced over the
    model group, plus the replicated keys' sum. Without a model axis, the
    plain sum."""
    keys = sorted(keys)
    if model_axis is None:
        return sum(part(k) for k in keys)
    sh = [k for k in keys if k in model_axis.sharded]
    rep = [k for k in keys if k not in model_axis.sharded]
    out = None
    if sh:
        out = all_reduce([sum(part(k) for k in sh)], model_axis.group)[0]
    if rep:
        r = sum(part(k) for k in rep)
        out = r if out is None else out + r
    return out


def tree_sqnorm(t: Tree, model_axis=None) -> torch.Tensor:
    """Sum of squares over every leaf, fp32 scalar."""
    return model_complete(lambda k: t[k].float().square().sum(), t, model_axis)


def tree_sqnorm_per_client(t: Tree, model_axis=None) -> torch.Tensor:
    """``tree_sqnorm`` of each client's row of a stacked tree -> [C] (the
    JAX package writes this ``jax.vmap(tree_sqnorm)``)."""
    return model_complete(
        lambda k: t[k].float().square().reshape(t[k].shape[0], -1).sum(1), t, model_axis)


def tree_norm(t: Tree, model_axis=None) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(t, model_axis))


def tree_dot(a: Tree, b: Tree, model_axis=None) -> torch.Tensor:
    return model_complete(lambda k: (a[k].float() * b[k].float()).sum(), a, model_axis)


def tree_weighted_sum(stacked: Tree, w: torch.Tensor) -> Tree:
    """stacked: leaves [C, ...]; w: [C] -> weighted sum over the client axis."""
    return tree_map(
        lambda x: torch.tensordot(w.float(), x.float(), dims=1).to(x.dtype), stacked)


def tree_select(pred, a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_cast(t: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), t)
