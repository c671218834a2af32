"""Small tree math helpers of the federated core (port of
``repro/core/tree.py``), over flat dicts of tensors.

A "tree" here is a ``{keypath: tensor}`` dict (``repro_torch.bridge``'s
layout). Reductions over a tree walk its keys in sorted order, the order in
which ``jax.tree`` flattens a dict, so sums over leaves add up in the JAX
package's order. A "stacked" tree has a leading client axis ``[C, ...]`` on
every leaf.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

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


def tree_sqnorm(t: Tree) -> torch.Tensor:
    """Sum of squares over every leaf, fp32 scalar."""
    return sum(l.float().square().sum() for l in leaves(t))


def tree_sqnorm_per_client(t: Tree) -> torch.Tensor:
    """``tree_sqnorm`` of each client's row of a stacked tree -> [C] (the
    JAX package writes this ``jax.vmap(tree_sqnorm)``)."""
    return sum(l.float().square().reshape(l.shape[0], -1).sum(1) for l in leaves(t))


def tree_norm(t: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(t))


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    return sum((x.float() * y.float()).sum() for x, y in zip(leaves(a), leaves(b)))


def tree_weighted_sum(stacked: Tree, w: torch.Tensor) -> Tree:
    """stacked: leaves [C, ...]; w: [C] -> weighted sum over the client axis."""
    return tree_map(
        lambda x: torch.tensordot(w.float(), x.float(), dims=1).to(x.dtype), stacked)


def tree_select(pred, a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_cast(t: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), t)
