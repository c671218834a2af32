"""Optimizers on flat dicts of tensors (port of ``repro/optim/optimizers.py``).

The paper's local and global steps use plain SGD with a fixed eta (the
round in ``core/fedveca.py``); momentum and Adam serve the non-federated
trainer and extensions. Each update computes in float32 and casts back to
the parameter's dtype, and returns new tensors (nothing is updated in
place), as the JAX package's pytree transforms do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple]  # (grads, state, params) -> (new_params, state)


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return {k: (w.float() - lr * grads[k].float()).to(w.dtype)
                for k, w in params.items()}, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, state, params):
        m = {k: beta * state[k] + grads[k].float() for k in params}
        return {k: (w.float() - lr * m[k]).to(w.dtype) for k, w in params.items()}, m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = {k: b1 * state["m"][k] + (1 - b1) * grads[k].float() for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * grads[k].float().square() for k in params}
        tf = t.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** tf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** tf

        def upd(k, w):
            step = lr * (m[k] / bc1.to(w.device)) / (torch.sqrt(v[k] / bc2.to(w.device)) + eps)
            if weight_decay:
                step = step + lr * weight_decay * w.float()
            return (w.float() - step).to(w.dtype)

        return {k: upd(k, w) for k, w in params.items()}, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
