"""The paper's own models (§IV-A2), port of ``repro/models/simple.py``:
squared-SVM and the small CNN.

* squared-SVM: fully-connected layer, binary even/odd label, squared-hinge
  loss — convex + Lipschitz-smooth, satisfying Assumption 1.
* CNN (footnote 2): two 5x5x32 convs, two 2x2 maxpools, fc flat->256,
  fc ->10, softmax CE — non-convex.

Layouts are the JAX package's at every function here: activations NHWC,
conv weights HWIO ``(5, 5, c_in, 32)``, dense weights ``[in, out]``, so
params carried over with ``repro_torch.bridge`` need no change. Only
around ``F.conv2d`` / ``F.max_pool2d`` are tensors viewed as NCHW / OIHW,
and the flatten before ``fc1`` runs in NHWC order, as there.

All functions are written per batch and run under ``torch.func.vmap`` over
the client axis in the federated round.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def svm_init(gen: torch.Generator, cfg, device) -> Params:
    in_dim = math.prod(cfg.input_shape)
    return {
        "w": dense_init(gen, in_dim, 1, torch.float32, device, scale=0.01),
        "b": torch.zeros((1,), dtype=torch.float32, device=device),
    }


def svm_forward(cfg, p: Params, batch) -> torch.Tensor:
    x = batch["x"].reshape(batch["x"].shape[0], -1)
    return (x @ p["w"] + p["b"])[:, 0]  # margin score


def svm_loss(cfg, p: Params, batch):
    """Squared hinge: mean(max(0, 1 - y*f(x))^2) + L2. y in {-1, +1}."""
    s = svm_forward(cfg, p, batch)
    y = batch["y"].float() * 2.0 - 1.0  # {0,1} -> {-1,+1}
    hinge = torch.clamp_min(1.0 - y * s, 0.0)
    reg = 0.5 * 1e-4 * (p["w"].square().sum() + p["b"].square().sum())
    loss = hinge.square().mean() + reg
    acc = ((s > 0) == (y > 0)).float().mean()
    return loss, {"ce": loss, "acc": acc}


def cnn_init(gen: torch.Generator, cfg, device) -> Params:
    h, w, c = cfg.input_shape
    flat = (h // 4) * (w // 4) * 32  # two conv+pool halvings

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "conv1": normal((5, 5, c, 32), 1.0 / (5 * 5 * c) ** 0.5),
        "b1": zeros(32),
        "conv2": normal((5, 5, 32, 32), 1.0 / (5 * 5 * 32) ** 0.5),
        "b2": zeros(32),
        "fc1": dense_init(gen, flat, 256, torch.float32, device),
        "bf1": zeros(256),
        "fc2": dense_init(gen, 256, cfg.num_classes, torch.float32, device),
        "bf2": zeros(cfg.num_classes),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x NHWC, w HWIO -> relu(conv(x, w, SAME) + b), NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=((kh - 1) // 2, (kw - 1) // 2))
    return F.relu(y.permute(0, 2, 3, 1) + b)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def cnn_forward(cfg, p: Params, batch) -> torch.Tensor:
    x = batch["x"].reshape((-1,) + tuple(cfg.input_shape))
    x = _maxpool(_conv(x, p["conv1"], p["b1"]))
    x = _maxpool(_conv(x, p["conv2"], p["b2"]))
    x = x.reshape(x.shape[0], -1)  # NHWC order, as fc1 was laid out
    x = F.relu(x @ p["fc1"] + p["bf1"])
    return x @ p["fc2"] + p["bf2"]


def cnn_loss(cfg, p: Params, batch):
    logits = cnn_forward(cfg, p, batch)
    y = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, y[:, None])[:, 0]
    loss = (logz - ll).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, {"ce": loss, "acc": acc}
