"""Plain PyTorch version of the RMSNorm kernel (port of
``repro/kernels/rmsnorm/ref.py``): per row of the last dim,
``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in float32, cast back to
``x.dtype``.

``groups`` is the port's one addition, for the op's ``vmap`` rule: with
``groups = G > 1``, ``x`` is ``[G, ..., d]`` and ``scale`` ``[G, d]``, and
group ``g``'s rows take ``scale[g]`` (G clients' norms in one call).
``groups = 1`` is the JAX function: ``x`` ``[..., d]``, ``scale`` ``[d]``.
"""
from __future__ import annotations

import torch


def group_scale(scale: torch.Tensor, groups: int, ndim: int) -> torch.Tensor:
    """``scale`` in float32, shaped to broadcast against an ``ndim``-dim x
    (``[G, 1, ..., 1, d]`` for ``groups > 1``)."""
    s = scale.float()
    if groups > 1:
        s = s.reshape((groups,) + (1,) * (ndim - 2) + (s.shape[-1],))
    return s


def rmsnorm(x, scale, eps: float = 1e-6, groups: int = 1):
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + group_scale(scale, groups, x.dim()))).to(dt)
