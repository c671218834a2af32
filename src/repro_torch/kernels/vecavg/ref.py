"""Plain PyTorch version of the vectorized-averaging kernel (port of
``repro/kernels/vecavg/ref.py``)."""
from __future__ import annotations

import torch


def vecavg(u, p, scale):
    """u [C, D] step-size-normalized client gradients; p [C]; scale scalar
    (eta * tau_k). Returns (delta_w [D], client_sqnorms [C]).

    delta_w = -scale * sum_c p_c * u[c]        (paper Eq. 5 global step)
    sqnorms = per-client ||u_c||^2 (feeds the beta/delta estimators)
    """
    uf = u.float()
    delta = -scale * torch.einsum("c,cd->d", p.float(), uf)
    sqn = uf.square().sum(-1)
    return delta.to(u.dtype), sqn
