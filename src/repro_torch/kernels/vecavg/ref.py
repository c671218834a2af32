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


def vecavg_tree(grads_stacked, p, scale, div=None):
    """Plain tree form: leaves [C, ...] -> (delta_w dict, sqnorms [C]).

    With ``div`` [C], each leaf is divided first, ``x / div[c]`` as the JAX
    package's ``tree_map(lambda x: x / tau, cum_g)`` does (the quotient
    takes the promoted dtype). Then every leaf, in ``jax.tree`` order
    (sorted keys), is flattened and concatenated into one float32 [C, D]
    matrix, reduced by :func:`vecavg`, split back and cast to its leaf's
    dtype, as ``repro/kernels/vecavg/ops.py`` ``vecavg_tree`` does.
    """
    keys = sorted(grads_stacked)
    tree = {k: grads_stacked[k] for k in keys}
    if div is not None:
        tree = {k: x / div.reshape((-1,) + (1,) * (x.dim() - 1)) for k, x in tree.items()}
    C = tree[keys[0]].shape[0]
    flat = [tree[k].reshape(C, -1).float() for k in keys]
    mat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    dw, sqn = vecavg(mat, p, scale)
    outs, off = {}, 0
    for k, f in zip(keys, flat):
        w = f.shape[1]
        outs[k] = dw[off:off + w].reshape(tree[k].shape[1:]).to(tree[k].dtype)
        off += w
    return outs, sqn
