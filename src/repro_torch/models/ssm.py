"""Mamba-style selective SSM block, the SSM half of Hymba's hybrid heads
(port of ``repro/models/ssm.py``).

The selective scan runs step by step over time in float32, as the JAX
package's (which scans chunks of 16 steps; its zero-padded tail steps
have a zero step size and leave the state as it is, so the final state
is the same). The per-step decay ``exp(dt * A)`` and input ``dt * u * B``
are formed for all steps at once and the loop carries only the state.
The JAX package has no Pallas kernel here.

Under a model axis that splits the SSM (``sharding/partition.py``) a rank
runs its ``d_in / m`` channels: ``w_in``'s x and gate halves are
column-parallel behind ``copy_in``, the conv, the gate and the scan are
local to the channels, ``u @ w_bc`` and ``u @ w_dt`` (shared by every
channel) are partial sums completed with ONE ``reduce_out`` of their
concatenation before the scan (``copy_in`` after it: the channels' uses
of them are partial too, so their gradient sums over the ranks), and
``w_out`` is row-parallel followed by ``reduce_out``. The state holds the
rank's channels. No collective runs inside the step loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import Params, dense_init, tp, wmatmul
from repro_torch.sharding import api


class SSMState(NamedTuple):
    h: torch.Tensor  # [B, d_in, N] float32
    conv: torch.Tensor  # [B, K-1, d_in] the last inputs of the causal depthwise conv


def ssm_init(gen, cfg, d: int, dtype, device, lead=()) -> Params:
    d_in, N = cfg.ssm_expand * d, cfg.ssm_state
    lead = tuple(lead)

    def f32(t):
        return t.to(device=device, dtype=torch.float32).expand(lead + t.shape).clone()

    return {
        "w_in": dense_init(gen, d, 2 * d_in, dtype, device, lead=lead),  # x and gate
        "w_out": dense_init(gen, d_in, d, dtype, device, lead=lead),
        "conv_w": dense_init(gen, cfg.ssm_conv, d_in, dtype, device, scale=0.1, lead=lead),
        "w_bc": dense_init(gen, d_in, 2 * N, dtype, device, lead=lead),
        "w_dt": dense_init(gen, d_in, 1, dtype, device, lead=lead),
        "dt_bias": f32(torch.zeros(d_in)),
        "A_log": f32(torch.log(torch.arange(1, N + 1, dtype=torch.float32))[None, :]
                     .repeat(d_in, 1)),
        "D": f32(torch.ones(d_in)),
    }


def _causal_conv(x, w, init_carry=None):
    """x [B, S, d_in], depthwise causal conv of kernel K = len(w) -> (y, the
    last K-1 inputs). The carry starts at zero."""
    K, S = w.shape[0], x.shape[1]
    if init_carry is None:
        init_carry = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    xp = torch.cat([init_carry, x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, xp.shape[1] - (K - 1):]


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) for every x (``F.softplus`` switches
    to x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_scan(p: Params, u, h0, split: bool = False):
    """Selective scan. u [B, S, d_in] (after conv and activation) -> (y
    float32, final state [B, d_in, N]); ``split``: ``u`` holds the rank's
    channels and the shared projections complete over the model axis."""
    A = -torch.exp(p["A_log"].float())  # [d_in, N]
    N = A.shape[-1]
    proj = torch.cat([wmatmul(u, p["w_bc"]), wmatmul(u, p["w_dt"])], dim=-1)  # [B, S, 2N + 1]
    if split:
        proj = api.copy_in(api.reduce_out(proj))
    bm, cm, dt = proj.float().split([N, N, 1], dim=-1)  # [B, S, N] each and [B, S, 1]
    # per-channel step: a scalar projection plus a per-channel bias
    dt = softplus(dt + p["dt_bias"])  # [B, S, d_in]
    uf = u.float()
    decay = torch.exp(dt[..., None] * A)  # [B, S, d_in, N]
    inp = (dt * uf)[..., None] * bm[:, :, None, :]
    h, ys = h0.float(), []
    for t in range(u.shape[1]):
        h = decay[:, t] * h + inp[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, dim=1) + uf * p["D"], h


def ssm_apply(cfg, p: Params, x, state: SSMState | None = None):
    """x [B, S, d] -> (y [B, S, d], new state). ``p`` holds one layer's
    ``ssm/*`` leaves without the prefix (the rank's channels under a model
    axis that splits the SSM)."""
    B = x.shape[0]
    split = tp(cfg).ssm
    u, z = wmatmul(api.copy_in(x) if split else x, p["w_in"]).chunk(2, dim=-1)  # [B, S, d_in]
    u, conv = _causal_conv(u, p["conv_w"], None if state is None else state.conv)
    u = F.silu(u)
    h0 = (state.h if state is not None else
          torch.zeros((B, u.shape[-1], cfg.ssm_state), dtype=torch.float32, device=x.device))
    y, h = _ssm_scan(p, u, h0, split)
    y = wmatmul(y.to(x.dtype) * F.silu(z), p["w_out"])
    return (api.reduce_out(y) if split else y), SSMState(h=h, conv=conv)


def init_ssm_state(cfg, batch: int, d: int, dtype=torch.float32, device=None,
                   channels=None) -> SSMState:
    """Zero state on ``device`` (default ``cuda``) of ``channels`` channels
    (default ``d_in``; a rank's share under a model axis)."""
    d_in = channels or cfg.ssm_expand * d
    device = resolve_device(device)
    return SSMState(
        h=torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype, device=device))
