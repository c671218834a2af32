"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM (port
of ``repro/models/xlstm.py``).

Both are recurrences over time with stabilized exponential gating (a
running max-state ``m``), run step by step in float32 as the JAX package's
``lax.scan`` runs them. The mLSTM head dim is ``d_in / H`` (1024 at
xlstm-1.3b's width, not ``cfg.head_dim``), so its matrix memory C is
``[B, H, d_in/H, d_in/H]`` float32. The JAX package has no Pallas kernel
here.

Under a model axis that splits the blocks (H % m == 0,
``sharding/partition.py``) a rank runs its H/m heads (hd contiguous in
every feature dim): mLSTM's ``w_up`` halves (x, output gate) are
column-parallel behind ``copy_in``; q/k/v and the gates need the whole
``xi``, which is gathered ONCE (``gather_last``, then ``copy_in``: the
rank's heads use all of it, so its gradient sums over the ranks) before
the column-parallel ``w_q/w_k/w_v`` and ``w_if``/``b_if`` (input and
forget gates of the rank's heads); sLSTM's ``w_x``/``b`` and ``w_r`` hold
the rank's heads. Both ``w_down`` are row-parallel followed by
``reduce_out``. The states hold the rank's heads; no collective runs
inside the step loops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import Params, dense_init, tp, wmatmul
from repro_torch.sharding import api


class MLSTMState(NamedTuple):
    C: torch.Tensor  # [B, H, hd, hd] matrix memory
    n: torch.Tensor  # [B, H, hd] normalizer
    m: torch.Tensor  # [B, H] max-state (gate stabilizer)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, hd]
    n: torch.Tensor  # [B, H, hd]
    h: torch.Tensor  # [B, H, hd]
    m: torch.Tensor  # [B, H]


def mlstm_init(gen, cfg, d: int, dtype, device, lead=()) -> Params:
    d_in, H = int(cfg.xlstm_proj_factor * d), cfg.num_heads
    lead = tuple(lead)
    b_if = torch.cat([torch.zeros(H), torch.full((H,), 3.0)]).to(device)
    return {
        "w_up": dense_init(gen, d, 2 * d_in, dtype, device, lead=lead),  # x and output gate
        "w_q": dense_init(gen, d_in, d_in, dtype, device, lead=lead),
        "w_k": dense_init(gen, d_in, d_in, dtype, device, lead=lead),
        "w_v": dense_init(gen, d_in, d_in, dtype, device, lead=lead),
        "w_if": dense_init(gen, d_in, 2 * H, torch.float32, device, scale=0.01, lead=lead),
        "b_if": b_if.expand(lead + b_if.shape).clone(),
        "w_down": dense_init(gen, d_in, d, dtype, device, lead=lead),
    }


def init_mlstm_state(cfg, batch: int, d: int, device=None, heads=None) -> MLSTMState:
    """Zero state on ``device`` (default ``cuda``) of ``heads`` heads
    (default H; a rank's share under a model axis)."""
    H = heads or cfg.num_heads
    hd = int(cfg.xlstm_proj_factor * d) // cfg.num_heads
    z = dict(dtype=torch.float32, device=resolve_device(device))
    return MLSTMState(C=torch.zeros((batch, H, hd, hd), **z),
                      n=torch.zeros((batch, H, hd), **z),
                      m=torch.zeros((batch, H), **z))


def mlstm_apply(cfg, p: Params, x, state: MLSTMState | None = None):
    """x [B, S, d] -> (y [B, S, d], state). ``p`` holds one mLSTM block's
    leaves without a prefix."""
    B, S, d = x.shape
    lay = tp(cfg)
    split, H = lay.xlstm, lay.xlstm_heads
    hd = int(cfg.xlstm_proj_factor * d) // cfg.num_heads
    xi, og = wmatmul(api.copy_in(x) if split else x, p["w_up"]).chunk(2, dim=-1)
    og = torch.sigmoid(og)
    xa = api.copy_in(api.gather_last(xi)) if split else xi  # the whole xi
    q = wmatmul(xa, p["w_q"]).reshape(B, S, H, hd).float()
    k = (wmatmul(xa, p["w_k"]).reshape(B, S, H, hd) / (hd ** 0.5)).float()
    v = wmatmul(xa, p["w_v"]).reshape(B, S, H, hd)
    ig, fg = (wmatmul(xa.float(), p["w_if"]) + p["b_if"]).chunk(2, dim=-1)  # [B, S, H] log-space
    if state is None:
        state = init_mlstm_state(cfg, B, d, device=x.device, heads=H)
    C, n, m = state
    hs = []
    for t in range(S):
        logf = F.logsigmoid(fg[:, t])
        m_new = torch.maximum(logf + m, ig[:, t])
        fs = torch.exp(logf + m - m_new)[..., None]  # [B, H, 1]
        is_ = torch.exp(ig[:, t] - m_new)[..., None]
        kt, qt = k[:, t], q[:, t]
        C = fs[..., None] * C + (is_ * v[:, t])[..., :, None] * kt[..., None, :]
        n = fs * n + is_ * kt
        num = torch.einsum("bhij,bhj->bhi", C, qt)
        den = torch.abs(torch.einsum("bhj,bhj->bh", n, qt))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    y = wmatmul(h * og, p["w_down"])
    return (api.reduce_out(y) if split else y), MLSTMState(C, n, m)


def slstm_init(gen, cfg, d: int, dtype, device, lead=()) -> Params:
    H = cfg.num_heads
    hd = d // H
    lead = tuple(lead)
    return {
        "w_x": dense_init(gen, d, 4 * d, dtype, device, lead=lead),  # gates i, f, z, o
        # block-diagonal recurrent weights, one [hd, 4 hd] block a head
        "w_r": dense_init(gen, hd, 4 * hd, dtype, device, scale=1.0 / hd ** 0.5,
                          lead=lead + (H,)),
        "b": torch.zeros(lead + (4 * d,), dtype=torch.float32, device=device),
        "w_down": dense_init(gen, d, d, dtype, device, lead=lead),
    }


def init_slstm_state(cfg, batch: int, d: int, device=None, heads=None) -> SLSTMState:
    """Zero state (n at 1e-6) on ``device`` (default ``cuda``) of ``heads``
    heads (default H; a rank's share under a model axis)."""
    H = heads or cfg.num_heads
    device = resolve_device(device)
    z = torch.zeros((batch, H, d // cfg.num_heads), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z + 1e-6, h=z,
                      m=torch.zeros((batch, H), dtype=torch.float32, device=device))


def slstm_apply(cfg, p: Params, x, state: SLSTMState | None = None):
    """x [B, S, d] -> (y [B, S, d], state). ``p`` holds one sLSTM block's
    leaves without a prefix."""
    B, S, d = x.shape
    lay = tp(cfg)
    split, H = lay.xlstm, lay.xlstm_heads
    hd = d // cfg.num_heads
    if state is None:
        state = init_slstm_state(cfg, B, d, device=x.device, heads=H)
    xg = (wmatmul(api.copy_in(x) if split else x, p["w_x"]).float() + p["b"]).reshape(
        B, S, H, 4 * hd)
    w_r = p["w_r"]
    c, n, h, m = state
    hs = []
    for t in range(S):
        rec = torch.einsum("bhj,hjk->bhk", h.to(w_r.dtype), w_r).float()
        it, ft, zt, ot = (xg[:, t] + rec).chunk(4, dim=-1)
        # one stabilized gate a head: the mean of its hd pre-activations
        il = it.mean(-1)
        fl = F.logsigmoid(ft.mean(-1))
        m_new = torch.maximum(fl + m, il)
        i_ = torch.exp(il - m_new)[..., None]
        f_ = torch.exp(fl + m - m_new)[..., None]
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        h = torch.sigmoid(ot) * (c / torch.clamp_min(n, 1e-6))
        m = m_new
        hs.append(h)
    y = wmatmul(torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype), p["w_down"])
    return (api.reduce_out(y) if split else y), SLSTMState(c, n, h, m)
