"""Mixture-of-Experts block (port of ``repro/models/moe.py``): top-k routing
with sort-based capacity dispatch.

The JAX package's semantics: the router runs in float32 (never TF32: a
TF32 router picks other experts), the GShard load-balance aux loss, the
capacity from the REAL expert count (Python's ``round``), pad experts
(``num_experts_pad``) that get -1e30 logits and are never routed, dropped
tokens that pass through the residual only, and under ``token_mask``
masked tokens sorted behind live ones within each expert (a stable sort
on the key ``e * 2 + (1 - live)``).

Written for ``torch.func`` (the round vmaps its gradient over clients):
no in-place writes and no data-dependent shapes. Bucket placement is an
out-of-place ``index_add``: each bucket row takes one kept token, and a
dropped token adds a zero row to slot 0 of its expert, which leaves the
row as it was (a plain ``index_put`` would let that zero overwrite the
kept token). The combine gathers each token's k contributions back to
``[T, k, d]`` and sums over k, with no scatter, so two runs on the card
give the same bits (the JAX package's ``y.at[t_s].add`` would be
``index_add_`` with atomics there). The expert products are batched
matmuls, as the JAX package's einsums are; it has no Pallas kernel for
them.

Under a model axis (``sharding/partition.py``) the router stays
replicated, so ``dispatch`` runs identically on every rank and capacity
and ``keep`` agree; the rank runs only its experts (E split) or its slice
of every expert's hidden dim (``moe_d_ff`` split); the experts' input and
their gates enter through ``copy_in`` and the combine sums the rank's
part, then ``reduce_out``. The shared experts go through ``mlp_apply``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Params, dense_init, gelu, mlp_apply, mlp_init, tp,
                                       wmatmul)
from repro_torch.sharding import api


def moe_init(gen, cfg, d: int, dtype, device, lead=()) -> Params:
    """``router`` [d, E_real] float32 (scale 0.02), the experts' stacked
    ``w_gate``/``w_up`` [E, d, f] and ``w_down`` [E, f, d] (E counts the pad
    experts), and the shared experts as one MLP of width
    ``num_shared_experts * f`` under ``shared/``."""
    E, f = cfg.num_experts + cfg.num_experts_pad, cfg.moe_d_ff
    lead = tuple(lead)
    p: Params = {"router": dense_init(gen, d, cfg.num_experts, torch.float32, device,
                                      scale=0.02, lead=lead)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dtype, device, lead=lead + (E,))
    p["w_up"] = dense_init(gen, d, f, dtype, device, lead=lead + (E,))
    p["w_down"] = dense_init(gen, f, d, dtype, device, lead=lead + (E,))
    if cfg.num_shared_experts:
        shared = mlp_init(gen, cfg, d, cfg.num_shared_experts * f, dtype, device, lead)
        p.update({f"shared/{k}": v for k, v in shared.items()})
    return p


def _router_logits(xf, router):
    """``xf.float() @ router`` in full float32 whatever the process's matmul
    precision."""
    prec = torch.get_float32_matmul_precision()
    if prec == "highest":
        return wmatmul(xf.float(), router)
    torch.set_float32_matmul_precision("highest")
    try:
        return wmatmul(xf.float(), router)
    finally:
        torch.set_float32_matmul_precision(prec)


class Dispatch(NamedTuple):
    """One MoE call's routing. Token order: ``[T, k]``; sorted order
    (stable by expert, live before masked): ``[T * k]``."""

    probs: torch.Tensor  # [T, E] router softmax (pad experts 0)
    expert_idx: torch.Tensor  # [T, k] int64
    keep: torch.Tensor  # [T, k] bool: within capacity (and live)
    keep_s: torch.Tensor  # [T*k] the same in sorted order
    e_s: torch.Tensor  # [T*k] expert of each sorted entry
    pos_c: torch.Tensor  # [T*k] its bucket row (0 where dropped)
    t_s: torch.Tensor  # [T*k] its token
    w_s: torch.Tensor  # [T*k] float32 gate * keep
    inv: torch.Tensor  # [T*k] sorted position of each (token, slot)
    counts: torch.Tensor  # [E] entries routed to each expert
    cap: int


def dispatch(cfg, p: Params, xf, token_mask=None) -> Dispatch:
    """Routing and capacity for ``xf`` [T, d] (``moe.py:75-110`` of the JAX
    package)."""
    T = xf.shape[0]
    E = cfg.num_experts + cfg.num_experts_pad
    k = cfg.experts_per_token
    logits = _router_logits(xf, p["router"])
    if cfg.num_experts_pad:
        logits = F.pad(logits, (0, cfg.num_experts_pad), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = int(max(1, round(k * T / cfg.num_experts * cfg.capacity_factor)))
    e_flat = expert_idx.reshape(-1)
    slots = torch.arange(T * k, device=xf.device)
    t_flat = slots // k
    if token_mask is not None:
        live_k = token_mask.reshape(T).repeat_interleave(k)
        order = torch.argsort(e_flat * 2 + (1 - live_k.long()), stable=True)
    else:
        order = torch.argsort(e_flat, stable=True)
    e_s, t_s, g_s = e_flat[order], t_flat[order], gate_vals.reshape(-1)[order]
    counts = (e_flat[:, None] == torch.arange(E, device=xf.device)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos_s = slots - starts[e_s]
    keep = pos_s < cap
    if token_mask is not None:
        keep = keep & live_k[order]
    inv = torch.argsort(order)
    return Dispatch(probs=probs, expert_idx=expert_idx, keep=keep[inv].reshape(T, k),
                    keep_s=keep, e_s=e_s, pos_c=torch.where(keep, pos_s, 0), t_s=t_s,
                    w_s=g_s * keep, inv=inv, counts=counts, cap=cap)


def _expert_ffn(cfg, p: Params, xb):
    """xb [E, C, d] -> [E, C, d] through each expert's own matrices."""
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.matmul(xb, p["w_gate"])) * torch.matmul(xb, p["w_up"])
    else:
        h = gelu(torch.matmul(xb, p["w_up"]))
    return torch.matmul(h, p["w_down"])


def moe_apply(cfg, p: Params, x, token_mask=None):
    """x [B, S, d] -> (y [B, S, d], aux loss scalar). ``p`` holds one
    layer's ``moe/*`` leaves without the prefix. ``token_mask``: optional
    bool [B, S]; masked tokens never take a bucket row from a live one
    (the capacity still counts every token, as in the JAX package)."""
    B, S, d = x.shape
    T = B * S
    E = cfg.num_experts + cfg.num_experts_pad
    k = cfg.experts_per_token
    xf = x.reshape(T, d)
    r = dispatch(cfg, p, xf, token_mask)

    # GShard load balance: E * sum_e f_e * P_e
    me = r.probs.mean(0)
    ce = r.counts.float() / (T * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss

    lay = tp(cfg)
    xe, w_s = xf, r.w_s
    if lay.experts is not None:  # partial expert outputs: the inputs' grads sum
        xe, w_s = api.copy_in(xf), api.copy_in(w_s)
    rows = r.e_s * r.cap + r.pos_c
    vals = torch.where(r.keep_s[:, None], xe[r.t_s], torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
    buckets = xe.new_zeros((E * r.cap, d)).index_add(0, rows, vals).reshape(E, r.cap, d)
    if lay.experts == "experts":  # this rank's experts; the others' rows give 0
        n = lay.experts_local
        lo = api.model_rank() * n
        out_l = _expert_ffn(cfg, p, buckets[lo:lo + n])
        out_b = torch.cat([out_l.new_zeros((lo, r.cap, d)), out_l,
                           out_l.new_zeros((E - lo - n, r.cap, d))])
    else:
        out_b = _expert_ffn(cfg, p, buckets)
    out_b = out_b.reshape(E * r.cap, d)

    contrib = out_b[rows] * w_s[:, None].to(x.dtype)
    y = contrib[r.inv].reshape(T, k, d).sum(1)
    if lay.experts is not None:
        y = api.reduce_out(y)
    if "shared/w_down" in p:
        y = y + mlp_apply(cfg, p, xf, prefix="shared")
    return y.reshape(B, S, d), aux
