"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): GQA (KV head ``h // G``),
causal and sliding-window masks, ``q_offset``, Sq != Sk, float32 logits
and softmax, probabilities rounded to ``v.dtype`` before the PV product.

One deliberate difference from the JAX ``ref.attention``: a query row with
no live key returns zeros, as the Pallas kernel does (its final divide
clamps the row sum at 1e-30, ``kernel.py:69-70``), and not the uniform mean
of ``v`` that a softmax over an all-masked row gives. The CUDA kernel
follows the Pallas kernel, and this version must agree with it everywhere.
Rows with at least one live key are unchanged by this.

``attention_tf32x3`` mirrors the float32 CUDA kernel's arithmetic (three
TF32 products a product on the tensor cores) for the CPU tests; nothing on
the card's path calls it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def live_mask(Sq: int, Sk: int, *, causal: bool, window: int, q_offset: int, device):
    """bool [Sq, Sk]: query ``i`` (absolute position ``q_offset + i``) may
    attend to key ``j`` (position ``j``)."""
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = torch.arange(Sk, device=device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    m = live_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                  device=q.device)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(m, w, torch.zeros_like(w))  # empty rows: 0, as the kernel
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does: on the int32 bits,
    ``(bits + 0x1000) & ~0x1FFF``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """-> (big, small): big = tf32(x), small = tf32(x - big); big + small
    holds x to ~2^-22 of |x|."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _tf32_products(eq: str, a, b, products: int):
    """einsum ``eq`` of float32 a, b from TF32 parts: a_small b_big + a_big
    b_small + a_big b_big (products=3, the kernel's), or a_big b_big alone
    (products=1). Each product of two TF32 values is exact in float32."""
    ab, a_small = tf32_split(a)
    bb, b_small = tf32_split(b)
    out = torch.einsum(eq, ab, bb)
    if products == 3:
        out = torch.einsum(eq, a_small, bb) + torch.einsum(eq, ab, b_small) + out
    elif products != 1:
        raise ValueError(f"products must be 1 or 3, got {products}")
    return out


def attention_tf32x3(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                     pv_products: int = 3):
    """The float32 kernel's arithmetic in plain PyTorch: S = Q K^T from
    three TF32 products, P = exp(S scale - row max) unnormalised, P V from
    ``pv_products`` (3, or 1 to show what one product costs), divided by
    max(l, 1e-30) at the end (a row with no live key is 0). float32 in and
    out; sums run in einsum's order, not the kernel's."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    s = _tf32_products("bqhgd,bkhd->bhgqk", qg, k.float(), 3) * (1.0 / math.sqrt(hd))
    m = live_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = torch.where(m, s, torch.full_like(s, -math.inf))
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(NEG_INF))
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]  # [B, Sq, Hkv, G, 1]
    o = _tf32_products("bhgqk,bkhd->bqhgd", p, v.float(), pv_products) / l.clamp_min(1e-30)
    return o.reshape(B, Sq, Hq, hd)
