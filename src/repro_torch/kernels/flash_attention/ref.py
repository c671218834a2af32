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
