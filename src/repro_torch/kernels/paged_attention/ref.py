"""Plain PyTorch versions of the two paged-attention kernels.

The same arithmetic as the JAX package's ``kernels/paged_attention/ref.py``
(scatter write of the new row, dense gather of each slot's pages, masked
full softmax), written for torch. ``ops.py`` takes these for tensors on the
CPU; the CPU tests hold them against the Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Both functions update the pools IN PLACE (the JAX versions return new
pools; torch has no buffer donation, so the port writes where it reads).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def slot_valid(page_table, pos, page_size: int, window: int):
    """page_table [B, P] (-1 = unallocated), pos [B] -> bool [B, P*ps].

    Full attention: entry ``i`` holds position ``i``; valid iff ``i <= pos``
    and its page is allocated. SWA ring of modulus ``window``: entry
    ``i < W`` holds ``pos - ((pos - i) mod W)`` (a floor modulo: torch's
    ``%`` on tensors is one, ``torch.fmod`` is not); valid iff that is >= 0.
    """
    B, P = page_table.shape
    i = torch.arange(P * page_size, dtype=torch.int32,
                     device=page_table.device)[None, :]
    alloc = (page_table >= 0).repeat_interleave(page_size, dim=1)
    posb = pos.to(torch.int32)[:, None]
    if window:
        p_i = posb - ((posb - i) % window)
        return alloc & (i < window) & (p_i >= 0)
    return alloc & (i <= posb)


def paged_decode_attention(q, k_pool, v_pool, k_new, v_new, page_table, pos,
                           active, *, window: int = 0):
    """q [B,Hq,hd], pools [N,ps,Hkv,hd], k_new/v_new [B,Hkv,hd], page_table
    [B,P] int, pos [B] int, active bool [B] -> o [B,Hq,hd] in q.dtype.

    Writes the new token's row into the pools (active slots whose target
    page is allocated), then attends over the slot's gathered pages."""
    B, Hq, hd = q.shape
    N, ps, Hkv, _ = k_pool.shape
    P = page_table.shape[1]
    G = Hq // Hkv
    pos = pos.to(torch.int64)
    page_table = page_table.to(torch.int64)

    idx = (pos % window) if window else pos
    phys = page_table.gather(1, (idx // ps)[:, None])[:, 0]
    ok = (phys >= 0) & active.to(torch.bool)
    k_pool[phys[ok], idx[ok] % ps] = k_new[ok]
    v_pool[phys[ok], idx[ok] % ps] = v_new[ok]

    safe_pt = page_table.clamp(min=0)
    k = k_pool[safe_pt].reshape(B, P * ps, Hkv, hd)
    v = v_pool[safe_pt].reshape(B, P * ps, Hkv, hd)
    valid = slot_valid(page_table, pos, ps, window)[:, None, None, :]

    qg = q.reshape(B, Hkv, G, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhgk,bkhd->bhgd", w.to(v.dtype), v)
    return o.reshape(B, Hq, hd).to(q.dtype)


def paged_insert(k_pool, v_pool, k_src, v_src, page_ids):
    """Layer-stacked prefill-into-pages copy: pools [L,N,ps,Hkv,hd], src
    [L,P,ps,Hkv,hd], page_ids [P] (-1 = unallocated, skipped). Allocated
    pages are overwritten in full with the source rows; the rest keep
    their bytes."""
    ids = page_ids.to(torch.int64)
    ok = ids >= 0
    k_pool[:, ids[ok]] = k_src[:, ok]
    v_pool[:, ids[ok]] = v_src[:, ok]
