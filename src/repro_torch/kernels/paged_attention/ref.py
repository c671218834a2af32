"""Plain PyTorch versions of the two paged-attention kernels.

The same arithmetic as the JAX package's ``kernels/paged_attention/ref.py``
(scatter write of the new row, dense gather of each slot's pages, masked
full softmax), written for torch. ``ops.py`` takes these for tensors on the
CPU; the CPU tests hold them against the Pallas kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
``paged_decode_attention_split`` mirrors the CUDA decode kernel's split
walk and merge for the CPU tests only.

The decode and insert functions update the pools IN PLACE (the JAX versions return new
pools; torch has no buffer donation, so the port writes where it reads).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
DECODE_WARPS = 4  # warps of a CUDA decode block (csrc kDecodeWarps)


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


def write_target(page_table, pos, page_size: int, window: int, active):
    """The physical page of each slot's new row, and whether the row is
    written: active slots whose target page lies in the table and is
    allocated. An inactive slot may keep the stale ``pos`` of its last
    request, one past its last page (the kernel skips it the same way)."""
    P = page_table.shape[1]
    pos = pos.to(torch.int64)
    page = ((pos % window) if window else pos) // page_size
    phys = page_table.to(torch.int64).gather(1, page.clamp(max=P - 1)[:, None])[:, 0]
    return phys, (page < P) & (phys >= 0) & active.to(torch.bool)


def paged_decode_attention(q, k_pool, v_pool, k_new, v_new, page_table, pos,
                           active, *, window: int = 0):
    """q [B,Hq,hd], pools [N,ps,Hkv,hd], k_new/v_new [B,Hkv,hd], page_table
    [B,P] int, pos [B] int, active bool [B] -> o [B,Hq,hd] in q.dtype.

    Writes the new token's row into the pools (active slots whose target
    page is allocated), then attends over the slot's gathered pages."""
    write_new_rows(k_pool, v_pool, k_new, v_new, page_table, pos, active, window=window)
    return paged_attend(q, k_pool, v_pool, page_table, pos, window=window)


def write_new_rows(k_pool, v_pool, k_new, v_new, page_table, pos, active, *,
                   window: int = 0) -> None:
    """The decode's pool write, in place: each active slot's new K/V row at
    its position, where its target page is allocated."""
    ps = k_pool.shape[1]
    pos = pos.to(torch.int64)
    phys, ok = write_target(page_table.to(torch.int64), pos, ps, window, active)
    idx = (pos % window) if window else pos
    k_pool[phys[ok], idx[ok] % ps] = k_new[ok]
    v_pool[phys[ok], idx[ok] % ps] = v_new[ok]


def paged_attend(q, k_pool, v_pool, page_table, pos, *, window: int = 0):
    """The decode's attention of each slot's query heads over its gathered
    pages (the pools as they are) -> o [B,Hq,hd] in q.dtype."""
    B, Hq, hd = q.shape
    N, ps, Hkv, _ = k_pool.shape
    P = page_table.shape[1]
    G = Hq // Hkv
    pos = pos.to(torch.int64)
    page_table = page_table.to(torch.int64)

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


def paged_decode_attention_split(q, k_pool, v_pool, k_new, v_new, page_table, pos,
                                 active, *, window: int = 0, splits: int = 1):
    """The CUDA decode kernel's split-and-merge arithmetic in plain torch,
    float32 throughout, for the CPU tests (nothing on the card path calls
    it). Same arguments, result and pool writes as
    :func:`paged_decode_attention`.

    Worker (s, w) of a (slot, kv head) owns logical pages p = s + splits *
    (w + DECODE_WARPS * k) and keeps a softmax partial (m, l, o) over its valid
    entries: m = -1e30, l = 0, o = 0 if it has none. The warps of a split
    merge in warp order, then the splits in split order, each merge taking
    M = max m, c = exp(m - M), l = sum c l, o = sum c o; the output is
    o / max(l, 1e-30), so a slot with no live key gives 0."""
    B, Hq, hd = q.shape
    N, ps, Hkv, _ = k_pool.shape
    P = page_table.shape[1]
    G = Hq // Hkv
    pt = page_table.to(torch.int64)

    # the pool write, as paged_decode_attention does it
    pos64 = pos.to(torch.int64)
    phys, ok = write_target(pt, pos64, ps, window, active)
    idx = (pos64 % window) if window else pos64
    k_pool[phys[ok], idx[ok] % ps] = k_new[ok]
    v_pool[phys[ok], idx[ok] % ps] = v_new[ok]

    safe_pt = pt.clamp(min=0)
    k = k_pool[safe_pt].float()  # [B, P, ps, Hkv, hd]
    v = v_pool[safe_pt].float()
    valid = slot_valid(page_table, pos, ps, window).reshape(B, 1, 1, P, ps)
    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bpkhd->bhgpk", qg, k) * (1.0 / math.sqrt(hd))

    page = torch.arange(P, device=q.device)
    split_of, warp_of = page % splits, (page // splits) % DECODE_WARPS

    def partial(pages):
        live = valid & pages.reshape(1, 1, 1, P, 1)
        sm = torch.where(live, s, torch.full_like(s, NEG_INF))
        m = sm.amax(dim=(-2, -1))
        e = torch.where(live, torch.exp(sm - m[..., None, None]), torch.zeros_like(sm))
        return m, e.sum(dim=(-2, -1)), torch.einsum("bhgpk,bpkhd->bhgd", e, v)

    def merge(parts):
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        l = torch.zeros_like(M)
        o = torch.zeros_like(parts[0][2])
        for m, li, oi in parts:
            c = torch.exp(m - M)
            l = l + c * li
            o = o + c[..., None] * oi
        return M, l, o

    _, l, o = merge([merge([partial((split_of == si) & (warp_of == wi))
                            for wi in range(DECODE_WARPS)]) for si in range(splits)])
    o = o / l.clamp(min=1e-30)[..., None]
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
