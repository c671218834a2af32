"""GQA attention (port of ``repro/models/attention.py``).

Full-sequence attention (forward, loss, prefill) has the JAX package's
paths: the direct masked softmax written out as matmuls, the chunked
online softmax over KV blocks, and ``impl="pallas"``, which runs
``kernels/flash_attention`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors). ``"auto"`` is direct up to S = 2048 and chunked
above, as there. Decode runs against the shared KV page pool through
``kernels/paged_attention``: ``cache_update="kernel"`` dispatches the CUDA
kernel for CUDA tensors (its plain version for CPU tensors); ``"scatter"``
and ``"mask"`` always run the plain versions and differ only in how the
new rows reach the pool (an indexed write, or the JAX package's one-hot
selector and ``where`` over the whole pool; the same bits). Chunked
prefill straight into the pool (``paged_prefill_attention_block``) is
plain torch, as its attention is plain jnp in the JAX package. So is
decode against the contiguous cache (``decode_attention_block``: rows of
``W`` slots, a ring under SWA), which no TPU kernel touches either: there
``"mask"`` writes through the one-hot selector and every other value,
``"kernel"`` included, through an indexed write, as in the JAX package
(ROADMAP.md P8).

Under a model axis that splits attention (Hq and Hkv both divide its
extent m; ``sharding/partition.py``) every path runs on the rank's
Hq/m query heads and Hkv/m kv heads, so G is unchanged: q/k/v (and their
biases) are column-parallel behind ``copy_in``, ``w_o`` row-parallel
followed by ``reduce_out``, and caches and pools hold the local kv heads.
Otherwise every rank computes every head.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models.layers import Params, apply_rope, dense_init, tp, wmatmul
from repro_torch.sharding import api

NEG_INF = -1e30


def attn_init(gen, cfg, d: int, dtype, device, lead=()) -> Params:
    p = {
        "w_q": dense_init(gen, d, cfg.q_dim, dtype, device, lead=lead),
        "w_k": dense_init(gen, d, cfg.kv_dim, dtype, device, lead=lead),
        "w_v": dense_init(gen, d, cfg.kv_dim, dtype, device, lead=lead),
        "w_o": dense_init(gen, cfg.q_dim, d, dtype, device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", cfg.q_dim), ("b_k", cfg.kv_dim), ("b_v", cfg.kv_dim)):
            p[name] = torch.zeros(tuple(lead) + (n,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg, p: Params, x, positions, rope: bool):
    """``p`` holds one layer's ``attn/*`` leaves. x [B,S,d] -> q [B,S,Hq,hd],
    k/v [B,S,Hkv,hd] (the rank's heads under a model axis that splits
    attention)."""
    B, S, _ = x.shape
    lay = tp(cfg)
    if lay.attn:
        x = api.copy_in(x)
    q = wmatmul(x, p["attn/w_q"])
    k = wmatmul(x, p["attn/w_k"])
    v = wmatmul(x, p["attn/w_v"])
    if "attn/b_q" in p:
        q, k, v = q + p["attn/b_q"], k + p["attn/b_k"], v + p["attn/b_v"]
    q = q.reshape(B, S, lay.heads, cfg.head_dim)
    k = k.reshape(B, S, lay.kv_heads, cfg.head_dim)
    v = v.reshape(B, S, lay.kv_heads, cfg.head_dim)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(cfg, p: Params, o):
    """o [..., heads, hd] -> [..., d]: the rows of ``w_o`` the rank holds,
    the partial sums reduced over the model axis when attention is split."""
    y = wmatmul(o.flatten(-2), p["attn/w_o"])
    return api.reduce_out(y) if tp(cfg).attn else y


def _mask(q_pos, k_pos, causal: bool, window: int):
    """q_pos [Sq], k_pos [Sk] -> bool [Sq, Sk] (True = attend)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _direct_attention(q, k, v, q_pos, k_pos, causal, window):
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]; float32 softmax."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    m = _mask(q_pos, k_pos, causal, window)[None, None, None]
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, Hq, hd)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, window, q_block=512, k_block=1024):
    """Online-softmax attention over KV blocks of ``k_block`` keys, every q
    block of ``q_block`` rows at once (the JAX package vmaps them);
    O(Sq * k_block) logits in memory. Padded keys sit at position 2**30 and
    padded queries at -1, as there."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    nq, nk = -(-Sq // q_block), -(-Sk // k_block)
    pad_q, pad_k = nq * q_block - Sq, nk * k_block - Sk
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    qpos = F.pad(q_pos, (0, pad_q), value=-1)
    kposb = F.pad(k_pos, (0, pad_k), value=2**30).reshape(nk, k_block)
    qb = qp.reshape(B, nq, q_block, Hkv, G, hd)
    kb = kp.reshape(B, nk, k_block, Hkv, hd)
    vb = vp.reshape(B, nk, k_block, Hkv, hd)
    acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(qb.shape[:-1], dtype=torch.float32, device=q.device)
    for j in range(nk):
        kj, vj, kpos_j = kb[:, j], vb[:, j], kposb[j]
        logit = torch.einsum("bnqhgd,bkhd->bnqhgk", qb, kj).float() * scale
        msk = _mask(qpos, kpos_j, causal, window) & (kpos_j < 2**30)[None, :]
        msk = msk.reshape(nq, q_block, k_block)
        logit = torch.where(msk[None, :, :, None, None, :], logit,
                            torch.full_like(logit, NEG_INF))
        m_new = torch.maximum(m, logit.amax(-1))
        p = torch.exp(logit - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnqhgk,bkhd->bnqhgd", p.to(vj.dtype), vj).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, nq * q_block, Hq, hd)[:, :Sq].to(q.dtype)


ATTENTION_IMPLS = ("auto", "direct", "chunked", "pallas")


def attention_block(cfg, p: Params, x, positions, *, window: Optional[int] = None,
                    causal: bool = True, impl: str = "auto"):
    """Full-sequence attention sub-block (forward, loss, prefill). x [B,S,d].
    ``window=None`` applies the config's sliding window. ``impl``: "direct",
    "chunked", "pallas" (``kernels/flash_attention``: the CUDA kernel for
    CUDA tensors, forward only), or "auto" (direct for S <= 2048, chunked
    above, as in the JAX package)."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl={impl!r}; expected one of {ATTENTION_IMPLS}")
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, cfg.rope)
    win = cfg.sliding_window if window is None else window
    if impl == "pallas":
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=win)
    elif impl == "direct" or (impl == "auto" and S <= 2048):
        o = _direct_attention(q, k, v, positions, positions, causal, win)
    else:
        o = _chunked_attention(q, k, v, positions, positions, causal, win)
    return _out_proj(cfg, p, o)


# ---------------------------------------------------------------------------
# prefill KV cache (batch rows of W slots, or a ring of `window` slots)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, W, Hkv, hd]
    v: torch.Tensor  # [B, W, Hkv, hd]
    pos: torch.Tensor  # [B, W] absolute position of each slot, -1 = empty


def prefill_kv_cache(cfg, p: Params, x, positions, *, window: int = 0,
                     pad_to: int = 0) -> KVCache:
    """K/V of a whole prompt laid into a cache: capacity max(pad_to, S) for
    full attention, a ring of ``window`` slots (slot = pos % W) for SWA."""
    _, k, v = _project_qkv(cfg, p, x, positions, cfg.rope)
    B, S = x.shape[0], x.shape[1]
    W = window if window else max(pad_to, S)
    posb = positions.to(torch.int32).expand(B, S)
    if W >= S:
        pad = W - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(posb, (0, pad), value=-1)
        return KVCache(k, v, pos)
    shift = S % W
    return KVCache(torch.roll(k[:, -W:], shift, dims=1),
                   torch.roll(v[:, -W:], shift, dims=1),
                   torch.roll(posb[:, -W:].contiguous(), shift, dims=1))


def init_kv_cache(cfg, batch: int, seq_len: int, window: int = 0, device=None,
                  n_layers: Optional[int] = None, kv_heads: Optional[int] = None) -> KVCache:
    """An empty cache of ``seq_len`` slots a row, or a ring of ``window``
    slots (pos -1 = empty), on ``device`` (default ``cuda``); ``n_layers``
    stacks every leaf ``[L, ...]``; ``kv_heads`` (default the config's)
    is a rank's share under a model axis."""
    W = window if window else seq_len
    lead = () if n_layers is None else (n_layers,)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    shape = lead + (batch, W, kv_heads or cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev),
                   pos=torch.full(lead + (batch, W), -1, dtype=torch.int32, device=dev))


def decode_attention_block(cfg, p: Params, x, cache: KVCache, pos, *, window: int = 0,
                           cache_update: str = "kernel", active=None):
    """One-token decode against one layer's contiguous cache. x [B,1,d], pos
    [B] absolute position of the token -> [B,1,d]; the cache is updated in
    place.

    Ring semantics: the new token's K/V lands in slot ``pos % W``; a slot is
    valid where its position is >= 0, not after ``pos`` and inside
    ``window``. ``cache_update="mask"``: the JAX package's one-hot selector
    and ``where`` over the whole cache; any other value (``"scatter"``,
    ``"kernel"``) an indexed write of one row a slot. Both leave the same
    bits. ``active``: optional bool [B]; inactive rows keep every cache
    entry bit for bit and their outputs are garbage the caller ignores.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, pos[:, None], cfg.rope)
    W = cache.k.shape[1]
    pos32 = pos.to(torch.int32)
    slot = pos.to(torch.int64) % W
    if cache_update == "mask":
        sel = torch.arange(W, device=x.device)[None, :] == slot[:, None]  # [B, W]
        if active is not None:
            sel &= active[:, None]
        cache.k.copy_(torch.where(sel[..., None, None], k_new, cache.k))
        cache.v.copy_(torch.where(sel[..., None, None], v_new, cache.v))
        cache.pos.copy_(torch.where(sel, pos32[:, None], cache.pos))
    else:
        bidx = torch.arange(B, device=x.device)
        k_w, v_w, p_w = k_new[:, 0], v_new[:, 0], pos32
        if active is not None:  # an inactive row writes back what it holds
            k_w = torch.where(active[:, None, None], k_w, cache.k[bidx, slot])
            v_w = torch.where(active[:, None, None], v_w, cache.v[bidx, slot])
            p_w = torch.where(active, p_w, cache.pos[bidx, slot])
        cache.k[bidx, slot] = k_w
        cache.v[bidx, slot] = v_w
        cache.pos[bidx, slot] = p_w

    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, k_new.shape[2], G, cfg.head_dim)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, cache.k).float()
    logits = logits * (1.0 / math.sqrt(cfg.head_dim))
    kpos, posb = cache.pos, pos32[:, None]
    valid = (kpos >= 0) & (kpos <= posb)
    if window:
        valid &= kpos > posb - window
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w.to(cache.v.dtype), cache.v)
    return _out_proj(cfg, p, o.reshape(B, 1, -1, cfg.head_dim))


def insert_kv_slot(cache: KVCache, one: KVCache, slot: int) -> None:
    """Write one request's cache (batch 1) into row ``slot`` of a B-row cache
    in place: leaves ``[B, W, ...]``, or layer-stacked ``[L, B, W, ...]``,
    with ``one``'s matching W. The JAX package's one-hot ``where`` leaves the
    same bits."""
    for dst, src, tail in ((cache.k, one.k, 3), (cache.v, one.v, 3),
                           (cache.pos, one.pos, 1)):
        axis = dst.ndim - tail - 1  # the batch axis
        dst.select(axis, slot).copy_(src.select(axis, 0))


# ---------------------------------------------------------------------------
# paged KV pool (decode)
# ---------------------------------------------------------------------------


class PagedKVPool(NamedTuple):
    """Shared KV page pool of ``n_pages`` pages of ``page_size`` rows. No
    positions are stored: validity is arithmetic (:func:`paged_slot_valid`),
    so a recycled page never leaks its last owner's rows."""

    k: torch.Tensor  # [N, page_size, Hkv, hd] (or [L, N, ...] stacked)
    v: torch.Tensor


def init_paged_kv_pool(cfg, n_pages: int, page_size: int, device,
                       n_layers: Optional[int] = None,
                       kv_heads: Optional[int] = None) -> PagedKVPool:
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (n_pages, page_size, kv_heads or cfg.num_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.param_dtype)
    return PagedKVPool(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device))


paged_slot_valid = pa_ref.slot_valid


def _select_write(pool_t, sel, rows) -> None:
    """The JAX package's ``"mask"`` write, in place: ``sel`` [W, N, ps] is
    the one-hot selector of writer ``w``'s target cell (page, row); every
    selected cell takes its writer's row of ``rows`` [W, Hkv, hd] and every
    other cell keeps its bytes, through one ``where`` over the whole pool
    ``pool_t`` [N, ps, Hkv, hd]. Writers target distinct cells (pages are
    write-exclusive), so each hit cell has exactly one writer: where JAX
    sums the selector's one non-zero product, this gathers that writer's
    row, the same bits (a -0.0 included)."""
    hit = sel.any(0)
    src = sel.to(torch.int32).argmax(0)  # [N, ps]: each hit cell's writer
    pool_t.copy_(torch.where(hit[..., None, None], rows[src], pool_t))


def _cell_selector(N: int, ps: int, phys, row, ok):
    """[W, N, ps] bool: writer w targets (phys[w], row[w]) where ok[w]."""
    dev = phys.device
    return ((torch.arange(N, device=dev)[None, :] == phys[:, None])[:, :, None]
            & (torch.arange(ps, device=dev)[None, None, :] == row[:, None, None])
            & ok[:, None, None])


def paged_decode_attention_block(cfg, p: Params, x, pool: PagedKVPool,
                                 page_table, pos, *, window: int = 0,
                                 cache_update: str = "kernel", active=None):
    """One-token decode against one layer's page pool. x [B,1,d], pos [B],
    page_table [B,P] -> [B,1,d]. The new token's K/V row is written into
    ``pool`` IN PLACE (active slots whose target page is allocated);
    inactive rows write nothing and their outputs are garbage the caller
    ignores.

    ``cache_update="kernel"``: ``ops.paged_decode_attention`` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors).
    ``"scatter"``: the plain version on any device. ``"mask"``: the JAX
    package's one-hot selector and ``where`` over the whole pool write the
    rows (:func:`_select_write`), then the plain version attends with its
    own write switched off; pools are bitwise equal to ``"scatter"``'s.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, pos[:, None], cfg.rope)
    args = (q[:, 0].contiguous(), pool.k, pool.v, k_new[:, 0].contiguous(),
            v_new[:, 0].contiguous(), page_table, pos)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=x.device)
    if cache_update == "kernel":
        o = pa_ops.paged_decode_attention(*args, window=window, active=active)
    elif cache_update == "scatter":
        o = pa_ref.paged_decode_attention(*args, active, window=window)
    elif cache_update == "mask":
        N, ps = pool.k.shape[:2]
        phys, ok = pa_ref.write_target(page_table, pos, ps, window, active)
        pos64 = pos.to(torch.int64)
        idx = (pos64 % window) if window else pos64
        sel = _cell_selector(N, ps, phys, idx % ps, ok)
        _select_write(pool.k, sel, args[3])
        _select_write(pool.v, sel, args[4])
        # the rows are in; the plain version attends with its write off
        o = pa_ref.paged_decode_attention(*args, torch.zeros_like(active), window=window)
    else:
        raise ValueError(f"cache_update={cache_update!r}; expected 'kernel', "
                         "'scatter' or 'mask'")
    return _out_proj(cfg, p, o.reshape(B, 1, -1, cfg.head_dim))


def paged_prefill_attention_block(cfg, p: Params, x, pool: PagedKVPool, page_row,
                                  start: int, length: int, *,
                                  cache_update: str = "scatter"):
    """Chunked or suffix prefill straight into one layer's page pool: one
    batch-1 chunk of ``C`` tokens at absolute positions ``[start, start +
    length)`` of a single slot. x [1, C, d]; page_row [P] int (-1 =
    unallocated). Rows >= ``length`` are padding: never written, their
    outputs garbage the caller ignores.

    Write, then read: the chunk's K/V rows land in their pages first
    (``"scatter"``: an indexed write; ``"mask"``: the one-hot selector and
    ``where`` over the whole pool; the same bits), then the slot's pages are
    gathered and attended with the arithmetic validity of decode (entry
    ``j`` valid iff its page is allocated and ``j <= start + i`` for query
    row ``i``). Within-chunk causal attention, earlier chunks and prefix
    pages shared from other slots all come out of the pool. The attention
    is plain, as in the JAX package (no TPU kernel computes it). Full
    attention only: callers gate on ``sliding_window``.
    """
    C = x.shape[1]
    N, ps, Hkv, hd = pool.k.shape
    P = page_row.shape[0]
    dev = x.device
    positions = start + torch.arange(C, dtype=torch.int32, device=dev)  # [C]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, cfg.rope)

    row = torch.arange(C, device=dev)
    idx = positions.to(torch.int64)  # full attention: entry i holds position i
    pr = page_row.to(device=dev, dtype=torch.int64)
    phys = pr[(idx // ps).clamp(0, P - 1)]  # [C] physical pages
    ok = (row < length) & (phys >= 0)
    if cache_update == "scatter":
        pool.k[phys[ok], idx[ok] % ps] = k_new[0, ok]
        pool.v[phys[ok], idx[ok] % ps] = v_new[0, ok]
    elif cache_update == "mask":
        sel = _cell_selector(N, ps, phys, idx % ps, ok)  # [C, N, ps]
        _select_write(pool.k, sel, k_new[0])
        _select_write(pool.v, sel, v_new[0])
    else:
        raise ValueError(f"chunk write cache_update={cache_update!r}; expected "
                         "'scatter' or 'mask'")

    cap = P * ps
    safe = pr.clamp(min=0)
    k = pool.k[safe].reshape(1, cap, Hkv, hd)
    v = pool.v[safe].reshape(1, cap, Hkv, hd)
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    alloc = (pr >= 0).repeat_interleave(ps)
    valid = alloc[None, :] & (j[None, :] <= positions[:, None])  # [C, cap]

    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(1, C, Hkv, G, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    logits = logits * (1.0 / math.sqrt(hd))
    logits = torch.where(valid[None, None, None], logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return _out_proj(cfg, p, o.reshape(1, C, -1, hd))


def insert_kv_pages(pool: PagedKVPool, one: KVCache, page_ids,
                    cache_update: str = "kernel") -> None:
    """Write a batch-1 prefill cache into pool pages ``page_ids`` [P] in
    place (-1 = unallocated, skipped), all layers at once: pools
    [L, N, ps, Hkv, hd], ``one`` leaves [L, 1, P * ps, Hkv, hd]. Slot page
    ``j`` gets rows ``[j*ps, (j+1)*ps)``; every allocated page is
    overwritten in full, so a recycled page never leaks its last owner's
    K/V. ``"kernel"`` runs ``ops.paged_insert`` (the CUDA kernel for CUDA
    tensors), ``"scatter"`` its plain version, ``"mask"`` the JAX package's
    page selector and ``where`` over the whole pool; the same bits."""
    L, N, ps, Hkv, hd = pool.k.shape
    P = page_ids.shape[0]
    src_k = one.k[:, 0].reshape(L, P, ps, Hkv, hd).contiguous()
    src_v = one.v[:, 0].reshape(L, P, ps, Hkv, hd).contiguous()
    if cache_update == "kernel":
        pa_ops.paged_insert(pool.k, pool.v, src_k, src_v, page_ids)
    elif cache_update == "scatter":
        pa_ref.paged_insert(pool.k, pool.v, src_k, src_v, page_ids)
    elif cache_update == "mask":
        ids = page_ids.to(torch.int64)
        sel = (ids[:, None] == torch.arange(N, device=ids.device)[None, :]) \
            & (ids >= 0)[:, None]  # [P, N]; page ids are distinct
        hit = sel.any(0)[None, :, None, None, None]
        src = sel.to(torch.int32).argmax(0)  # [N]: each hit page's source page
        for pool_t, src_t in ((pool.k, src_k), (pool.v, src_v)):
            pool_t.copy_(torch.where(hit, src_t[:, src], pool_t))
    else:
        raise ValueError(f"cache_update={cache_update!r}; expected 'kernel', "
                         "'scatter' or 'mask'")
