"""GQA attention, serving half (port of ``repro/models/attention.py``).

Prefill runs the direct masked-softmax attention written out as matmuls
(float32 softmax). Decode runs against the shared KV page pool through
``kernels/paged_attention``: ``cache_update="kernel"`` dispatches the CUDA
kernel for CUDA tensors (its plain version for CPU tensors), and
``"scatter"`` always runs the plain version. The JAX package's
``"mask"`` write, its chunked and Pallas prefill attention, the
contiguous ring cache decode and paged chunk prefill are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models.layers import Params, apply_rope, dense_init

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
    k/v [B,S,Hkv,hd]."""
    B, S, _ = x.shape
    q = x @ p["attn/w_q"]
    k = x @ p["attn/w_k"]
    v = x @ p["attn/w_v"]
    if "attn/b_q" in p:
        q, k, v = q + p["attn/b_q"], k + p["attn/b_k"], v + p["attn/b_v"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def attention_block(cfg, p: Params, x, positions, *, window: Optional[int] = None,
                    causal: bool = True, impl: str = "auto"):
    """Prefill attention sub-block. x [B,S,d]. ``window=None`` applies the
    config's sliding window. ``impl`` is "auto" or "direct", both the direct
    attention here (the JAX package's "auto" switches to chunked attention
    above S = 2048; chunked and "pallas" are not ported yet)."""
    if impl not in ("auto", "direct"):
        raise NotImplementedError(
            f"attention impl={impl!r} is not ported (ROADMAP.md: flash "
            "attention comes with the LM-training slice)")
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, cfg.rope)
    win = cfg.sliding_window if window is None else window
    o = _direct_attention(q, k, v, positions, positions, causal, win)
    return o.reshape(B, S, cfg.q_dim) @ p["attn/w_o"]


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
                       n_layers: Optional[int] = None) -> PagedKVPool:
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.param_dtype)
    return PagedKVPool(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device))


paged_slot_valid = pa_ref.slot_valid


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
    ``"scatter"``: the plain version on any device.
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
    else:
        raise NotImplementedError(
            f"cache_update={cache_update!r} is not ported (ROADMAP.md: the "
            "rest of serving); use 'kernel' or 'scatter'")
    return o.reshape(B, 1, cfg.q_dim) @ p["attn/w_o"]


def insert_kv_pages(pool: PagedKVPool, one: KVCache, page_ids,
                    use_kernel: bool = True) -> None:
    """Write a batch-1 prefill cache into pool pages ``page_ids`` [P] in
    place (-1 = unallocated, skipped), all layers at once: pools
    [L, N, ps, Hkv, hd], ``one`` leaves [L, 1, P * ps, Hkv, hd]. Slot page
    ``j`` gets rows ``[j*ps, (j+1)*ps)``; every allocated page is
    overwritten in full, so a recycled page never leaks its last owner's
    K/V. ``use_kernel`` runs ``ops.paged_insert`` (the CUDA kernel for CUDA
    tensors), else the plain version."""
    L, N, ps, Hkv, hd = pool.k.shape
    P = page_ids.shape[0]
    src_k = one.k[:, 0].reshape(L, P, ps, Hkv, hd).contiguous()
    src_v = one.v[:, 0].reshape(L, P, ps, Hkv, hd).contiguous()
    insert = pa_ops.paged_insert if use_kernel else pa_ref.paged_insert
    insert(pool.k, pool.v, src_k, src_v, page_ids)
