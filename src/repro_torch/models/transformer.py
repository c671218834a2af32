"""Dense decoder stack, serving half (port of ``repro/models/transformer.py``).

Params are a flat dict of tensors keyed by the JAX package's keypaths
(``embed``, ``final_norm/scale``, ``layers/attn/w_q`` ...); per-layer
leaves are stacked ``[L, ...]`` and the stack is a Python loop over
layers (the JAX package scans). KV pools are updated in place where the
JAX package returns new (donated) buffers.

Only the dense family is ported; MoE, hybrid, xLSTM and VLM families are
queued in ROADMAP.md ("the rest of serving").
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Params, apply_norm, embed_init,
                                       mlp_apply, mlp_init, norm_init,
                                       dense_init)


def check_dense(cfg):
    """Raise for the families the port does not serve yet."""
    if cfg.family != "dense" or cfg.is_moe or cfg.hybrid_parallel_ssm \
            or cfg.vision_dim or cfg.learned_pos:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} is not ported yet (ROADMAP.md: "
            "MoE, hybrid, xLSTM, VLM and audio families come with the rest of "
            "serving; the toy models with the FedVeca-round slice)")


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def init_params(cfg, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> Params:
    """Random params for a dense decoder, drawn from ``gen`` (or a fresh
    generator seeded with ``seed``) on ``device`` (default ``cuda``).
    Weights N(0, 1/in_dim), embeddings N(0, 0.02^2), norm scales and biases
    zero, as in the JAX package (the draws themselves differ)."""
    check_dense(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    L, d = cfg.num_layers, cfg.d_model
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, d, dt, dev)}
    p.update(_prefixed("final_norm", norm_init(cfg, d, dev)))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dt, dev)
    lead = (L,)
    p.update(_prefixed("layers/norm1", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/norm2", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/attn", attn.attn_init(gen, cfg, d, dt, dev, lead)))
    if cfg.d_ff:
        p.update(_prefixed("layers/mlp", mlp_init(gen, cfg, d, cfg.d_ff, dt, dev, lead)))
    return p


def layer_params(p: Params, num_layers: int) -> List[Params]:
    """Per-layer views of the stacked ``layers/*`` leaves, keyed without
    the ``layers/`` prefix (``attn/w_q``)."""
    out: List[Params] = [{} for _ in range(num_layers)]
    for k, v in p.items():
        if k.startswith("layers/"):
            for i, t in enumerate(torch.unbind(v)):
                out[i][k[len("layers/"):]] = t
    return out


def embed_tokens(cfg, p: Params, tokens):
    return p["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))


def unembed(cfg, p: Params, h):
    h = apply_norm(cfg, p, "final_norm", h)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return h @ w


def _mlp_residual(cfg, lp: Params, h):
    if cfg.d_ff:
        h = h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h))
    return h


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    kv: attn.KVCache  # leaves stacked [L, B, W, ...]


def prefill(cfg, p: Params, batch, *, pad_to: int = 0, length=None):
    """Whole-prompt forward -> (last-token logits [B, V], DecodeCache).

    ``pad_to``: full-attention cache capacity. ``length``: optional int [B]
    true prompt lengths of right-padded prompts (full attention only):
    logits come from position length-1 and padded cache slots get pos -1.

    Attention applies the config's sliding window, as the JAX package's
    ``forward`` does. (The JAX ``prefill`` passes window 0 and so attends
    fully for prompts longer than the window, ROADMAP.md C/R1; for
    S <= W the two agree.)
    """
    check_dense(cfg)
    W = cfg.sliding_window
    if length is not None and W:
        raise ValueError(
            "prefill(length=) is full-attention only: the ring buffer keeps "
            "the last `window` slots of the PADDED prompt, dropping live "
            "tokens — prefill SWA models at the exact prompt length")
    tokens = batch["tokens"]
    h = embed_tokens(cfg, p, tokens)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    ks, vs, ps_ = [], [], []
    for lp in layer_params(p, cfg.num_layers):
        hn = apply_norm(cfg, lp, "norm1", h)
        kv = attn.prefill_kv_cache(cfg, lp, hn, positions, window=W, pad_to=pad_to)
        h = _mlp_residual(cfg, lp, h + attn.attention_block(cfg, lp, hn, positions))
        ks.append(kv.k)
        vs.append(kv.v)
        ps_.append(kv.pos)
    kv = attn.KVCache(torch.stack(ks), torch.stack(vs), torch.stack(ps_))
    if length is None:
        logits = unembed(cfg, p, h[:, -1:])[:, 0]
    else:
        length = length.to(device=h.device, dtype=torch.int64)
        last = h.gather(1, (length - 1)[:, None, None].expand(B, 1, h.shape[2]))
        logits = unembed(cfg, p, last)[:, 0]
        kv = kv._replace(pos=torch.where(kv.pos < length[None, :, None], kv.pos,
                                         torch.full_like(kv.pos, -1)))
    return logits, DecodeCache(kv=kv)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------


class PagedDecodeCache(NamedTuple):
    """KV pool shared by every slot, leaves stacked [L, n_pages, page_size,
    Hkv, hd]. One page id addresses the same page in every layer, so the
    host-owned page table is passed per dispatch, not stored here."""

    kv: attn.PagedKVPool


def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     device=None) -> PagedDecodeCache:
    check_dense(cfg)
    return PagedDecodeCache(kv=attn.init_paged_kv_pool(
        cfg, n_pages, page_size, resolve_device(device), n_layers=cfg.num_layers))


def paged_decode_step(cfg, p: Params, cache: PagedDecodeCache, page_table,
                      token, pos, window: int = 0, cache_update: str = "kernel",
                      active=None):
    """token [B], pos [B], page_table [B, P] int32 -> (logits [B, V], cache).
    The pool is updated in place (the returned cache is ``cache``);
    inactive rows write nothing and their logits are garbage."""
    h = embed_tokens(cfg, p, token)[:, None]  # [B, 1, d]
    W = window or cfg.sliding_window
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        pool = attn.PagedKVPool(cache.kv.k[l], cache.kv.v[l])
        a_out = attn.paged_decode_attention_block(
            cfg, lp, apply_norm(cfg, lp, "norm1", h), pool, page_table, pos,
            window=W, cache_update=cache_update, active=active)
        h = _mlp_residual(cfg, lp, h + a_out)
    return unembed(cfg, p, h)[:, 0], cache


def insert_cache_pages(cache: PagedDecodeCache, one: DecodeCache, slot,
                       page_ids, cache_update: str = "kernel") -> PagedDecodeCache:
    """Admission: write one request's prefill cache (batch 1) into its pool
    pages ``page_ids`` [P] in place (-1 = unallocated, skipped). The
    prefill cache is zero-padded up to P * page_size rows so every
    allocated page is overwritten in full. ``cache_update="kernel"`` runs
    the layer-stacked insert kernel (one launch for the whole stack) for
    CUDA tensors; ``"scatter"`` the plain version. ``slot`` is unused by the
    dense family (hybrid models write their SSM row there)."""
    del slot
    if cache_update not in ("kernel", "scatter"):
        raise NotImplementedError(
            f"cache_update={cache_update!r} is not ported (ROADMAP.md)")
    ps = cache.kv.k.shape[2]
    P = page_ids.shape[0]
    cap, have = P * ps, one.kv.k.shape[2]
    k, v = one.kv.k, one.kv.v
    if have < cap:  # SWA ring of W rows with W not a page multiple
        pad = (0, 0, 0, 0, 0, cap - have)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    attn.insert_kv_pages(cache.kv, attn.KVCache(k, v, one.kv.pos), page_ids,
                         use_kernel=cache_update == "kernel")
    return cache
