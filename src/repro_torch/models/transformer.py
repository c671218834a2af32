"""Decoder stacks (port of ``repro/models/transformer.py``): the dense,
MoE, hybrid (attention + SSM), xLSTM and VLM families' full-sequence
forward and loss, prefill (dense, MoE and VLM), and paged decode and
chunked prefill into the page pool (dense).

Params are a flat dict of tensors keyed by the JAX package's keypaths
(``embed``, ``final_norm/scale``, ``layers/attn/w_q`` ...); per-layer
leaves are stacked ``[L, ...]`` (xLSTM: ``xlstm/m/...`` and ``xlstm/s/...``
stacked ``[n_super, n_per_super, ...]``) and the stack is a Python loop
over layers (the JAX package scans). KV pools are updated in place where
the JAX package returns new (donated) buffers.

The audio family is the encoder-decoder of ``models/encdec.py``; serving
anything but the dense family raises (ROADMAP.md A15), and so does prefill
of the recurrent families, whose caches come with their decode.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (Params, apply_norm, cross_entropy,
                                       dense_init, embed_init, mlp_apply,
                                       mlp_init, norm_init, promoted_matmul, rmsnorm)

FULL_SEQUENCE_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")


def check_full_sequence(cfg):
    """Raise for the families that are not decoder stacks of this module."""
    if cfg.family not in FULL_SEQUENCE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} is not a decoder stack of "
            "models.transformer (the audio family is models.encdec, the toy "
            "models models.simple; models.model.build_model picks the module)")


def serving_gap(cfg) -> str:
    """Why the port cannot serve ``cfg`` yet ("" for the dense family)."""
    if cfg.family == "dense":
        return ""
    if cfg.family == "vlm":
        return (f"{cfg.name}: serving family='vlm' is not ported yet (ROADMAP.md A15: "
                f"serving phi-3, with paged decode at head dim {cfg.head_dim})")
    return (f"{cfg.name}: serving family={cfg.family!r} is not ported yet (ROADMAP.md A15: "
            "MoE serving and the hybrid/xLSTM recurrent prefill and decode)")


def check_serving(cfg):
    """Raise for the families the port does not serve yet (dense only)."""
    check_full_sequence(cfg)
    if serving_gap(cfg):
        raise NotImplementedError(serving_gap(cfg))


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]) -> Params:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def _sub(p: Params, prefix: str) -> Params:
    """The leaves under ``prefix/``, keyed without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _xlstm_counts(cfg):
    pat = cfg.xlstm_pattern
    return cfg.num_layers // len(pat), pat.count("m"), pat.count("s")


def init_params(cfg, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> Params:
    """Random params, drawn from ``gen`` (or a fresh generator seeded with
    ``seed``) on ``device`` (default ``cuda``), with the keys and shapes of
    the JAX package's ``init_params``. Weights N(0, 1/in_dim), embeddings
    N(0, 0.02^2), norm scales and biases zero, the router N(0, 0.02^2), as
    there (the draws themselves differ). ``learned_pos`` adds ``pos_embed``
    (max(encoder_seq, 32768) rows), the VLM family ``vision_proj``."""
    check_full_sequence(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    L, d = cfg.num_layers, cfg.d_model
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, d, dt, dev)}
    p.update(_prefixed("final_norm", norm_init(cfg, d, dev)))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dt, dev)
    if cfg.learned_pos:
        max_pos = max(cfg.encoder_seq, 2048 if cfg.family == "toy" else 32768)
        p["pos_embed"] = embed_init(gen, max_pos, d, dt, dev)
    if cfg.vision_dim:
        p["vision_proj"] = dense_init(gen, cfg.vision_dim, d, dt, dev)
    if cfg.family == "ssm":  # xLSTM: [n_super, n_per_super, ...] stacks
        n_super, n_m, n_s = _xlstm_counts(cfg)
        for kind, n, init in (("m", n_m, xlstm_mod.mlstm_init), ("s", n_s, xlstm_mod.slstm_init)):
            lead = (n_super, n)
            p.update(_prefixed(f"xlstm/{kind}_norm", norm_init(cfg, d, dev, lead)))
            p.update(_prefixed(f"xlstm/{kind}", init(gen, cfg, d, dt, dev, lead)))
        return p
    lead = (L,)
    p.update(_prefixed("layers/norm1", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/norm2", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("layers/attn", attn.attn_init(gen, cfg, d, dt, dev, lead)))
    if cfg.is_moe:
        p.update(_prefixed("layers/moe", moe_mod.moe_init(gen, cfg, d, dt, dev, lead)))
    elif cfg.d_ff:
        p.update(_prefixed("layers/mlp", mlp_init(gen, cfg, d, cfg.d_ff, dt, dev, lead)))
    if cfg.hybrid_parallel_ssm:
        p.update(_prefixed("layers/ssm", ssm_mod.ssm_init(gen, cfg, d, dt, dev, lead)))
        # per-branch output norms of the hybrid fusion (Hymba eq. 2)
        for name in ("attn_out_norm", "ssm_out_norm"):
            p[f"layers/{name}/scale"] = torch.zeros((L, d), dtype=torch.float32, device=dev)
    return p


def layer_params(p: Params, num_layers: int, stack: str = "layers") -> List[Params]:
    """Per-layer views of the stacked ``{stack}/*`` leaves, keyed without
    the ``{stack}/`` prefix (``attn/w_q``); the encoder-decoder's stacks are
    ``enc_layers`` and ``dec_layers``."""
    out: List[Params] = [{} for _ in range(num_layers)]
    for k, v in _sub(p, stack).items():
        for i, t in enumerate(torch.unbind(v)):
            out[i][k] = t
    return out


def embed_tokens(cfg, p: Params, batch):
    """``batch["tokens"]`` [B, S] -> [B, S, d] in the compute type. The VLM
    family's ``batch["patches"]`` [B, P, vision_dim] through
    ``vision_proj`` replace the first P positions; with P > S the patches
    are ignored, as in the JAX package. ``learned_pos`` adds
    ``pos_embed[:S]``."""
    dt = getattr(torch, cfg.compute_dtype)
    h = p["embed"][batch["tokens"].long()].to(dt)
    if cfg.vision_dim and "patches" in batch:
        pe = promoted_matmul(batch["patches"], p["vision_proj"]).to(dt)
        if pe.shape[1] <= h.shape[1]:
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    if cfg.learned_pos:
        h = h + p["pos_embed"][:h.shape[1]][None].to(dt)
    return h


def unembed(cfg, p: Params, h):
    h = apply_norm(cfg, p, "final_norm", h)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return h @ w


def _ffn(cfg, lp: Params, h, token_mask=None):
    """h plus the layer's FFN (MoE or MLP) on ``norm2(h)`` -> (h, the
    router's aux loss, or None without a router)."""
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(cfg, _sub(lp, "moe"), apply_norm(cfg, lp, "norm2", h),
                                   token_mask=token_mask)
        return h + y, aux
    if cfg.d_ff:
        h = h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h))
    return h, None


def _hybrid_fuse(cfg, lp: Params, a_out, s_out):
    """The mean of the two branches, each through its own rmsnorm (the JAX
    package uses rmsnorm here whatever ``cfg.norm``)."""
    a = rmsnorm(a_out, lp["attn_out_norm/scale"])
    s = rmsnorm(s_out, lp["ssm_out_norm/scale"])
    return 0.5 * (a + s)


def _mixer(cfg, lp: Params, hn, attn_out):
    """The layer's token mixing on ``hn = norm1(h)``: the attention output,
    or for the hybrid family its fusion with the SSM branch on ``hn``."""
    if not cfg.hybrid_parallel_ssm:
        return attn_out
    s_out, _ = ssm_mod.ssm_apply(cfg, _sub(lp, "ssm"), hn)
    return _hybrid_fuse(cfg, lp, attn_out, s_out)


# ---------------------------------------------------------------------------
# forward / loss (full sequence)
# ---------------------------------------------------------------------------


def layer_apply(cfg, lp: Params, h, positions, impl: str = "auto", window=None):
    """One decoder layer -> (h, aux): the router's aux loss for the MoE
    family, a float32 zero otherwise."""
    hn = apply_norm(cfg, lp, "norm1", h)
    a_out = attn.attention_block(cfg, lp, hn, positions, impl=impl, window=window)
    h, aux = _ffn(cfg, lp, h + _mixer(cfg, lp, hn, a_out))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def _xlstm_blocks(p: Params, kind: str, i: int, n: int):
    """Views of super-block ``i``'s ``n`` blocks of ``kind`` (m or s): each
    ``(norm leaves keyed norm/*, cell leaves keyed without a prefix)``."""
    norm = {k: v for k, v in p.items() if k.startswith(f"xlstm/{kind}_norm/")}
    cell = _sub(p, f"xlstm/{kind}")
    off = len(f"xlstm/{kind}_")
    return [({k[off:]: v[i, j] for k, v in norm.items()},
             {k: v[i, j] for k, v in cell.items()}) for j in range(n)]


def _xlstm_stack(cfg, p: Params, h):
    """Super-blocks in order; each runs its mLSTM blocks, then its sLSTM
    blocks, every block pre-normed with a residual (``_xlstm_stack`` of the
    JAX package)."""
    n_super, n_m, n_s = _xlstm_counts(cfg)
    for i in range(n_super):
        for kind, n, apply in (("m", n_m, xlstm_mod.mlstm_apply),
                               ("s", n_s, xlstm_mod.slstm_apply)):
            for norm, cell in _xlstm_blocks(p, kind, i, n):
                y, _ = apply(cfg, cell, apply_norm(cfg, norm, "norm", h))
                h = h + y
    return h


def forward(cfg, p: Params, batch, impl: str = "auto", window=None):
    """-> (logits [B, S, V], aux loss: the routers' mean over layers, 0
    without). ``impl`` picks the attention (``attention.attention_block``);
    ``window=None`` applies the config's. The JAX ``forward``'s ``remat``
    and ``unroll`` are XLA compile knobs (rematerialization and scan
    unrolling) and are not ported: this runs eagerly, layer by layer."""
    check_full_sequence(cfg)
    h = embed_tokens(cfg, p, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        return unembed(cfg, p, _xlstm_stack(cfg, p, h)), aux
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for lp in layer_params(p, cfg.num_layers):
        h, a = layer_apply(cfg, lp, h, positions, impl=impl, window=window)
        aux = aux + a
    return unembed(cfg, p, h), aux / max(cfg.num_layers, 1)


def loss_fn(cfg, p: Params, batch, impl: str = "auto", window=None):
    """-> (cross entropy + aux, {"ce", "aux"}); ``batch["loss_mask"]``
    optional."""
    logits, aux = forward(cfg, p, batch, impl=impl, window=window)
    ce = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    kv: attn.KVCache  # leaves stacked [L, B, W, ...]


def prefill(cfg, p: Params, batch, *, impl: str = "auto", window: int = 0, pad_to: int = 0,
            unroll=1, length=None):
    """Whole-prompt forward of a dense or MoE model -> (last-token logits
    [B, V], DecodeCache).

    ``impl`` picks the attention, as in :func:`forward`. ``window``: ring
    size of the cache, ``W = window or cfg.sliding_window``, so a
    full-attention model can prefill into a ``window``-slot ring for ring
    decode, as in the JAX package. ``pad_to``: full-attention cache
    capacity. ``length``: optional int [B] true prompt lengths of
    right-padded prompts (full attention only): logits come from position
    length-1 and padded cache slots get pos -1. ``unroll`` is the JAX
    package's scan-unrolling compile knob and is ignored here.

    Attention applies ``window``, or the config's sliding window when it
    is 0, as the JAX package's ``forward`` does. (The JAX ``prefill``
    passes only ``window`` and so attends fully for prompts longer than
    the config's window, ROADMAP.md P1/R1; for S <= W the two agree.)
    MoE layers route the padded tokens behind live ones (``token_mask``),
    so padding never displaces a live token; the capacity still counts the
    padded tokens, as in the JAX package. The hybrid and xLSTM families
    raise: their recurrent caches come with their decode (ROADMAP.md A15).
    """
    del unroll
    check_full_sequence(cfg)
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        raise NotImplementedError(
            f"{cfg.name}: prefill of family={cfg.family!r} is not ported yet (ROADMAP.md "
            "A15: the hybrid/xLSTM recurrent caches come with their decode)")
    W = window or cfg.sliding_window
    if length is not None and W:
        raise ValueError(
            "prefill(length=) is full-attention only: the ring buffer keeps "
            "the last `window` slots of the PADDED prompt, dropping live "
            "tokens — prefill SWA models at the exact prompt length")
    h = embed_tokens(cfg, p, batch)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    # pad tokens must not compete for MoE expert capacity
    live = None if length is None else (
        positions[None, :].long() < length.to(h.device).long()[:, None])
    ks, vs, ps_ = [], [], []
    for lp in layer_params(p, cfg.num_layers):
        hn = apply_norm(cfg, lp, "norm1", h)
        kv = attn.prefill_kv_cache(cfg, lp, hn, positions, window=W, pad_to=pad_to)
        h, _ = _ffn(cfg, lp, h + attn.attention_block(cfg, lp, hn, positions, impl=impl,
                                                      window=window or None), live)
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
    check_serving(cfg)
    return PagedDecodeCache(kv=attn.init_paged_kv_pool(
        cfg, n_pages, page_size, resolve_device(device), n_layers=cfg.num_layers))


def paged_decode_step(cfg, p: Params, cache: PagedDecodeCache, page_table,
                      token, pos, window: int = 0, cache_update: str = "kernel",
                      active=None):
    """token [B], pos [B], page_table [B, P] int32 -> (logits [B, V], cache).
    The pool is updated in place (the returned cache is ``cache``);
    inactive rows write nothing and their logits are garbage."""
    check_serving(cfg)
    h = p["embed"][token.long()][:, None].to(getattr(torch, cfg.compute_dtype))  # [B, 1, d]
    if cfg.learned_pos:
        h = h + p["pos_embed"][pos.long()][:, None].to(h.dtype)
    W = window or cfg.sliding_window
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        pool = attn.PagedKVPool(cache.kv.k[l], cache.kv.v[l])
        a_out = attn.paged_decode_attention_block(
            cfg, lp, apply_norm(cfg, lp, "norm1", h), pool, page_table, pos,
            window=W, cache_update=cache_update, active=active)
        h, _ = _ffn(cfg, lp, h + a_out)
    return unembed(cfg, p, h)[:, 0], cache


class KernelExtendFallbackWarning(UserWarning):
    """Chunk prefill lowered ``cache_update="kernel"`` to the ``"scatter"``
    write.

    No TPU kernel writes a prefill chunk into the pool (the JAX package
    lowers these writes to its one-hot ``"mask"`` path), so the port has no
    CUDA kernel to run there either. It takes the indexed ``"scatter"``
    write instead: the same bits as ``"mask"``, without a selector that
    spans the whole pool. Decode and whole-prompt admission keep their
    kernels.
    """


_KERNEL_EXTEND_WARNED = False


def warn_kernel_extend_fallback(site: str) -> None:
    """Warn once a process that chunk writes under ``cache_update="kernel"``
    take the plain ``"scatter"`` path; every lowering site routes through
    here, so the notice fires once whichever site reaches it first."""
    global _KERNEL_EXTEND_WARNED
    if _KERNEL_EXTEND_WARNED:
        return
    _KERNEL_EXTEND_WARNED = True
    warnings.warn(
        KernelExtendFallbackWarning(
            f"{site}: cache_update='kernel' has no chunk-prefill kernel (the "
            "JAX package has no Pallas one to port); chunk writes take the "
            "plain 'scatter' path, bitwise equal to 'mask' (decode and "
            "whole-prompt admission keep their kernels)"),
        stacklevel=3)


def extend_write(cache_update: str) -> str:
    """The pool write a chunk prefill takes under ``cache_update``."""
    return "scatter" if cache_update == "kernel" else cache_update


def paged_prefill_chunk(cfg, p: Params, cache: PagedDecodeCache, page_row, tokens,
                        start: int, length: int, unroll=1,
                        cache_update: str = "kernel"):
    """Prefill one chunk of a single request's prompt straight into the page
    pool (the serve loop's prefix caching and chunked prefill).

    tokens [1, C] covers absolute positions ``[start, start + length)`` of
    the slot whose page-table row is ``page_row`` [P]; rows >= ``length``
    are padding and never written. Returns (logits [1, V] at position
    ``start + length - 1``, cache), the pool updated in place: the logits
    matter only for a prompt's last chunk, where they give the first
    generated token as a whole-prompt prefill would. Earlier chunks and
    prefix pages shared from other slots are read back from the pool;
    ``param_dtype == compute_dtype`` makes that round trip the identity.

    ``cache_update="kernel"`` writes the chunk through ``"scatter"`` (see
    :class:`KernelExtendFallbackWarning`, raised once); ``"scatter"`` and
    ``"mask"`` write as named. ``unroll`` is the JAX package's scan knob
    and is ignored. Recurrent and sliding-window configs raise, as in the
    JAX package; families the port does not serve yet raise naming A15.
    """
    del unroll
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        raise ValueError(
            f"{cfg.name}: recurrent state cannot be chunk-prefilled — "
            "the SSM carry does not live in pool pages")
    if cfg.sliding_window:
        raise ValueError(
            f"{cfg.name}: chunked prefill is full-attention only — the SWA "
            "ring wraps KV writes into early (possibly shared) pages")
    check_serving(cfg)
    if cache_update == "kernel":
        warn_kernel_extend_fallback("models.transformer.paged_prefill_chunk")
    cu = extend_write(cache_update)
    C = tokens.shape[1]
    h = p["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))  # [1, C, d]
    positions = start + torch.arange(C, device=h.device)
    if cfg.learned_pos:
        h = h + p["pos_embed"][positions][None].to(h.dtype)
    # pad rows must not compete for MoE expert capacity
    live = (torch.arange(C, device=h.device) < length)[None, :]
    for l, lp in enumerate(layer_params(p, cfg.num_layers)):
        pool = attn.PagedKVPool(cache.kv.k[l], cache.kv.v[l])
        a_out = attn.paged_prefill_attention_block(
            cfg, lp, apply_norm(cfg, lp, "norm1", h), pool, page_row, start, length,
            cache_update=cu)
        h, _ = _ffn(cfg, lp, h + a_out, live)
    last = h[:, max(length - 1, 0)][:, None]  # [1, 1, d]
    return unembed(cfg, p, last)[:, 0], cache


def insert_cache_pages(cache: PagedDecodeCache, one: DecodeCache, slot,
                       page_ids, cache_update: str = "kernel") -> PagedDecodeCache:
    """Admission: write one request's prefill cache (batch 1) into its pool
    pages ``page_ids`` [P] in place (-1 = unallocated, skipped). The
    prefill cache is zero-padded up to P * page_size rows so every
    allocated page is overwritten in full. ``cache_update="kernel"`` runs
    the layer-stacked insert kernel (one launch for the whole stack) for
    CUDA tensors; ``"scatter"`` its plain version; ``"mask"`` the JAX
    package's page selector and ``where`` over the whole pool. ``slot`` is
    unused by the dense family (hybrid models write their SSM row there)."""
    del slot
    ps = cache.kv.k.shape[2]
    P = page_ids.shape[0]
    cap, have = P * ps, one.kv.k.shape[2]
    k, v = one.kv.k, one.kv.v
    if have < cap:  # SWA ring of W rows with W not a page multiple
        pad = (0, 0, 0, 0, 0, cap - have)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    attn.insert_kv_pages(cache.kv, attn.KVCache(k, v, one.kv.pos), page_ids,
                         cache_update=cache_update)
    return cache
