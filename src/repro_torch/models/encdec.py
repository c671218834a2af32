"""Whisper-style encoder-decoder, the audio family (port of
``repro/models/encdec.py``).

The mel-spectrogram and conv frontend is a stub there and here: the batch
carries precomputed frame embeddings ``frames`` [B, encoder_seq,
frontend_dim]. The encoder stack (non-causal self-attention), the decoder
(causal self-attention, cross-attention to the encoder's output without
RoPE) and the tied unembedding are real.

Params are a flat dict keyed by the JAX package's keypaths: ``frame_proj``,
``enc_pos``, ``embed``, ``pos_embed``, ``enc_final_norm/*``,
``final_norm/*``, and the stacks ``enc_layers/{norm1,norm2,attn,mlp}/*``
and ``dec_layers/{norm1,norm_x,norm2,self_attn,cross_attn,mlp}/*``, each
``[L, ...]``. The stacks are Python loops over layers. As in the JAX
package, ``forward(remat=True)`` (the default) rematerializes each
decoder layer for the backward (``transformer._remat_wrap``), and the
encoder's layers are rematerialized whatever ``remat`` says.

The JAX package's functions take ``impl`` and every other keyword through
``**_`` and ignore them: whisper's attention is ``attention_block``'s
``auto`` path (direct at its lengths) and ``_direct_attention``, and its
norm is layernorm, so no kernel of the port is on this path. The port's
functions do the same. There is no decode (the JAX package has none for
whisper either).

Under a model axis (``sharding/partition.py``) the encoder's and the
decoder's self-attention and the decoder's cross-attention run on the
rank's heads, the MLPs on the rank's slice of ``d_ff``, and ``embed``,
``pos_embed`` and ``enc_pos`` are on d (their rows' pieces gathered);
``frame_proj`` is replicated. The cross-attention's K/V are projected
outside the layer from the encoder's output on the rank's heads, and the
tied unembedding is row-parallel (``transformer.unembed``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Params, apply_norm, cross_entropy,
                                       dense_init, embed_init, mlp_apply,
                                       mlp_init, norm_init, tp, wmatmul)
from repro_torch.models.transformer import (_prefixed, _remat_wrap, _rows, _sub, layer_params,
                                            unembed)
from repro_torch.sharding import api


def init_params(cfg, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> Params:
    """Random params with the keys and shapes of the JAX package's
    ``encdec.init_params``, drawn from ``gen`` (or a fresh generator seeded
    with ``seed``) on ``device`` (default ``cuda``): weights N(0, 1/in_dim),
    embeddings and positions N(0, 0.02^2), norms and biases zero."""
    dev = resolve_device(device)
    if gen is None and dev.type != "meta":  # meta: the shapes alone, nothing drawn
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    p: Params = {
        "frame_proj": dense_init(gen, cfg.frontend_dim, d, dt, dev),
        "enc_pos": embed_init(gen, max(cfg.encoder_seq, 8), d, dt, dev),
        "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
        "pos_embed": embed_init(gen, max(cfg.encoder_seq, 32768), d, dt, dev),
    }
    lead = (cfg.encoder_layers,)
    for name in ("norm1", "norm2"):
        p.update(_prefixed(f"enc_layers/{name}", norm_init(cfg, d, dev, lead)))
    p.update(_prefixed("enc_layers/attn", attn.attn_init(gen, cfg, d, dt, dev, lead)))
    p.update(_prefixed("enc_layers/mlp", mlp_init(gen, cfg, d, cfg.d_ff, dt, dev, lead)))
    lead = (cfg.num_layers,)
    for name in ("norm1", "norm_x", "norm2"):
        p.update(_prefixed(f"dec_layers/{name}", norm_init(cfg, d, dev, lead)))
    for name in ("self_attn", "cross_attn"):
        p.update(_prefixed(f"dec_layers/{name}", attn.attn_init(gen, cfg, d, dt, dev, lead)))
    p.update(_prefixed("dec_layers/mlp", mlp_init(gen, cfg, d, cfg.d_ff, dt, dev, lead)))
    p.update(_prefixed("enc_final_norm", norm_init(cfg, d, dev)))
    p.update(_prefixed("final_norm", norm_init(cfg, d, dev)))
    return p


def encode(cfg, p: Params, frames):
    """frames [B, T_enc, frontend_dim] -> [B, T_enc, d]. Each layer is
    rematerialized for the backward whatever ``remat`` says, as the JAX
    package's ``encode`` always wraps its layers in ``jax.checkpoint``."""
    dt = getattr(torch, cfg.compute_dtype)
    h = wmatmul(frames, p["frame_proj"]).to(dt)
    h = h + _rows(cfg, p["enc_pos"], slice(0, h.shape[1]))[None].to(dt)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(h, lp, positions):
        h = h + attn.attention_block(cfg, lp, apply_norm(cfg, lp, "norm1", h), positions,
                                     causal=False)
        return (h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h)),)

    layer = _remat_wrap(body, True)
    for lp in layer_params(p, cfg.encoder_layers, "enc_layers"):
        (h,) = layer(h, lp, positions)
    return apply_norm(cfg, p, "enc_final_norm", h)


_CROSS_KV = ("cross_attn/w_k", "cross_attn/w_v", "cross_attn/b_k", "cross_attn/b_v")


def _cross_kv(cfg, lp: Params, enc_out):
    """The cross-attention's K and V [B, T, Hkv, hd] (the rank's heads)
    from the encoder's output, no RoPE. ``lp`` holds one layer's
    ``cross_attn/*`` leaves without the prefix."""
    B, T, _ = enc_out.shape
    lay = tp(cfg)
    e = api.copy_in(enc_out) if lay.attn else enc_out
    k, v = wmatmul(e, lp["w_k"]), wmatmul(e, lp["w_v"])
    if "b_q" in lp:
        k, v = k + lp["b_k"], v + lp["b_v"]
    return (k.reshape(B, T, lay.kv_heads, cfg.head_dim),
            v.reshape(B, T, lay.kv_heads, cfg.head_dim))


def _cross_attention(cfg, lp: Params, h, k, v):
    """Queries from the decoder states against :func:`_cross_kv`'s K/V,
    no RoPE, no mask; ``w_o`` row-parallel when attention is split. ``lp``
    holds one layer's ``cross_attn/*`` leaves without the prefix."""
    B, S, _ = h.shape
    lay = tp(cfg)
    q = wmatmul(api.copy_in(h) if lay.attn else h, lp["w_q"])
    if "b_q" in lp:
        q = q + lp["b_q"]
    q = q.reshape(B, S, lay.heads, cfg.head_dim)
    o = attn._direct_attention(q, k, v, torch.arange(S, device=h.device),
                               torch.arange(k.shape[1], device=h.device), causal=False, window=0)
    y = wmatmul(o.reshape(B, S, -1), lp["w_o"])
    return api.reduce_out(y) if lay.attn else y


def _decoder(cfg, p: Params, batch, enc_out, kv_out=None, remat=False):
    """The decoder stack on ``batch["tokens"]`` -> final hidden states
    (before ``final_norm``); with ``kv_out`` a list, each layer's prefill
    KV cache of its self-attention is appended to it. ``remat``
    rematerializes each layer (``transformer._remat_wrap``) but for its
    cross-attention K/V, which are projected from the encoder's output
    outside the block and enter it as tensors: the encoder's output feeds
    every layer, and with the projections outside, its gradient sums the
    layers' terms in one order with and without ``remat``, so the two
    agree bit for bit."""
    dt = getattr(torch, cfg.compute_dtype)
    h = _rows(cfg, p["embed"], batch["tokens"].long()).to(dt)
    S = h.shape[1]
    h = h + _rows(cfg, p["pos_embed"], slice(0, S))[None].to(dt)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)

    def body(h, lp, k, v, positions):
        self_attn = _prefixed("attn", _sub(lp, "self_attn"))
        hn = apply_norm(cfg, lp, "norm1", h)
        if kv_out is not None:
            kv_out.append(attn.prefill_kv_cache(cfg, self_attn, hn, positions))
        h = h + attn.attention_block(cfg, self_attn, hn, positions, causal=True)
        h = h + _cross_attention(cfg, _sub(lp, "cross_attn"), apply_norm(cfg, lp, "norm_x", h),
                                 k, v)
        return (h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h)),)

    layer = _remat_wrap(body, remat)
    for lp in layer_params(p, cfg.num_layers, "dec_layers"):
        k, v = _cross_kv(cfg, _sub(lp, "cross_attn"), enc_out)
        (h,) = layer(h, {n: x for n, x in lp.items() if n not in _CROSS_KV}, k, v, positions)
    return h


def forward(cfg, p: Params, batch, impl: str = "auto", remat=True, **_):
    """batch {frames [B, T, frontend_dim], tokens [B, S]} -> (logits [B, S,
    V], aux 0). ``remat`` (True by default, as in the JAX package)
    rematerializes each decoder layer for the backward; ``"dots"`` keeps
    the layer's weight products (``transformer._remat_wrap``). ``impl`` and any other keyword are accepted and
    ignored, as the JAX ``forward``'s ``**_`` does: no kernel is on this
    path."""
    del impl
    enc_out = encode(cfg, p, batch["frames"])
    logits = unembed(cfg, p, _decoder(cfg, p, batch, enc_out, remat=remat))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg, p: Params, batch, impl: str = "auto", remat=True, **_):
    """-> (cross entropy + aux, {"ce", "aux"}); ``batch["loss_mask"]``
    optional; ``impl`` ignored and ``remat`` as in :func:`forward`."""
    logits, aux = forward(cfg, p, batch, impl=impl, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg, p: Params, batch, impl: str = "auto", **_):
    """Prompt forward -> (last-position logits [B, V], {"kv": the decoder
    self-attention's KV caches, leaves stacked [L, B, S, ...], "enc_out":
    the encoder's output}). ``impl`` ignored, as in :func:`forward`. The
    JAX ``prefill`` runs the encoder twice and the decoder twice (once in
    ``forward``, once for the caches); the same layers run once here, and
    the logits are unembedded at every position, as there, before the last
    is taken."""
    del impl
    enc_out = encode(cfg, p, batch["frames"])
    kvs = []
    logits = unembed(cfg, p, _decoder(cfg, p, batch, enc_out, kvs))
    kv = attn.KVCache(*(torch.stack([getattr(c, f) for c in kvs]) for f in attn.KVCache._fields))
    return logits[:, -1], {"kv": kv, "enc_out": enc_out}
