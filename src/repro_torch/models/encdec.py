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
``[L, ...]``. The stacks are Python loops over layers; the JAX package's
``jax.checkpoint`` around each layer is rematerialization for its
backward and changes no number, so it is not ported.

The JAX package's functions take ``impl`` and every other keyword through
``**_`` and ignore them: whisper's attention is ``attention_block``'s
``auto`` path (direct at its lengths) and ``_direct_attention``, and its
norm is layernorm, so no kernel of the port is on this path. The port's
functions do the same. There is no decode (the JAX package has none for
whisper either).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Params, apply_norm, cross_entropy,
                                       dense_init, embed_init, mlp_apply,
                                       mlp_init, norm_init, promoted_matmul)
from repro_torch.models.transformer import _prefixed, _sub, layer_params


def init_params(cfg, gen: Optional[torch.Generator] = None, *, seed: int = 0,
                device=None) -> Params:
    """Random params with the keys and shapes of the JAX package's
    ``encdec.init_params``, drawn from ``gen`` (or a fresh generator seeded
    with ``seed``) on ``device`` (default ``cuda``): weights N(0, 1/in_dim),
    embeddings and positions N(0, 0.02^2), norms and biases zero."""
    dev = resolve_device(device)
    if gen is None:
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
    """frames [B, T_enc, frontend_dim] -> [B, T_enc, d]."""
    dt = getattr(torch, cfg.compute_dtype)
    h = promoted_matmul(frames, p["frame_proj"]).to(dt)
    h = h + p["enc_pos"][:h.shape[1]][None].to(dt)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for lp in layer_params(p, cfg.encoder_layers, "enc_layers"):
        h = h + attn.attention_block(cfg, lp, apply_norm(cfg, lp, "norm1", h), positions,
                                     causal=False)
        h = h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h))
    return apply_norm(cfg, p, "enc_final_norm", h)


def _cross_attention(cfg, lp: Params, h, enc_out):
    """Queries from the decoder states, K/V from the encoder's output, no
    RoPE, no mask. ``lp`` holds one layer's ``cross_attn/*`` leaves without
    the prefix."""
    B, S, _ = h.shape
    T = enc_out.shape[1]
    q, k, v = h @ lp["w_q"], enc_out @ lp["w_k"], enc_out @ lp["w_v"]
    if "b_q" in lp:
        q, k, v = q + lp["b_q"], k + lp["b_k"], v + lp["b_v"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    o = attn._direct_attention(q, k, v, torch.arange(S, device=h.device),
                               torch.arange(T, device=h.device), causal=False, window=0)
    return o.reshape(B, S, cfg.q_dim) @ lp["w_o"]


def _decoder(cfg, p: Params, batch, enc_out, kv_out=None):
    """The decoder stack on ``batch["tokens"]`` -> final hidden states
    (before ``final_norm``); with ``kv_out`` a list, each layer's prefill
    KV cache of its self-attention is appended to it."""
    dt = getattr(torch, cfg.compute_dtype)
    h = p["embed"][batch["tokens"].long()].to(dt)
    S = h.shape[1]
    h = h + p["pos_embed"][:S][None].to(dt)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    for lp in layer_params(p, cfg.num_layers, "dec_layers"):
        self_attn = _prefixed("attn", _sub(lp, "self_attn"))
        hn = apply_norm(cfg, lp, "norm1", h)
        if kv_out is not None:
            kv_out.append(attn.prefill_kv_cache(cfg, self_attn, hn, positions))
        h = h + attn.attention_block(cfg, self_attn, hn, positions, causal=True)
        h = h + _cross_attention(cfg, _sub(lp, "cross_attn"), apply_norm(cfg, lp, "norm_x", h),
                                 enc_out)
        h = h + mlp_apply(cfg, lp, apply_norm(cfg, lp, "norm2", h))
    return h


def _unembed(cfg, p: Params, h):
    return apply_norm(cfg, p, "final_norm", h) @ p["embed"].T


def forward(cfg, p: Params, batch, impl: str = "auto", **_):
    """batch {frames [B, T, frontend_dim], tokens [B, S]} -> (logits [B, S,
    V], aux 0). ``impl`` and any other keyword are accepted and ignored, as
    the JAX ``forward``'s ``**_`` does: no kernel is on this path."""
    del impl
    enc_out = encode(cfg, p, batch["frames"])
    logits = _unembed(cfg, p, _decoder(cfg, p, batch, enc_out))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg, p: Params, batch, impl: str = "auto", **_):
    """-> (cross entropy + aux, {"ce", "aux"}); ``batch["loss_mask"]``
    optional; ``impl`` ignored, as in :func:`forward`."""
    logits, aux = forward(cfg, p, batch, impl=impl)
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
    logits = _unembed(cfg, p, _decoder(cfg, p, batch, enc_out, kvs))
    kv = attn.KVCache(*(torch.stack([getattr(c, f) for c in kvs]) for f in attn.KVCache._fields))
    return logits[:, -1], {"kv": kv, "enc_out": enc_out}
