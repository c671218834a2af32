"""Building blocks of the decoder stacks (port of ``repro/models/layers.py``).

Parameters are flat dicts of tensors keyed by ``/``-joined keypaths; weights
are ``[in, out]`` and applied as ``x @ W``, as in the JAX package. Norms and
RoPE compute in float32 and cast back, as there.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers (explicit torch.Generator; numbers differ from jax.random, so
# cross-framework tests carry params over with repro_torch.bridge)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: Optional[float] = None, lead=()) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(in_dim)) drawn in float32, cast to
    ``dtype``. ``lead`` prepends stacking axes (one draw per leading index,
    so no float32 copy of a whole layer stack is ever held)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    out = torch.empty(tuple(lead) + (in_dim, out_dim), dtype=dtype, device=device)
    flat = out.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                        device=device)
        flat[i].copy_(w.mul_(scale))
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    return dense_init(gen, vocab, dim, dtype, device, scale=0.02)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float()) + bias.float()).to(dt)


def norm_init(cfg, dim: int, device, lead=()) -> Params:
    shape = tuple(lead) + (dim,)
    p = {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.norm != "rmsnorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p: Params, prefix: str, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p[f"{prefix}/scale"])
    return layernorm(x, p[f"{prefix}/scale"], p[f"{prefix}/bias"])


def gelu(x):
    """``jax.nn.gelu`` defaults to the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "gelu":
        return gelu
    if name == "sq_relu":
        return lambda x: torch.relu(x).square()
    if name == "silu":
        return F.silu
    raise ValueError(name)


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu (gated) or plain activation
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg, d: int, f: int, dtype, device, lead=()) -> Params:
    p: Params = {}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dtype, device, lead=lead)
        p["w_up"] = dense_init(gen, d, f, dtype, device, lead=lead)
    else:
        p["w_up"] = dense_init(gen, d, f, dtype, device, lead=lead)
        if cfg.mlp_bias:
            p["b_up"] = torch.zeros(tuple(lead) + (f,), dtype=dtype, device=device)
            p["b_down"] = torch.zeros(tuple(lead) + (d,), dtype=dtype, device=device)
    p["w_down"] = dense_init(gen, f, d, dtype, device, lead=lead)
    return p


def mlp_apply(cfg, p: Params, x):
    """``p`` holds one layer's ``mlp/*`` leaves."""
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["mlp/w_gate"]) * (x @ p["mlp/w_up"])
    else:
        h = x @ p["mlp/w_up"]
        if "mlp/b_up" in p:
            h = h + p["mlp/b_up"]
        h = act_fn(cfg.mlp_act)(h)
    y = h @ p["mlp/w_down"]
    if "mlp/b_down" in p:
        y = y + p["mlp/b_down"]
    return y


# ---------------------------------------------------------------------------
# rotary embeddings (half-split, float32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: int, broadcastable to [..., S]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # [hd/2]
    ang = positions[..., None].float() * inv  # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
