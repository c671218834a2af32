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

from repro_torch import resolve_device
from repro_torch.kernels.rmsnorm import ops as rn_ops

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


def promoted_matmul(x, w):
    """x @ w in the type jnp promotes the two to, as the JAX package's
    product computes it: float32 stub inputs (patches, frames) into bf16
    projectors give float32, where torch refuses the mixed product."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return x.to(ct) @ w.to(ct)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    """``kernels/rmsnorm``: the CUDA kernel for CUDA tensors (forward; the
    backward is the plain formula's gradient in torch ops), the plain
    formula for CPU tensors. The JAX package's ``layers.rmsnorm`` is plain
    jnp and never launches its Pallas kernel (ROADMAP.md P5)."""
    return rn_ops.rmsnorm(x, scale, eps=eps)


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


def mlp_apply(cfg, p: Params, x, prefix: str = "mlp"):
    """``p`` holds one layer's ``{prefix}/*`` leaves (``mlp/w_up``; an MoE
    layer's shared expert is ``moe/shared/w_up``)."""
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p[f"{prefix}/w_gate"]) * (x @ p[f"{prefix}/w_up"])
    else:
        h = x @ p[f"{prefix}/w_up"]
        if f"{prefix}/b_up" in p:
            h = h + p[f"{prefix}/b_up"]
        h = act_fn(cfg.mlp_act)(h)
    y = h @ p[f"{prefix}/w_down"]
    if f"{prefix}/b_down" in p:
        y = y + p[f"{prefix}/b_down"]
    return y


# ---------------------------------------------------------------------------
# rotary embeddings (half-split, float32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies [head_dim / 2] on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, targets, mask=None):
    """Token-level cross entropy in float32. logits [..., V], targets int
    [...]; with ``mask`` [...] the masked mean, its sum clamped at 1."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
