"""Building blocks of the decoder stacks (port of ``repro/models/layers.py``).

Parameters are flat dicts of tensors keyed by ``/``-joined keypaths; weights
are ``[in, out]`` and applied as ``x @ W`` through :func:`wmatmul`, as in the
JAX package. Norms and RoPE compute in float32 and cast back, as there.

Under a model axis (``sharding.api.logical_axis_rules`` with a mesh whose
``model`` extent m > 1) the layers run on this rank's pieces of the
parameters (``sharding/partition.py``): a column-parallel product takes its
input through ``api.copy_in``, a row-parallel one gives its partial sum to
``api.reduce_out``; :func:`tp` is the layout the layers read.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.sharding import api
from repro_torch.sharding.partition import ModelLayout, layout

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers (explicit torch.Generator; numbers differ from jax.random, so
# cross-framework tests carry params over with repro_torch.bridge)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: Optional[float] = None, lead=()) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(in_dim)) drawn in float32, cast to
    ``dtype``. ``lead`` prepends stacking axes (one draw per leading index,
    so no float32 copy of a whole layer stack is ever held). On the
    ``meta`` device nothing is drawn: the shapes alone."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    out = torch.empty(tuple(lead) + (in_dim, out_dim), dtype=dtype, device=device)
    if out.is_meta:
        return out
    flat = out.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                        device=device)
        flat[i].copy_(w.mul_(scale))
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    return dense_init(gen, vocab, dim, dtype, device, scale=0.02)


def tp(cfg) -> ModelLayout:
    """The layout the layers of ``cfg`` run on: the active context's model
    extent (1 outside one, where every block is whole)."""
    return layout(cfg, api.model_size())


# ---------------------------------------------------------------------------
# weight products (one function, so that remat="dots" can find them)
# ---------------------------------------------------------------------------

_tape = threading.local()


class ProductTape:
    """The weight products of one block: recorded in the forward
    (``saved``), handed back in the same order in the recompute."""

    def __init__(self, saved=None):
        self.recording = saved is None
        self.saved = [] if saved is None else list(saved)
        self._next = 0

    def take(self):
        y = self.saved[self._next]
        self._next += 1
        return y


def run_with_tape(tape: Optional[ProductTape], fn, *args):
    """``fn(*args)`` with :func:`wmatmul` recording to, or replaying from,
    ``tape``."""
    prev = getattr(_tape, "tape", None)
    _tape.tape = tape
    try:
        return fn(*args)
    finally:
        _tape.tape = prev


class _SavedProduct(torch.autograd.Function):
    """``x2 @ w`` whose value ``y`` was kept (remat="dots"): the forward
    hands ``y`` back, the backward is the product's own (aten's
    ``MmBackward0``: ``mm_mat1_backward`` and ``mm_mat2_backward``, the
    column-major branches included), so the gradients keep their bits."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x2, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2, w, _ = inputs
        ctx.save_for_backward(x2, w)
        ctx.x_colmajor = _colmajor(x2)
        ctx.w_colmajor = _colmajor(w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = w.mm(g.t()).t() if ctx.x_colmajor else g.mm(w.t())
        gw = g.t().mm(x2).t() if ctx.w_colmajor else x2.t().mm(g)
        return gx, gw, None


def _colmajor(t) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def wmatmul(x, w):
    """Every weight product ``x @ w`` ([..., d] @ [d, f], the leading dims
    folded into one 2-D product as torch's matmul folds them), in the type
    jnp promotes the two to: float32 stub inputs (patches, frames) into
    bf16 projectors give float32, where torch refuses the mixed product.
    Inside a ``remat="dots"`` block its outputs are recorded, and in the
    block's recompute handed back instead of computed."""
    ct = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(ct), w.to(ct)
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    tape = getattr(_tape, "tape", None)
    if tape is None or tape.recording:
        y = x2.mm(w)
        if tape is not None:
            tape.saved.append(y)
    else:
        y = _SavedProduct.apply(x2, w, tape.take())
    return y.view(*lead, w.shape[-1])


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
    layer's shared expert is ``moe/shared/w_up``). Under a model axis that
    splits it, ``w_gate``/``w_up`` (and ``b_up``) are column-parallel
    behind ``copy_in`` and ``w_down`` row-parallel, the partial sums
    reduced BEFORE ``b_down`` is added, so the bias counts once."""
    lay = tp(cfg)
    split = lay.shared if prefix.endswith("shared") else lay.mlp
    if split:
        x = api.copy_in(x)
    if cfg.mlp_act == "swiglu":
        h = F.silu(wmatmul(x, p[f"{prefix}/w_gate"])) * wmatmul(x, p[f"{prefix}/w_up"])
    else:
        h = wmatmul(x, p[f"{prefix}/w_up"])
        if f"{prefix}/b_up" in p:
            h = h + p[f"{prefix}/b_up"]
        h = act_fn(cfg.mlp_act)(h)
    y = wmatmul(h, p[f"{prefix}/w_down"])
    if split:
        y = api.reduce_out(y)
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
    # a float32 scalar made by a factory (not copied from a Python number
    # by ``torch.tensor``), so that it also works under ``torch.func`` on meta
    base = torch.full((), float(theta), dtype=torch.float32, device=device)
    return 1.0 / (base ** exps)


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
