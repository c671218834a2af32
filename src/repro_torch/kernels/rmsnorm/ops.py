"""RMSNorm as a differentiable op: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors.

The forward dispatches by the device of ``x`` alone. A CUDA tensor reaches
the kernel or raises (bad dtype, shape, a failed build or launch); there is
no fallback. ``launches["rmsnorm"]`` counts kernel launches and is bumped
only where the kernel is launched, so a run can prove its norms went
through it.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the plain
version for its outputs' shapes and dtypes and adds one to
``meta_launches``: what the card would launch for the same call, counted
where the CUDA path launches, never in ``launches``. This is no fallback:
``meta`` carries no data, so nothing is computed. Any device other than
``cpu``, ``cuda`` and ``meta`` raises.

The op is a ``torch.autograd.Function`` written for ``torch.func``:

  * the backward is the gradient of the plain formula, in torch ops on the
    saved ``x`` and ``scale`` (the JAX package has no backward kernel:
    XLA differentiates its ``layers.rmsnorm``). With ``r = rsqrt(mean(x^2)
    + eps)`` and ``gs = g * (1 + scale)``:
    ``dx = r * gs - x * r^3 * mean(gs * x)`` and ``dscale = sum_rows
    g * x * r``, in float32, dx cast to x's dtype;
  * the ``vmap`` rule moves the batch dims to the front and folds them
    into ``groups``, so the federated round's vmapped gradient (per-client
    scale ``[C, d]``, per-client x ``[C, ..., d]``) launches the kernel
    once for all clients.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ref

launches: Dict[str, int] = {"rmsnorm": 0}
meta_launches: Dict[str, int] = {"rmsnorm": 0}  # what the card would launch (meta tensors)

MAX_D = 8192  # csrc/rmsnorm.cu's kMaxD
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_L = ctypes.c_longlong

# csrc/rmsnorm.cu's C interface; the launch returns a cudaError_t
_SIGNATURES = {
    "rmsnorm_launch": ([ctypes.c_int, _P, _L, ctypes.c_int, _L, _P, _L, _L, _P,
                        ctypes.c_float, _P], ctypes.c_int),
}


def reset_launches() -> None:
    for counts in (launches, meta_launches):
        for k in counts:
            counts[k] = 0


def _lib():
    return build.load("rmsnorm", _SIGNATURES)


def _row_stride(t: torch.Tensor):
    """The stride between consecutive rows of ``t`` seen as ``[-1, d]``, or
    None when its rows are not evenly spaced or its last dim is not
    contiguous."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    if t.dim() == 1:
        return t.shape[-1]
    stride = t.stride(-2)
    expect = stride * t.shape[-2]
    for i in range(t.dim() - 3, -1, -1):
        if t.shape[i] != 1 and t.stride(i) != expect:
            return None
        expect *= t.shape[i]
    return stride


def _validate(x: torch.Tensor, scale: torch.Tensor) -> None:
    """What the kernel takes (checked on ``meta`` too, so that the dry run
    predicts a call the card would refuse)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported (float32, bfloat16)")
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise TypeError(f"rmsnorm: scale must be float32 on {x.device}, got {scale.dtype} on "
                        f"{scale.device}")
    d = x.shape[-1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d} outside [1, {MAX_D}]")


def _on_meta(x: torch.Tensor, scale: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    _validate(x, scale)
    out = ref.rmsnorm(x, scale, eps, groups)
    if out.numel():
        meta_launches["rmsnorm"] += 1
    return out


def _launch(x: torch.Tensor, scale: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    dev = x.device
    _validate(x, scale)
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    xs = _row_stride(x)
    if xs is None:
        # the kernel reads rows at one stride with the last dim contiguous:
        # any other layout takes this one explicit copy
        x = x.contiguous()
        xs = d
    ss = _row_stride(scale)
    if ss is None:
        scale = scale.contiguous()
        ss = d
    n = out.numel() // d
    err = _lib().rmsnorm_launch(_DTYPE_CODE[x.dtype], x.data_ptr(), n, d, xs,
                                scale.data_ptr(), ss, n // groups, out.data_ptr(), eps,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch: CUDA error {err} ({torch.cuda.get_device_name(dev)})")
    launches["rmsnorm"] += 1
    build.check_outputs("rmsnorm", out)
    return out


def _check(x, scale, groups: int):
    d = x.shape[-1]
    want = (d,) if groups == 1 else (groups, d)
    if tuple(scale.shape) != want or (groups > 1 and (x.dim() < 2 or x.shape[0] != groups)):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and scale {tuple(scale.shape)} do not "
                         f"fit groups={groups} (x [G, ..., d] with scale [G, d])")


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(x, scale, groups: int, eps: float):
        _check(x, scale, groups)
        if x.device.type == "cpu":
            return ref.rmsnorm(x, scale, eps, groups)
        if x.device.type == "meta":
            return _on_meta(x, scale, groups, eps)
        if x.device.type != "cuda":
            raise ValueError(f"rmsnorm: no kernel for {x.device}")
        return _launch(x, scale, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, groups, eps = inputs
        ctx.save_for_backward(x, scale)
        ctx.groups, ctx.eps = groups, eps

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        groups = ctx.groups
        xf, gf = x.float(), g.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        gs = gf * (1.0 + ref.group_scale(scale, groups, x.dim()))
        dx = r * gs - xf * r.pow(3) * (gs * xf).mean(-1, keepdim=True)
        gxr = gf * xf * r
        d = x.shape[-1]
        ds = gxr.reshape(-1, d).sum(0) if groups == 1 else gxr.reshape(groups, -1, d).sum(1)
        return dx.to(x.dtype), ds.to(scale.dtype), None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, groups, eps):
        xd, sd = in_dims[0], in_dims[1]
        n = info.batch_size
        x = x.movedim(xd, 0) if xd is not None else x.expand((n,) + x.shape)
        if sd is None:
            if groups == 1:  # one scale for every row: the batch dim is more rows
                return RMSNorm.apply(x, scale, 1, eps), 0
            # scale's groups lead x's logical dims: keep them in front
            return RMSNorm.apply(x.movedim(0, 1), scale, groups, eps), 1
        scale = scale.movedim(sd, 0)
        if groups == 1:
            if n == 1:  # a batch of one (one client a rank): its scale is every row's
                return RMSNorm.apply(x, scale[0], 1, eps), 0
            return RMSNorm.apply(x, scale, n, eps), 0
        out = RMSNorm.apply(x.flatten(0, 1), scale.flatten(0, 1), n * groups, eps)
        return out.unflatten(0, (n, groups)), 0


def rmsnorm(x, scale, *, eps: float = 1e-6, groups: int = 1, use_pallas: bool = True):
    """x [..., d] (float32 or bf16), scale [d] float32 -> [..., d] in x's
    dtype; with ``groups = G > 1``, x [G, ..., d] and scale [G, d].

    ``use_pallas=False`` selects the plain version on any device (named
    only, as in the JAX ops; autograd then differentiates it op by op)."""
    if not use_pallas:
        return ref.rmsnorm(x, scale, eps, groups)
    return RMSNorm.apply(x, scale, int(groups), float(eps))
