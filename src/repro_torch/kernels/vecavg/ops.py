"""Vectorized averaging: the CUDA kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors.

Dispatch is by the device of ``u`` alone. A CUDA tensor reaches the kernel
or raises (bad dtype, shape, a failed build or launch); there is no
fallback. ``launches["vecavg"]`` counts kernel launches and is bumped only
where the kernel is launched, so a run can prove its server reduce went
through it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vecavg import ref

launches: Dict[str, int] = {"vecavg": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CLIENTS = 1536  # pass 1 keeps C x 8 warp partials in 48 KB of shared memory
_P = ctypes.c_void_p

# csrc/vecavg.cu's C interface; the launch returns a cudaError_t
_SIGNATURES = {
    "vecavg_tile": ([], ctypes.c_int),
    "vecavg_launch": ([ctypes.c_int] + [_P] * 6 + [ctypes.c_int, ctypes.c_longlong, _P],
                      ctypes.c_int),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    return build.load("vecavg", _SIGNATURES)


def vecavg(u: torch.Tensor, p: torch.Tensor, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix form: u [C, D] (float32 or bf16), p [C], scale (a number or a
    one-element tensor) -> (delta_w = -scale * p @ u [D] in u's dtype,
    per-client ||u_c||^2 [C] float32)."""
    if u.device.type == "cpu":
        return ref.vecavg(u, p, scale)
    if u.device.type != "cuda":
        raise ValueError(f"vecavg: no kernel for {u.device}")
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"vecavg: dtype {u.dtype} not supported (float32, bfloat16)")
    if u.dim() != 2:
        raise ValueError(f"vecavg: u must be [C, D], got {tuple(u.shape)}")
    C, D = u.shape
    if not 1 <= C <= _MAX_CLIENTS:
        raise ValueError(f"vecavg: C={C} outside [1, {_MAX_CLIENTS}]")
    if tuple(p.shape) != (C,):
        raise ValueError(f"vecavg: p must be [{C}], got {tuple(p.shape)}")
    dev = u.device
    u = u.contiguous()
    p32 = p.to(device=dev, dtype=torch.float32).contiguous()
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"vecavg: scale must have one element, got {tuple(scale.shape)}")
        s32 = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    else:
        s32 = torch.full((1,), float(scale), dtype=torch.float32, device=dev)
    out = torch.empty(D, dtype=u.dtype, device=dev)
    sqn = torch.empty(C, dtype=torch.float32, device=dev)
    if D == 0:
        return out, sqn.zero_()
    lib = _lib()
    partial = torch.empty(-(-D // lib.vecavg_tile()) * C, dtype=torch.float32, device=dev)
    err = lib.vecavg_launch(_DTYPE_CODE[u.dtype], u.data_ptr(), p32.data_ptr(),
                            s32.data_ptr(), out.data_ptr(), partial.data_ptr(),
                            sqn.data_ptr(), C, D, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vecavg launch: CUDA error {err} ({torch.cuda.get_device_name(dev)})")
    launches["vecavg"] += 1
    return out, sqn


def vecavg_tree(grads_stacked: Dict[str, torch.Tensor], p, scale):
    """Tree form: a dict of leaves [C, ...] -> (delta_w dict, sqnorms [C]).

    All leaves, in ``jax.tree`` order (sorted keys), are flattened and
    concatenated into one float32 [C, D_total] matrix, so the whole model
    takes one launch; the output is split back and cast to each leaf's
    dtype. sqnorms is the full-model norm of each client's row.
    """
    keys = sorted(grads_stacked)
    C = grads_stacked[keys[0]].shape[0]
    flat = [grads_stacked[k].reshape(C, -1).float() for k in keys]
    mat = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    dw, sqn = vecavg(mat, p, scale)
    outs, off = {}, 0
    for k, f in zip(keys, flat):
        w = f.shape[1]
        leaf = grads_stacked[k]
        outs[k] = dw[off:off + w].reshape(leaf.shape[1:]).to(leaf.dtype)
        off += w
    return outs, sqn
