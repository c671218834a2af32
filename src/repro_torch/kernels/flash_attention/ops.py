"""Flash attention: the CUDA kernel for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

Dispatch is by the device of ``q`` alone. A CUDA tensor reaches the kernel
or raises (bad dtype, head dim, shape, a failed build or launch); there is
no fallback. ``launches["flash_attention"]`` counts kernel launches and is
bumped only where the kernel is launched, so a run can prove that its
attention went through it.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the plain
version for its outputs' shapes and dtypes and adds one to
``meta_launches``: what the card would launch for the same call, counted
where the CUDA path launches, never in ``launches``. This is no fallback:
``meta`` carries no data, so nothing is computed. Any device other than
``cpu``, ``cuda`` and ``meta`` raises.

The op is forward only, as the JAX package's Pallas kernel is
(``jax.grad`` through it fails): its backward raises on every device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

launches: Dict[str, int] = {"flash_attention": 0}
meta_launches: Dict[str, int] = {"flash_attention": 0}  # what the card would launch (meta)

HEAD_DIMS = (16, 32, 64, 96, 128)  # the kernel's template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# csrc/flash_attention.cu's C interface; the launch returns a cudaError_t
_SIGNATURES = {
    "flash_attention_launch": ([_I, _I] + [_P] * 4 + [_I] * 5 + [_L] * 9
                               + [_I] * 3 + [ctypes.c_float, _P], _I),
    "flash_attention_blocks_per_sm": ([_I, _I], _I),
    "flash_attention_smem_bytes": ([_I, _I], _I),
}


def reset_launches() -> None:
    for counts in (launches, meta_launches):
        for k in counts:
            counts[k] = 0


def _lib():
    return build.load("flash_attention", _SIGNATURES)


def blocks_per_sm(dtype, hd: int) -> int:
    """Blocks of the kernel that fit on one SM at once (the card's
    occupancy for this type and head dim)."""
    return _lib().flash_attention_blocks_per_sm(_DTYPE_CODE[dtype], hd)


def smem_bytes(dtype, hd: int) -> int:
    """Dynamic shared memory a block of the kernel takes, in bytes."""
    return _lib().flash_attention_smem_bytes(_DTYPE_CODE[dtype], hd)


def tma_misfits(t: torch.Tensor) -> list:
    """What keeps TMA from reading ``t`` [B, S, H, hd] in place: a base
    address or a batch, sequence or head stride (of an axis longer than 1)
    that is not a multiple of 16 bytes. Empty when it fits."""
    el = t.element_size()
    bad = [] if t.data_ptr() % 16 == 0 else ["the base address"]
    bad += [f"the {axis} stride ({t.stride(i)} elements)"
            for i, axis in enumerate(("batch", "sequence", "head"))
            if t.shape[i] > 1 and (t.stride(i) * el) % 16]
    return bad


def _launch(q, k, v, causal: bool, window: int, q_offset: int):
    dev, dt = q.device, q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {dt} not supported (float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if B > _MAX_GRID_YZ or Hq > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={B}, Hq={Hq} beyond the grid's {_MAX_GRID_YZ}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                             f"expected {dt} on {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis must have stride 1")
        # the bf16 kernel reads q, k, v by TMA, which takes 16-byte aligned rows only
        bad = tma_misfits(t) if dt == torch.bfloat16 else []
        if bad:
            raise ValueError(f"flash_attention: {name} cannot be read by TMA: "
                             f"{', '.join(bad)} not a multiple of 16 bytes")
    out = torch.empty((B, Sq, Hq, hd), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention_launch(
        _DTYPE_CODE[dt], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, Hkv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), int(q_offset), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch: CUDA error {err} "
                           f"({torch.cuda.get_device_name(dev)})")
    launches["flash_attention"] += 1
    build.check_outputs("flash_attention", out)
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward only. Written in ``torch.func``'s form (``forward`` without
    ctx, ``setup_context``), so that a backward reached through
    ``torch.func.vjp`` (a rematerialized layer's recompute) raises the same
    error as plain autograd."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        if q.device.type == "cpu":
            return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        if q.device.type == "meta":
            out = ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
            if out.numel():  # as _launch, which returns an empty output unlaunched
                meta_launches["flash_attention"] += 1
            return out
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: no kernel for {q.device}")
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad_out):
        raise RuntimeError(
            "flash_attention has no backward: it ports the forward-only Pallas "
            "kernel (repro/kernels/flash_attention/kernel.py), through which "
            "jax.grad fails too; differentiate attention_block(impl='direct' or "
            "'chunked') instead")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                    use_pallas: bool = True, block_q: int = 128, block_k: int = 128):
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.
    Query ``i`` sits at position ``q_offset + i``; keys at ``0..Sk-1``.

    ``use_pallas=False`` selects the plain version on any device (named
    only, as in the JAX ops). ``block_q``/``block_k`` keep the JAX
    signature: they tile the TPU grid there; the CUDA kernel's tiles are
    fixed (bf16 128 x 128; float32 64 query rows by 32 keys at hd 96 and
    128, 64 below) and no result depends on them.
    In bf16 the kernel reads q, k, v by TMA: each must have a 16-byte
    aligned base and batch, sequence and head strides, or the call raises.
    """
    del block_q, block_k
    if not use_pallas:
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window), int(q_offset))
