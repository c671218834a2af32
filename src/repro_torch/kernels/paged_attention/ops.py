"""Paged-attention ops: the CUDA kernels for CUDA tensors, the plain
versions (``ref.py``) for CPU tensors.

Dispatch is by the device of the tensors alone. A CUDA tensor reaches the
kernel or raises (bad dtype, shape, layout, a failed build or launch);
there is no fallback. ``launches`` counts kernel launches per op and is
bumped only where a kernel is launched, so a run can prove its path went
through the kernels. Both ops update the pools in place.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref

launches: Dict[str, int] = {"paged_decode": 0, "paged_insert": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# csrc/paged_attention.cu's C interface; every launch returns a cudaError_t
_SIGNATURES = {
    "paged_decode_attention_launch": ([_I] + [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P], _I),
    "paged_insert_launch": ([_P] * 5 + [_I] * 3 + [ctypes.c_longlong, _P], _I),
}


def _lib():
    return build.load("paged_attention", _SIGNATURES)


def _check_cuda_tensor(name, t, device, dtype=None, align=16):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def paged_decode_attention(q, k_pool, v_pool, k_new, v_new, page_table, pos,
                           *, window: int = 0, active=None):
    """One decode tick against the shared page pool: attention of each
    slot's query heads over its pages, with the new token's K/V row written
    into the pools in place (active slots whose target page is allocated).

    q [B,Hq,hd], pools [N,ps,Hkv,hd], k_new/v_new [B,Hkv,hd], page_table
    [B,P] int (-1 = unallocated), pos [B] int, active bool [B] (None = all
    live) -> o [B,Hq,hd] in q.dtype.
    """
    B, Hq, hd = q.shape
    N, ps, Hkv, _ = k_pool.shape
    P = page_table.shape[1]
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=q.device)
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pool, v_pool, k_new, v_new,
                                          page_table, pos, active, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    dt = q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention: dtype {dt} not supported")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if (hd * q.element_size()) % 16:
        raise ValueError(f"head_dim {hd} x {q.element_size()} bytes is not a "
                         "multiple of the kernel's 16-byte vector loads")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match head_dim {hd}")
    if tuple(k_new.shape) != (B, Hkv, hd) or k_new.shape != v_new.shape:
        raise ValueError(f"k_new/v_new must be [{B},{Hkv},{hd}]")
    if tuple(page_table.shape) != (B, P) or tuple(pos.shape) != (B,) \
            or tuple(active.shape) != (B,):
        raise ValueError("page_table [B,P], pos [B], active [B] expected")
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_new", k_new), ("v_new", v_new)):
        _check_cuda_tensor(name, t, dev, dt)
    pt = page_table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    act32 = active.to(torch.int32).contiguous()
    for name, t in (("page_table", pt), ("pos", pos32), ("active", act32)):
        _check_cuda_tensor(name, t, dev, align=4)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.paged_decode_attention_launch(
        _DTYPE_CODE[dt], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), pt.data_ptr(), pos32.data_ptr(),
        act32.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, hd, ps, P,
        int(window), 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_decode_attention launch")
    launches["paged_decode"] += 1
    return out


def paged_insert(k_pool, v_pool, k_src, v_src, page_ids):
    """Layer-stacked prefill-into-pages copy, in place: pools
    [L,N,ps,Hkv,hd], src [L,P,ps,Hkv,hd], page_ids [P] int (-1 =
    unallocated, skipped). Allocated pages are overwritten in full; no
    other page is touched."""
    if k_pool.device.type == "cpu":
        ref.paged_insert(k_pool, v_pool, k_src, v_src, page_ids)
        return
    if k_pool.device.type != "cuda":
        raise ValueError(f"paged_insert: no kernel for {k_pool.device}")
    L, N, ps, Hkv, hd = k_pool.shape
    P = page_ids.shape[0]
    if v_pool.shape != k_pool.shape or tuple(k_src.shape) != (L, P, ps, Hkv, hd) \
            or v_src.shape != k_src.shape:
        raise ValueError(f"paged_insert: pools {tuple(k_pool.shape)} and "
                         f"sources {tuple(k_src.shape)} / page_ids [{P}] disagree")
    dev, dt = k_pool.device, k_pool.dtype
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("k_src", k_src),
                    ("v_src", v_src)):
        _check_cuda_tensor(name, t, dev, dt)
    ids = page_ids.to(torch.int32).contiguous()
    _check_cuda_tensor("page_ids", ids, dev, align=4)
    if P == 0:
        return
    page_bytes = ps * Hkv * hd * k_pool.element_size()
    err = _lib().paged_insert_launch(
        k_pool.data_ptr(), v_pool.data_ptr(), k_src.data_ptr(), v_src.data_ptr(),
        ids.data_ptr(), L, N, P, page_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_insert launch")
    launches["paged_insert"] += 1
