"""Paged-attention ops: the CUDA kernels for CUDA tensors, the plain
versions (``ref.py``) for CPU tensors.

Dispatch is by the device of the tensors alone. A CUDA tensor reaches the
kernel or raises (bad dtype, shape, layout, a failed build or launch);
there is no fallback. ``launches`` counts kernel launches per op and is
bumped only where a kernel is launched, so a run can prove its path went
through the kernels. Both ops update the pools in place.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the plain
version for its outputs' shapes and dtypes and adds one to
``meta_launches``: what the card would launch for the same call, counted
where the CUDA path launches, never in ``launches``. This is no fallback:
``meta`` carries no data, so nothing is computed. The in-place writes
(the decode's new rows, the insert's pages) change no shape and select by
value, so ``meta`` skips them. Any device other than ``cpu``, ``cuda`` and
``meta`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref

launches: Dict[str, int] = {"paged_decode": 0, "paged_insert": 0}
# what the card would launch (meta tensors)
meta_launches: Dict[str, int] = {"paged_decode": 0, "paged_insert": 0}
# the split count, blocks an SM and workspace bytes of the last decode launch
last_decode: Dict[str, int] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for counts in (launches, meta_launches):
        for k in counts:
            counts[k] = 0


# csrc/paged_attention.cu's decode: the head dims it is built for, and G <=
# 4 * (query rows a lane)
_DECODE_HEAD_DIMS = (32, 64, 96, 128)
_DECODE_MAX_G = 16

# csrc/paged_attention.cu's C interface; every launch returns a cudaError_t
_SIGNATURES = {
    "paged_decode_attention_launch": ([_I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P],
                                      _I),
    "paged_decode_occupancy": ([_I] * 4 + [ctypes.POINTER(_I)] * 2, _I),
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def decode_occupancy(dtype: torch.dtype, hd: int, G: int, ps: int, index: int):
    """(shared memory bytes, blocks an SM holds) of the decode instance for
    these shapes on card ``index``, from the kernel's own C side; 0 blocks
    when one does not fit."""
    smem, blocks = _I(), _I()
    with torch.cuda.device(index):
        err = _lib().paged_decode_occupancy(_DTYPE_CODE[dtype], hd, G, ps,
                                            ctypes.byref(smem), ctypes.byref(blocks))
    _raise_on(err, "paged_decode_occupancy")
    return smem.value, blocks.value


def decode_splits(B: int, Hkv: int, P: int, resident: int) -> int:
    """Blocks that one (slot, kv head) splits its page walk into: as many
    as the card holds at once over the grid (``resident`` = SMs x blocks an
    SM, so the grid runs in one wave), and no more splits than the page
    table feeds four warps each. From the shapes and the card alone: never
    from ``pos``, which lives on the card."""
    want = resident // (B * Hkv)
    return max(1, min(want, -(-P // ref.DECODE_WARPS)))


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
    if q.device.type == "meta":
        # the pool write selects rows by value, which meta cannot; it changes
        # no shape, so meta runs the plain attention alone
        meta_launches["paged_decode"] += 1
        return ref.paged_attend(q, k_pool, v_pool, page_table, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    dt = q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention: dtype {dt} not supported")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if hd not in _DECODE_HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the decode kernel is built for "
                         f"{_DECODE_HEAD_DIMS}")
    if G > _DECODE_MAX_G:
        raise ValueError(f"{G} query heads a kv head: the decode kernel takes at "
                         f"most {_DECODE_MAX_G}")
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
    # serve/loop.py hands page_table and pos over as int32 and active as
    # bool, so these are no-ops (no conversion kernel) on the serving path;
    # the kernel reads active as bool bytes
    pt = page_table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    act = active.to(torch.bool).contiguous()
    for name, t in (("page_table", pt), ("pos", pos32)):
        _check_cuda_tensor(name, t, dev, align=4)
    _check_cuda_tensor("active", act, dev, align=1)
    smem, per_sm = decode_occupancy(dt, hd, G, ps, dev.index)
    if per_sm == 0:
        raise ValueError(f"page_size {ps} x head_dim {hd} in {dt}: a decode block would "
                         f"need {smem} B of shared memory, more than an SM gives one")
    splits = decode_splits(B, Hkv, P, _sm_count(dev.index) * per_sm)
    # float32 partials (o [G, hd], then m and l) of every split; freed on
    # return, the caching allocator hands it out again only to work queued
    # after this launch on the same stream
    work = torch.empty(B * Hkv * splits * G * (hd + 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.paged_decode_attention_launch(
        _DTYPE_CODE[dt], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), pt.data_ptr(), pos32.data_ptr(),
        act.data_ptr(), work.data_ptr(), out.data_ptr(), B, Hkv, G, hd, ps, P, splits,
        int(window), 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_decode_attention launch")
    launches["paged_decode"] += 1
    build.check_outputs("paged_decode", out)
    last_decode.update(splits=splits, blocks_per_sm=per_sm, workspace_bytes=work.numel() * 4)
    return out


def paged_insert(k_pool, v_pool, k_src, v_src, page_ids):
    """Layer-stacked prefill-into-pages copy, in place: pools
    [L,N,ps,Hkv,hd], src [L,P,ps,Hkv,hd], page_ids [P] int (-1 =
    unallocated, skipped). Allocated pages are overwritten in full; no
    other page is touched."""
    if k_pool.device.type == "cpu":
        ref.paged_insert(k_pool, v_pool, k_src, v_src, page_ids)
        return
    if k_pool.device.type == "meta":  # an in-place copy: nothing for meta to run
        if page_ids.shape[0]:
            meta_launches["paged_insert"] += 1
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
    build.check_outputs("paged_insert", k_pool, v_pool)
