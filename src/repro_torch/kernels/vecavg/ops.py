"""Vectorized averaging: the CUDA kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors.

Dispatch is by the device of the input alone. A CUDA tensor reaches the
kernel or raises (bad dtype, shape, too many leaves, a failed build or
launch); there is no fallback. ``launches["vecavg"]`` counts kernel
launches, one a call, and is bumped only where the kernel is launched, so
a run can prove its server reduce went through it.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the plain
version for its outputs' shapes and dtypes and adds one to
``meta_launches``: what the card would launch for the same call, counted
where the CUDA path launches, never in ``launches``. This is no fallback:
``meta`` carries no data, so nothing is computed. Any device other than
``cpu``, ``cuda`` and ``meta`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vecavg import ref

launches: Dict[str, int] = {"vecavg": 0}
meta_launches: Dict[str, int] = {"vecavg": 0}  # what the card would launch (meta tensors)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PER_16B = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
_MAX_CLIENTS = 1536  # the kernel keeps C x 4 warps floats in shared memory
MAX_LEAVES = 256  # the kernel's largest leaf table (at least 4x any config's leaves)
_CHUNK = 1024  # columns a chunk; csrc/vecavg.cu's kChunk
_LEAF = struct.Struct("<QQqqii")  # csrc/vecavg.cu's Leaf: in, out, n, chunk0, dtypes
_P = ctypes.c_void_p
_I = ctypes.c_int

# csrc/vecavg.cu's C interface; the launch and the occupancy query return a
# cudaError_t
_SIGNATURES = {
    "vecavg_chunk": ([], _I),
    "vecavg_max_leaves": ([], _I),
    "vecavg_occupancy": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    "vecavg_launch": ([ctypes.c_char_p, _I, ctypes.c_longlong, _P, _P, _P, ctypes.c_float, _P,
                       _P, _I, _I, _P], _I),
}

# (device index, stream) -> the kernel's workspace: an int counter that the
# last block of every launch sets back to 0 (zeroed once, here), then the
# blocks' [C, G] float32 partial norms; one per stream, since launches on
# one stream run in order
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (launches, meta_launches):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("vecavg", _SIGNATURES)
    if (lib.vecavg_chunk(), lib.vecavg_max_leaves()) != (_CHUNK, MAX_LEAVES):
        raise RuntimeError("vecavg: ops.py and csrc/vecavg.cu disagree on the chunk or the "
                           "leaf cap")
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


@functools.lru_cache(maxsize=None)
def _resident_blocks(n_leaves: int, C: int, index: int) -> int:
    """Blocks the card holds at once for these shapes: SMs x the blocks an
    SM holds (the occupancy API) of the instance with div or of the one
    without, whichever holds fewer. Both take the same grid, so the sums
    run in the same order and dividing in the kernel gives the bits of
    dividing first."""
    per_sm = []
    with torch.cuda.device(index):
        for has_div in (0, 1):
            blocks = _I()
            _raise_on(_lib().vecavg_occupancy(n_leaves, has_div, C, ctypes.byref(blocks)),
                      "vecavg_occupancy")
            per_sm.append(blocks.value)
    if min(per_sm) < 1:
        raise RuntimeError(f"vecavg: no block of C={C} fits an SM")
    return torch.cuda.get_device_properties(index).multi_processor_count * min(per_sm)


def _workspace(dev: torch.device, stream, n_floats: int) -> torch.Tensor:
    key = (dev.index, stream.cuda_stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < 4 + n_floats:
        ws = torch.zeros(4 + n_floats, dtype=torch.float32, device=dev)
        _workspaces[key] = ws
    return ws


def _f32_on(dev, t, C, what):
    if tuple(t.shape) != (C,):
        raise ValueError(f"vecavg: {what} must be [{C}], got {tuple(t.shape)}")
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _check_leaves(leaves: List[torch.Tensor]):
    """(device, C) of leaves the kernel takes; raises otherwise (checked on
    ``meta`` too, so that the dry run predicts a call the card would
    refuse)."""
    dev = leaves[0].device
    C = leaves[0].shape[0] if leaves[0].dim() else 0
    if not 1 <= C <= _MAX_CLIENTS:
        raise ValueError(f"vecavg: C={C} outside [1, {_MAX_CLIENTS}]")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"vecavg: {len(leaves)} leaves, more than the kernel's cap of "
                         f"{MAX_LEAVES} a call")
    for x in leaves:
        if x.device != dev:
            raise ValueError(f"vecavg: leaves on {x.device} and {dev}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"vecavg: dtype {x.dtype} not supported (float32, bfloat16)")
        if x.dim() < 1 or x.shape[0] != C:
            raise ValueError(f"vecavg: every leaf must be [{C}, ...], got {tuple(x.shape)}")
    return dev, C


def _on_meta(leaves: List[torch.Tensor]) -> None:
    """Count the launch the card would make for ``leaves`` (none when every
    leaf is empty, as ``_launch`` returns before launching)."""
    _check_leaves(leaves)
    if any(x.numel() for x in leaves):
        meta_launches["vecavg"] += 1


def _launch(leaves: List[torch.Tensor], p, scale, div) -> Tuple[List[torch.Tensor],
                                                                 torch.Tensor]:
    """One kernel launch over ``leaves`` (CUDA tensors [C, ...]) -> (one
    output a leaf, shaped like the leaf without its client axis, and the
    per-client squared norms [C] float32)."""
    dev, C = _check_leaves(leaves)
    p32 = _f32_on(dev, p, C, "p")
    if div is not None:
        if div.dtype != torch.float32:
            raise TypeError(f"vecavg: div must be float32, got {div.dtype}")
        div = _f32_on(dev, div, C, "div")
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"vecavg: scale must have one element, got {tuple(scale.shape)}")
        s32, s_value = scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous(), 0.0
    else:
        s32, s_value = None, float(scale)

    # outputs: one flat buffer a dtype, each leaf's at a 16-byte aligned
    # offset so that the kernel's 16-byte stores reach it
    out_dt = [x.dtype if div is None else torch.promote_types(x.dtype, div.dtype)
              for x in leaves]
    offs, size = [], {}
    for x, dt in zip(leaves, out_dt):
        at = -(-size.get(dt, 0) // _PER_16B[dt]) * _PER_16B[dt]
        offs.append(at)
        size[dt] = at + x.numel() // C
    flat = {dt: torch.empty(n, dtype=dt, device=dev) for dt, n in size.items()}
    outs = [flat[dt][at:at + x.numel() // C].view(x.shape[1:])
            for x, dt, at in zip(leaves, out_dt, offs)]
    sqn = torch.empty(C, dtype=torch.float32, device=dev)

    table, keep, chunk = [], [], 0
    for x, o in zip(leaves, outs):
        n = x.numel() // C
        if n == 0:
            continue
        x = x.contiguous()  # the round's stacks already are: no copy
        keep.append(x)
        table.append(_LEAF.pack(x.data_ptr(), o.data_ptr(), n, chunk, _DTYPE_CODE[x.dtype],
                                _DTYPE_CODE[o.dtype]))
        chunk += -(-n // _CHUNK)
    if not table:
        return outs, sqn.zero_()
    G = min(chunk, _resident_blocks(len(table), C, dev.index))
    stream = torch.cuda.current_stream(dev)
    ws = _workspace(dev, stream, C * G)
    err = _lib().vecavg_launch(
        b"".join(table), len(table), chunk, p32.data_ptr(),
        None if div is None else div.data_ptr(), None if s32 is None else s32.data_ptr(),
        s_value, sqn.data_ptr(), ws.data_ptr(), C, G, stream.cuda_stream)
    _raise_on(err, "vecavg launch")
    launches["vecavg"] += 1
    build.check_outputs("vecavg", *outs, sqn)
    return outs, sqn


def vecavg(u: torch.Tensor, p: torch.Tensor, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix form: u [C, D] (float32 or bf16), p [C], scale (a number or a
    one-element tensor) -> (delta_w = -scale * p @ u [D] in u's dtype,
    per-client ||u_c||^2 [C] float32). The one-leaf case of the tree form's
    kernel."""
    if u.device.type == "cpu":
        return ref.vecavg(u, p, scale)
    if u.device.type == "meta":
        _on_meta([u])
        return ref.vecavg(u, p, scale)
    if u.device.type != "cuda":
        raise ValueError(f"vecavg: no kernel for {u.device}")
    if u.dim() != 2:
        raise ValueError(f"vecavg: u must be [C, D], got {tuple(u.shape)}")
    (dw,), sqn = _launch([u], p, scale, None)
    return dw, sqn


def vecavg_tree(grads_stacked: Dict[str, torch.Tensor], p, scale, div=None):
    """Tree form: a dict of leaves [C, ...] -> (delta_w dict, sqnorms [C]).

    delta_w[k] = -scale * sum_c p_c * (leaf_c / div_c) and sqnorms the
    full-model norm of each client's divided row, over every leaf in
    ``jax.tree`` order (sorted keys). ``div`` [C] (optional) is the JAX
    package's ``tree_map(lambda x: x / tau, ...)`` folded in; without it
    nothing is divided. Each output has its leaf's dtype, promoted with
    ``div``'s as the division would. On the card: one launch that reads
    every leaf where it lies and writes each output directly, no
    concatenated copy and no divided tree.
    """
    keys = sorted(grads_stacked)
    dev = grads_stacked[keys[0]].device
    if dev.type == "cpu":
        return ref.vecavg_tree(grads_stacked, p, scale, div)
    if dev.type == "meta":
        _on_meta([grads_stacked[k] for k in keys])
        return ref.vecavg_tree(grads_stacked, p, scale, div)
    if dev.type != "cuda":
        raise ValueError(f"vecavg: no kernel for {dev}")
    outs, sqn = _launch([grads_stacked[k] for k in keys], p, scale, div)
    return dict(zip(keys, outs)), sqn
