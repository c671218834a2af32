"""Round-resumable checkpoints: npz payload + JSON manifest (port of
``repro/checkpoint/io.py``, in its format).

Leaves are keyed by their ``/``-joined keypath (the bridge's flat keys,
which are the JAX package's ``tree_flatten_with_path`` keys of the same
params dict) in one ``arrays.npz``; ``manifest.json`` holds each leaf's
shape and dtype name, in the JAX package's leaf order, and the caller's
metadata (round index, ...). A checkpoint written by either package loads
in the other.

bf16 leaves: the JAX package saves them as ``ml_dtypes.bfloat16`` arrays,
which ``np.savez`` stores as raw two-byte records (``V2``), and names them
``"bfloat16"`` in the manifest. This module needs no ``ml_dtypes`` (the
card's machine has none): it writes a bf16 tensor's ``uint16`` bits as
the same ``V2`` records and reads a ``"bfloat16"`` leaf back through its
bits, so the round trip is bitwise.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge


def save(path: str, params: Mapping[str, Any], meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``params`` (a flat ``{keypath: tensor}`` dict or a nested one)
    and ``meta`` under the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = bridge.flatten(params)
    arrays, leaves = {}, {}
    for k in sorted(flat, key=lambda key: key.split("/")):  # jax.tree's dict order
        t = flat[k]
        if t.dtype == torch.bfloat16:
            a, name = bridge.tensor_to_numpy(t, bf16_bits=True).view(np.dtype("V2")), "bfloat16"
        else:
            a = bridge.tensor_to_numpy(t)
            name = str(a.dtype)
        arrays[k] = a
        leaves[k] = {"shape": list(a.shape), "dtype": name}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"leaves": leaves, "meta": meta or {}}, f, indent=1, default=_json_default)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return o.tolist()
    raise TypeError(type(o))


def restore(path: str, like: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore into the keys, shapes, dtypes and devices of ``like`` (flat or
    nested dict of tensors) -> (params shaped as ``like``, meta). A leaf
    saved in another dtype is cast to ``like``'s, as the JAX package's
    ``restore`` casts."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = bridge.flatten(like)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, v in flat_like.items():
            if k not in data.files:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            arr = data[k]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} vs model "
                                 f"{tuple(v.shape)}")
            if manifest["leaves"][k]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.copy())
            out[k] = t.to(device=v.device, dtype=v.dtype)
    nested = any(isinstance(v, Mapping) for v in like.values())
    return (bridge.unflatten(out) if nested else out), manifest["meta"]
