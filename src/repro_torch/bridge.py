"""Parameter bridge: nested dicts of numpy arrays <-> flat torch dicts.

Keys are the ``/``-joined keypaths of the JAX package's checkpoint format
(``layers/attn/w_q``), so a checkpoint's ``arrays.npz`` and a JAX params
tree passed through ``np.asarray`` both load here. The bridge takes numpy
only: it never imports JAX.

bf16 leaves come out of JAX as numpy arrays of ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects. They travel as their ``uint16`` bit
pattern and are reinterpreted with ``.view(torch.bfloat16)``, so the
round trip is bit exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"a/b/c": leaf}`` (leaf order as the dict's)."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` -> nested dict."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bf16 comes back as ``ml_dtypes.bfloat16`` (the dtype
    JAX hands out), other dtypes as themselves."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # installed with numpy-side bf16 users; torch-free

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Mapping[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """Nested dict (or flat ``/``-keyed dict) of numpy leaves -> flat
    ``{keypath: tensor}`` on ``device``."""
    return {k: tensor_from_numpy(v, device) for k, v in flatten(tree).items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat ``{keypath: tensor}`` -> nested dict of numpy leaves (the
    inverse of :func:`params_from_numpy`)."""
    return unflatten({k: tensor_to_numpy(v) for k, v in params.items()})
