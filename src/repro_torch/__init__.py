"""PyTorch/CUDA port of the ``repro`` package (JAX + Pallas).

The port keeps the JAX package's public layouts (weights ``[in, out]``
applied as ``x @ W``, layer-stacked params ``[L, ...]``, KV pools
``[L, N, page_size, Hkv, hd]``) so the two can be compared tensor for
tensor. It imports ``torch`` and nothing of the JAX package.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and that raises when no GPU is present.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device with no GPU present raises; it
    never drops to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
