"""PyTorch/CUDA port of the ``repro`` package (JAX + Pallas).

The port keeps the JAX package's public layouts (weights ``[in, out]``
applied as ``x @ W``, layer-stacked params ``[L, ...]``, KV pools
``[L, N, page_size, Hkv, hd]``) so the two can be compared tensor for
tensor. It imports ``torch`` and nothing of the JAX package.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and that raises when no GPU is present.
"""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def strict_fp32():
    """Run float32 work in full float32 on the card, as the JAX reference
    computes it: cuDNN convolutions without TF32 (its default keeps ~3
    decimal digits) and float32 matmul precision ``"highest"``. Every other
    cuDNN flag keeps its current value; both settings are restored on exit.
    The federated round, its evaluator and the centralized baseline run
    under this."""
    prec = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)
