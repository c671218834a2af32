"""RMSNorm: CUDA kernel (csrc/), plain version (ref.py), differentiable op (ops.py)."""
