"""Flash attention (forward): CUDA kernel (csrc/), plain version (ref.py), dispatch (ops.py)."""
