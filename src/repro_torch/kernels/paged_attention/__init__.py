"""Paged-attention decode and insert: CUDA kernels (csrc/), plain versions (ref.py), dispatch (ops.py)."""
