"""FedVeca vectorized averaging: CUDA kernel (csrc/), plain version (ref.py), dispatch (ops.py)."""
