"""Kernels of the port: hand-written CUDA for Hopper, built by ``build.py``."""
