"""A stand-in for a tensor on a device the port has no kernel for (neither
the CPU, nor CUDA, nor ``meta``): shapes, a dtype and an ``xpu`` device,
enough for a kernel wrapper to reach its device check."""
import math

import torch


class Elsewhere:
    def __init__(self, *shape, dtype=torch.float32):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device("xpu")

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)
