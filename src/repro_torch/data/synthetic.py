"""Synthetic datasets (a copy of ``repro/data/synthetic.py``: ``Dataset``,
``make_classification`` and ``binarize_even_odd``).

Gaussian-mixture image-shaped classification data standing in for MNIST /
CIFAR-10: one Gaussian blob per class in pixel space, matched shapes
(784,) / (28,28,1) / (32,32,3) and label structure (10 classes, even/odd
binarization for the paper's SVM). numpy ``RandomState`` draws, so the
same seed gives the same arrays as the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.y)


def make_classification(
    n: int, input_shape: Tuple[int, ...], num_classes: int = 10,
    *, sep: float = 2.0, noise: float = 1.0, seed: int = 0, task_seed: int = 1234,
) -> Dataset:
    """Gaussian mixture: class c ~ N(mu_c, noise^2 I), |mu_c| ~ sep.

    Class means come from `task_seed` (the TASK identity — train/test splits
    of the same task must share it); sample noise/labels come from `seed`.
    """
    rng = np.random.RandomState(seed)
    dim = int(np.prod(input_shape))
    mus = np.random.RandomState(task_seed).randn(num_classes, dim) * sep / np.sqrt(dim)
    y = rng.randint(0, num_classes, size=n)
    x = mus[y] + rng.randn(n, dim) * noise / np.sqrt(dim)
    return Dataset(x=x.reshape((n,) + tuple(input_shape)).astype(np.float32),
                   y=y.astype(np.int32))


def binarize_even_odd(ds: Dataset) -> Dataset:
    """The paper's SVM label: digit parity."""
    return Dataset(x=ds.x, y=(ds.y % 2).astype(np.int32))
