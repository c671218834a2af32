"""Synthetic datasets (a copy of ``repro/data/synthetic.py``: ``Dataset``,
``make_classification``, ``binarize_even_odd``, ``make_lm_tokens`` and
``lm_batch``).

Gaussian-mixture image-shaped classification data standing in for MNIST /
CIFAR-10: one Gaussian blob per class in pixel space, matched shapes
(784,) / (28,28,1) / (32,32,3) and label structure (10 classes, even/odd
binarization for the paper's SVM), and token sequences drawn from
per-topic unigram distributions for the federated LM. numpy
``RandomState`` draws, so the same seed gives the same arrays as the JAX
package.
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


def make_lm_tokens(
    n_seq: int, seq_len: int, vocab: int, *, n_topics: int = 8,
    topic: int | None = None, seed: int = 0,
) -> Dataset:
    """Token sequences from per-topic unigram distributions.

    topic=None mixes all topics (IID pool); topic=t draws only topic t
    (a Non-IID client). x = tokens[:, :-1]-style pairs are formed by the
    pipeline (tokens / targets shifted by one).
    """
    rng = np.random.RandomState(seed + 1000 * (0 if topic is None else topic + 1))
    # shared topic bank (seeded independently of the per-client stream)
    bank = np.random.RandomState(seed).dirichlet(np.full(vocab, 0.05), size=n_topics)
    seqs = np.empty((n_seq, seq_len + 1), np.int32)
    for i in range(n_seq):
        t = rng.randint(n_topics) if topic is None else topic % n_topics
        seqs[i] = rng.choice(vocab, size=seq_len + 1, p=bank[t])
    return Dataset(x=seqs, y=np.full(n_seq, topic if topic is not None else -1, np.int32))


def lm_batch(ds: Dataset, idx: np.ndarray) -> dict:
    seqs = ds.x[idx]
    return dict(tokens=seqs[:, :-1], targets=seqs[:, 1:])
