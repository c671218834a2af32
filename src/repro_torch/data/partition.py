"""Federated Non-IID partitioners (a copy of ``repro/data/partition.py``):
the paper's Cases 1-3 (§IV-A3) plus the standard Dirichlet split.

Each partitioner maps a labeled dataset to a list of per-client index
arrays. Client weights p_i = D_i / D follow from the partition sizes.
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(n: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    """Case 1: each sample uniformly assigned to a client."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def partition_by_label(labels: np.ndarray, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    """Case 2: all samples on a client share (nearly) one label.

    C <= K: label groups are dealt to clients round-robin (a client sees
    ceil(K/C) labels; exactly one when C == K). C > K: each label's samples
    are SPLIT across the ~C/K clients assigned to it, so every client still
    sees a single label and no client is empty (the paper's 50-client run).
    """
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    K = len(classes)
    shards: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    if num_clients <= K:
        for j, c in enumerate(classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            shards[j % num_clients].append(idx)
    else:
        label_clients: List[List[int]] = [[] for _ in range(K)]
        for cl in range(num_clients):
            label_clients[cl % K].append(cl)
        for j, c in enumerate(classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            for cl, part in zip(label_clients[j], np.array_split(idx, len(label_clients[j]))):
                shards[cl].append(part)
    return [np.sort(np.concatenate(s)) if s else np.array([], np.int64) for s in shards]


def partition_case3(labels: np.ndarray, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    """Case 3: first half of labels -> first half of clients IID;
    second half of labels -> second half of clients label-exclusive."""
    classes = np.unique(labels)
    half_classes = classes[: len(classes) // 2]
    first = np.where(np.isin(labels, half_classes))[0]
    second = np.where(~np.isin(labels, half_classes))[0]
    c1 = num_clients // 2 + num_clients % 2
    c2 = num_clients - c1
    rng = np.random.RandomState(seed)
    perm = rng.permutation(first)
    out = [np.sort(s) for s in np.array_split(perm, c1)]
    out += [
        np.sort(second[s]) for s in _relative_label_shards(labels[second], c2, seed + 1)
    ]
    return out


def _relative_label_shards(labels: np.ndarray, num_clients: int, seed: int):
    parts = partition_by_label(labels, num_clients, seed)
    return parts


def partition_dirichlet(labels: np.ndarray, num_clients: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Standard Dirichlet(alpha) label-skew split (beyond-paper extension)."""
    rng = np.random.RandomState(seed)
    out: List[List[int]] = [[] for _ in range(num_clients)]
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for j, s in enumerate(np.split(idx, cuts)):
            out[j].extend(s.tolist())
    return [np.sort(np.array(s, np.int64)) for s in out]


def client_weights(parts: List[np.ndarray]) -> np.ndarray:
    sizes = np.array([len(s) for s in parts], np.float64)
    return (sizes / sizes.sum()).astype(np.float32)
