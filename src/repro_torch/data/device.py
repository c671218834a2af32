"""Federated data path of the round (port of ``repro/data/device.py``).

Client shards are stacked once into device-resident ``[C, N_max, ...]``
buffers (padded to the largest shard; padding rows are never sampled
because indices are drawn below each client's true size), and each round's
minibatch indices are drawn on the device: no per-round host-to-device
upload of a ``[C, tau_max, batch, ...]`` tensor.

**Per-client index streams.** ``sample`` draws client i's indices from a
``torch.Generator`` seeded from (round key, i), so they depend only on
(key, i, size_i), whatever cohort the client is drawn in. They cannot
match the JAX package's ``jax.random`` streams; cross-framework tests
draw their batches with ``host_stacked_batches`` instead, which both
packages implement with the same numpy calls.

Two batch layouts, as in the JAX package:

  * vision: ``dict(x=[.., b, *obs] float32, y=[.., b] int32)``;
  * LM: raw integer token sequences ``[.., b, L+1]`` split into
    ``dict(tokens=seqs[.., :-1], targets=seqs[.., 1:])``, both int32. LM
    shards carry no ``y``.

**The client axis.** With a federated mesh (``from_datasets(mesh=)``) a
rank holds only its clients' rows, ``[s*C/K, (s+1)*C/K)``
(``sharding.api.client_rows``), and ``sample`` takes GLOBAL client ids:
client i's generator is seeded from (key, i) on every rank, so a sharded
run draws the same minibatches as an unsharded one.

Every entry point here places on ``device``, whose default ``None`` is the
card (``repro_torch.resolve_device``: it raises without one).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import Dataset


def _is_tokens(x) -> bool:
    dt = x.dtype
    if isinstance(dt, torch.dtype):
        return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)
    return np.issubdtype(dt, np.integer)


def format_batch(x, y=None, device=None) -> dict:
    """Raw (x[, y]) arrays or tensors -> the model batch dict on ``device``.

    Integer ``x`` is an LM token stream [*, L+1] -> (tokens, targets);
    float ``x`` is a vision batch -> (x, y)."""
    device = resolve_device(device)
    if _is_tokens(x):
        x = torch.as_tensor(x, device=device)
        return dict(tokens=x[..., :-1].to(torch.int32), targets=x[..., 1:].to(torch.int32))
    return dict(x=torch.as_tensor(x, device=device).to(torch.float32),
                y=torch.as_tensor(y, device=device).to(torch.int32))


def _seed(*words: int) -> int:
    """A 64-bit generator seed from non-negative integers."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


def round_key(seed: int, k: int) -> int:
    """The key of round ``k`` of a run seeded with ``seed``."""
    return _seed(seed, k)


class DeviceShards:
    """Client shards resident on one device: x [n, N_max, ...], y [n, N_max]
    (None for LM token shards, whose x is [n, N_max, L+1] int) and the true
    sizes (host ints) of the n clients this process holds, the global ids
    ``[offset, offset + n)`` of the ``num_clients`` in the run (all of them
    unless a mesh shards the client axis)."""

    def __init__(self, x: torch.Tensor, y: Optional[torch.Tensor], sizes: Sequence[int], *,
                 offset: int = 0, num_clients: Optional[int] = None):
        self.x = x
        self.y = y
        self.sizes = [int(s) for s in sizes]
        self.offset = offset
        self.num_clients = int(x.shape[0]) if num_clients is None else num_clients

    @property
    def rows(self) -> range:
        """The global client ids held here."""
        return range(self.offset, self.offset + int(self.x.shape[0]))

    @property
    def device(self) -> torch.device:
        return self.x.device

    @staticmethod
    def from_datasets(datasets: Sequence[Dataset], device=None, *, mesh=None) -> "DeviceShards":
        """Stack per-client datasets into zero-padded device buffers; with
        ``mesh``, only this rank's clients (on the mesh's device unless
        ``device`` names one)."""
        C = len(datasets)
        rows = range(C)
        if mesh is not None:
            from repro_torch.sharding.api import client_rows

            rows = client_rows(mesh, C)
            device = mesh.device if device is None else device
        device = resolve_device(device)
        held = [datasets[i] for i in rows]
        sizes = [len(d) for d in held]
        n_max = max(sizes)

        def pad_stack(arrs):
            out = np.zeros((len(arrs), n_max) + arrs[0].shape[1:], arrs[0].dtype)
            for i, a in enumerate(arrs):
                out[i, : len(a)] = a
            return torch.from_numpy(out).to(device)

        lm = _is_tokens(held[0].x)
        return DeviceShards(pad_stack([d.x for d in held]),
                            None if lm else pad_stack([d.y for d in held]), sizes,
                            offset=rows.start, num_clients=C)

    def sample(self, key: int, tau_max: int, batch: int, ids=None) -> dict:
        """Draw leaves [M, tau_max, batch, ...] on the device for the clients
        ``ids`` (host GLOBAL ids [M], each held here; every held client
        when None). Client i's indices come from a generator seeded from
        (key, i), so its rows depend neither on which other clients are
        drawn nor on which rank holds it (the JAX package folds the key
        with the global id the same way)."""
        dev = self.device
        n = int(self.x.shape[0])
        if ids is None:
            ids, rows = self.rows, torch.arange(n, device=dev)
        else:
            ids = np.asarray(ids, np.int64).reshape(-1)
            if ids.size and (ids.min() < self.offset or ids.max() >= self.offset + n):
                raise ValueError(f"client ids {ids.tolist()} outside the held {self.rows}")
            # a pageable source is staged before the call returns
            rows = torch.from_numpy(ids - self.offset).to(dev, non_blocking=True)
        idx = torch.stack([
            torch.randint(0, self.sizes[int(i) - self.offset], (tau_max, batch), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(_seed(key, int(i))))
            for i in ids])
        rows = rows[:, None, None]
        y = None if self.y is None else self.y[rows, idx]
        return format_batch(self.x[rows, idx], y, device=dev)


def host_stacked_batches(datasets: List[Dataset], rng, tau_max: int, batch: int,
                         device=None) -> dict:
    """Host path: leaves [C, tau_max, batch, ...], a fresh minibatch per
    local step, drawn with numpy exactly as the JAX package draws them, and
    uploaded whole every round.

    ``rng`` is an ``np.random.Generator`` (the driver loop's RNG); the
    legacy ``RandomState`` is also accepted."""
    draw = rng.integers if isinstance(rng, np.random.Generator) else rng.randint
    xs, ys = [], []
    for d in datasets:
        idx = draw(0, len(d), size=(tau_max, batch))
        xs.append(d.x[idx])
        ys.append(d.y[idx])
    return format_batch(np.stack(xs), np.stack(ys), device=device)
