"""Meshes over the ranks of a process group, and starting the ranks (port
of ``repro/launch/mesh.py``, the client axis).

The JAX package lays a mesh over the devices of one program. Here each
position of the mesh is a rank: one process, set up by ``init_ranks``
(``torch.distributed``), started by ``spawn`` or by ``python -m
torch.distributed.run``. The builders read the world size of the process
group (1 when none is set up).

**Backend and device are explicit.** ``backend="nccl"`` needs one card a
rank and puts rank r on ``cuda:r``; a world larger than the card count
raises. ``backend="gloo"`` puts every rank on the device its caller
names: ``cuda:0`` when K ranks share one card, ``cpu`` in the tests.
Nothing picks a backend or a device on its own.

The mesh is the port's own small class, ``FederatedMesh``: axis names,
shape, this rank's coordinates, its device and two process groups: the
client axes' (the ranks that share this rank's model coordinate) and the
model axis' (the ranks that share its client coordinates). Ranks lie
row-major over the axes, so the model axis is the innermost: ranks
``s*M .. s*M + M - 1`` hold the M pieces of client shard s's parameters.
``torch.distributed.device_mesh.DeviceMesh`` accepts gloo ranks that share
one card too, but the client axis is two mesh dimensions ('pod', 'data')
whose joined group DeviceMesh exposes only through API that differs
between torch releases.
"""
from __future__ import annotations

import math
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# The mesh axes the federated CLIENT dimension shards over (DESIGN.md §6).
CLIENT_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"  # the axis the parameters partition over (sharding/partition.py)

RANK_TIMEOUT_S = 300.0  # a collective that waits longer raises in its rank
FAILURE_GRACE_S = 10.0  # after a rank fails, how long the others may take to exit


class FederatedMesh:
    """A mesh over the ranks of the process group, one rank a position.

    ``shape`` maps axis name to extent (as ``jax.sharding.Mesh.shape``);
    ``coords`` gives this rank's index on each axis (row-major over the
    ranks); ``group`` is the process group of the client axes through this
    rank (the ranks that share its model coordinate; None in a world of one
    rank, where nothing is exchanged), ``model_group`` that of the model
    axis (the ranks that share its client coordinates; None without a
    model axis)."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int], *, rank: int,
                 device: torch.device, group, model_group=None):
        self.axes = tuple(axes)
        self.extents = tuple(int(s) for s in shape)
        self.rank = rank
        self.device = device
        self.group = group
        self.model_group = model_group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.extents))

    @property
    def size(self) -> int:
        return math.prod(self.extents)

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for a, s in zip(reversed(self.axes), reversed(self.extents)):
            out[a], r = r % s, r // s
        return {a: out[a] for a in self.axes}

    @property
    def model_size(self) -> int:
        """The model axis' extent (1 without one)."""
        return self.shape.get(MODEL_AXIS, 1)

    def __repr__(self) -> str:
        backend = dist.get_backend() if dist.is_initialized() and self.size > 1 else None
        return f"FederatedMesh({self.shape}, rank={self.rank}, device={self.device}, backend={backend})"


def world_size() -> int:
    """Ranks in the process group (1 when none is set up)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _start_hint(n: int) -> str:
    return (f"start {n} ranks with `python -m repro_torch.launch.train --mesh data={n}` "
            f"(a model axis: `--data-axis D --model-axis M`, D*M = {n}) or "
            f"`python -m torch.distributed.run --nproc-per-node {n} ...`, or pass "
            "shrink=True for a smoke run")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` under nccl (a ``device``
    naming another raises); under gloo, or with no process group, the
    device the caller names (None: ``cuda``, raising without a card)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        want = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        if device is not None and torch.device(device) != want:
            raise ValueError(f"backend nccl puts this rank on {want}, not {device}; "
                             "use backend='gloo' for ranks that share a device")
        return want
    return resolve_device(device)


def build_mesh(axes: Sequence[str], shape: Sequence[int], *, shrink: bool = False,
               device=None) -> FederatedMesh:
    """The one mesh builder: validate (or shrink) ``shape`` against the
    world size and build the mesh.

    strict (default): raise with a hint naming how to start the ranks when
    the world is smaller than prod(shape). ``shrink=True``: reduce each
    axis, left to right, to the largest divisor of the remaining world
    that does not exceed the requested extent (a world of one rank yields
    an all-ones mesh with the same axis names). A mesh covers the whole
    world; its axes are the client axes ('pod', 'data') and the model axis
    ('model'), and any other axis must have extent 1.

    Every rank builds every process group of the mesh, in one order (a
    rank that skipped one would leave the others waiting in it): the
    client groups, one a model coordinate, then the model groups, one a
    client shard.
    """
    axes = tuple(axes)
    shape = tuple(int(s) for s in shape)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} and shape {shape} length mismatch")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    W = world_size()
    if shrink:
        left, fitted = W, []
        for s in shape:
            s = min(s, left)
            while left % s:
                s -= 1  # largest divisor of `left` that is <= requested
            fitted.append(s)
            left //= s
        shape = tuple(fitted)
    other = {a: s for a, s in zip(axes, shape)
             if a not in CLIENT_AXES and a != MODEL_AXIS and s > 1}
    if other:
        raise ValueError(f"mesh axes {other}: only the client axes {CLIENT_AXES} and "
                         f"{MODEL_AXIS!r} may exceed 1")
    n = math.prod(shape)
    if W < n:
        raise RuntimeError(f"need {n} ranks for mesh {dict(zip(axes, shape))}; have {W} "
                           f"({_start_hint(n)})")
    if W > n:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} covers {n} of the {W} ranks; "
                           "a mesh spans the whole world")
    rank = _rank()
    mesh = FederatedMesh(axes, shape, rank=rank, device=rank_device(device), group=None)
    if W > 1 and mesh.model_size == 1:
        mesh.group = dist.group.WORLD
    elif W > 1:
        by_model, by_shard = {}, {}  # model coordinate / client coordinates -> ranks
        for r in range(W):
            c = FederatedMesh(axes, shape, rank=r, device=mesh.device, group=None).coords
            by_model.setdefault(c[MODEL_AXIS], []).append(r)
            by_shard.setdefault(tuple(v for a, v in c.items() if a != MODEL_AXIS), []).append(r)
        if len(by_shard) == 1:
            mesh.model_group = dist.group.WORLD
        else:
            for groups, attr in ((by_model, "group"), (by_shard, "model_group")):
                for key in sorted(groups):
                    g = dist.new_group(groups[key])
                    if rank in groups[key]:
                        setattr(mesh, attr, g)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, smoke: bool = False,
                         device=None) -> FederatedMesh:
    """The pod mesh (data=16, model=16) = 256 ranks; ``multi_pod`` prepends
    pod=2 for 512. Strict: a smaller world raises with the hint naming how
    to start the ranks. ``smoke=True`` shrinks the same axes onto the
    world, as ``build_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", MODEL_AXIS) if multi_pod else ("data", MODEL_AXIS)
    return build_mesh(axes, shape, shrink=smoke, device=device)


def make_federated_mesh(n: Optional[int] = None, *, pod: int = 1,
                        device=None) -> FederatedMesh:
    """Client-axis mesh for the sharded federated round (DESIGN.md §11):
    axes ('pod', 'data') with pod * data = n ranks (default: the world).
    The [C, ...] client buffers shard over both axes."""
    n = world_size() if n is None else int(n)
    if pod < 1 or n % pod:
        raise ValueError(f"pod={pod} must divide n={n}")
    return build_mesh(CLIENT_AXES, (pod, n // pod), device=device)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> FederatedMesh:
    """Small (data, model) mesh shrunk onto however many ranks exist (tests,
    smoke runs)."""
    return build_mesh(("data", MODEL_AXIS), (data, model), shrink=True, device=device)


def num_clients(mesh: FederatedMesh) -> int:
    """Federated client cohorts = pod * data axis extent (DESIGN.md §6)."""
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


# ---------------------------------------------------------------------------
# process groups and ranks
# ---------------------------------------------------------------------------


def init_ranks(backend: str, *, rank: Optional[int] = None, world: Optional[int] = None,
               init_method: Optional[str] = None, timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Set up this process's rank of the process group.

    ``rank``/``world`` default to ``RANK``/``WORLD_SIZE`` (set by
    ``torch.distributed.run``, whose rendezvous ``env://`` is then the
    default ``init_method``). nccl needs a card a rank: a world larger
    than ``torch.cuda.device_count()`` raises, naming gloo."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; valid: 'gloo', 'nccl'")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend nccl puts one rank on each card: {world} ranks need {world} "
                f"cards, this machine has {cards}; use backend='gloo' for ranks that "
                "share a card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank, timeout=timedelta(seconds=timeout_s))


class RankFailed(RuntimeError):
    """A spawned rank exited with an error (its traceback is the message)."""


def _rank_main(fn: Callable, rank: int, world: int, backend: str, rendezvous: str,
               out_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        init_ranks(backend, rank=rank, world=world, init_method=f"file://{rendezvous}")
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, backend: str, *args,
          timeout_s: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks (processes started by
    ``spawn``, one process group over a ``file://`` rendezvous in a
    temporary directory, so concurrent worlds never race for a port) and
    return each rank's result, rank 0 first. ``fn`` and ``args`` are
    pickled, so ``fn`` is a module-level function. A rank that fails
    stops the others, and its traceback is raised as ``RankFailed``; so is
    a world still running after ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, rdv, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            live = list(procs)
            while live:
                wait = None if deadline is None else max(0.0, deadline - time.monotonic())
                multiprocessing.connection.wait([p.sentinel for p in live], timeout=wait)
                live = [p for p in live if p.exitcode is None]
                if any(p.exitcode not in (None, 0) for p in procs):
                    # the others usually fail in turn at their next collective:
                    # let them write their tracebacks, then report every one
                    multiprocessing.connection.wait([p.sentinel for p in live],
                                                    timeout=FAILURE_GRACE_S)
                    raise RankFailed(_failure(tmp, procs))
                if live and deadline is not None and time.monotonic() >= deadline:
                    raise RankFailed(f"ranks {[procs.index(p) for p in live]} still running "
                                     f"after {timeout_s} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def launch(fn: Callable, world: int, backend: str, *args):
    """Run ``fn(*args)`` on ``world`` ranks and return this process's
    result: in this process for a world of one; as one rank of the world
    of ``torch.distributed.run`` when it started this process (``RANK`` and
    ``WORLD_SIZE`` set); otherwise on ranks ``spawn`` starts, returning
    rank 0's result (``spawn``'s rule: a failed rank fails the run)."""
    if world == 1:
        return fn(*args)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise RuntimeError(f"torch.distributed.run started {os.environ['WORLD_SIZE']} "
                               f"ranks; the mesh needs {world}")
        init_ranks(backend)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    return spawn(fn, world, backend, *args)[0]


def _failure(tmp: str, procs) -> str:
    msgs = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.err")
        if p.exitcode not in (None, 0) or os.path.exists(path):
            text = open(path).read() if os.path.exists(path) else ""
            msgs.append(f"rank {r} exited with code {p.exitcode}\n{text}")
    return "\n".join(msgs)

