"""The client axis of a federated mesh (port of ``repro/sharding/api.py``,
the client half).

The JAX package places ``[C, ...]`` client arrays with a ``NamedSharding``
over the client axes ('pod', 'data') and lets ``psum`` complete the
reduces inside ``shard_map``. Here rank s of K holds the client rows
``[s*C/K, (s+1)*C/K)`` (``client_rows``) and the reduces are completed
with one collective over the client-axis process group
(``client_group``): ``all_reduce`` and ``all_gather``, which take the
tensors where they lie (CUDA tensors on the card; gloo accepts them).

The logical half (``logical_axis_rules``, ``spec_for``, ``constrain``,
``DEFAULT_RULES``) is the model axis, ROADMAP.md A18b.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import CLIENT_AXES, FederatedMesh


def client_axes(mesh: FederatedMesh) -> Tuple[str, ...]:
    """The mesh axes the federated client dimension shards over, in mesh
    order: ('pod', 'data') filtered to the axes this mesh has."""
    return tuple(a for a in CLIENT_AXES if a in mesh.shape)


def client_shard_count(mesh: FederatedMesh) -> int:
    """Number of client-axis shards = product of the client axes' extents."""
    n = 1
    for a in client_axes(mesh):
        n *= mesh.shape[a]
    return n


def validate_client_count(mesh: Optional[FederatedMesh], num_clients: int) -> int:
    """The ONE client-axis divisibility rule (data, engine, controller and
    buffer all call it): C must divide evenly over the client-axis shards.
    Returns the shard count (1 for mesh=None)."""
    if mesh is None:
        return 1
    k = client_shard_count(mesh)
    if k > 1 and num_clients % k:
        raise ValueError(
            f"C={num_clients} clients must divide evenly over {k} "
            f"client-axis shards ({mesh.shape})")
    return k


def shard_index(mesh: FederatedMesh) -> int:
    """This rank's position along the client axes (row-major)."""
    s, coords = 0, mesh.coords
    for a in client_axes(mesh):
        s = s * mesh.shape[a] + coords[a]
    return s


def client_rows(mesh: FederatedMesh, num_clients: int) -> range:
    """The global client ids this rank holds, ``[s*C/K, (s+1)*C/K)``: the
    port's form of the JAX package's ``client_spec``/``client_sharding``."""
    k = validate_client_count(mesh, num_clients)
    n = num_clients // k
    s = shard_index(mesh)
    return range(s * n, (s + 1) * n)


def client_group(mesh: FederatedMesh):
    """The process group of the client axes, or None when there is one
    shard (nothing to exchange)."""
    return mesh.group if client_shard_count(mesh) > 1 else None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# collectives issued by this process and the bytes of their buffers (this
# rank's input): the client axis's traffic, as ``launches`` counts kernels
collectives: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def all_reduce(tensors: List[torch.Tensor], group, op: str = "sum") -> List[torch.Tensor]:
    """Reduce ``tensors`` over the client-axis ranks: one collective a
    dtype (the tensors of a dtype travel as one flat buffer). Returns new
    tensors of the inputs' shapes; the inputs are left as they were."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=_OPS[op], group=group)
        collectives["all_reduce"] += 1
        collectives["bytes"] += flat.numel() * flat.element_size()
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def all_reduce_tree(tree: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``all_reduce`` (sum) over the leaves of a flat dict tree."""
    keys = sorted(tree)
    return dict(zip(keys, all_reduce([tree[k] for k in keys], group)))


_TIMED_CALLS, _TIMING_BUDGET_S = 20, 2.0


def time_all_reduce(numel: int, group, device) -> float:
    """Mean ms of one float32 all-reduce of ``numel`` elements over the
    client-axis ranks, each call started with every rank's device idle
    (a sync and a barrier), so it is the collective alone: under gloo the
    copies to and from the host and the exchange. Up to 20 calls, fewer
    when they pass 2 s (at least one; rank 0 decides, so every rank makes
    the same calls). Call it after collectives of this size ran, so that
    the first call is warm."""
    x = torch.ones(numel, dtype=torch.float32, device=device)
    go = torch.ones(1, dtype=torch.float32, device=device)
    times = []
    for _ in range(_TIMED_CALLS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.all_reduce(go, op=dist.ReduceOp.MIN, group=group)  # the barrier and rank 0's word
        if go.item() == 0:
            break
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        go.fill_(float(sum(times) < _TIMING_BUDGET_S or dist.get_rank() != 0))
    return 1e3 * sum(times) / len(times)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows ``x`` [n, ...] -> every rank's, [K * n, ...] in
    rank order (the client order of the mesh)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    collectives["all_gather"] += 1
    collectives["bytes"] += x.numel() * x.element_size()
    return torch.cat(parts)
