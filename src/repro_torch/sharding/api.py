"""The client axis of a federated mesh and the logical axes of the model
axis (port of ``repro/sharding/api.py``).

The JAX package places ``[C, ...]`` client arrays with a ``NamedSharding``
over the client axes ('pod', 'data') and lets ``psum`` complete the
reduces inside ``shard_map``. Here rank s of K holds the client rows
``[s*C/K, (s+1)*C/K)`` (``client_rows``) and the reduces are completed
with one collective over the client-axis process group
(``client_group``): ``all_reduce`` and ``all_gather``, which take the
tensors where they lie (CUDA tensors on the card; gloo accepts them).

**The logical half** (``DEFAULT_RULES``, ``logical_axis_rules``,
``current_mesh``, ``spec_for``, ``constrain``) keeps the JAX package's
interface: a thread-local context maps logical axis names to mesh axes.
There GSPMD lays activations out from those constraints and inserts the
collectives; here the layout is made by construction (the rank holds its
pieces of the parameters, ``sharding/partition.py``) and ``constrain``
returns ``x`` untouched. The model axis' collectives are explicit, three
``torch.autograd.Function``s in ``torch.func``'s form (a ``vmap`` rule
that issues ONE collective for the whole batched tensor, as c10d calls
are no functorch ops): ``copy_in`` (forward identity, backward all-reduce)
before every column-parallel product, ``reduce_out`` (forward all-reduce,
backward identity) after every row-parallel one, and ``gather_last``
(forward all-gather on the last dim, backward the rank's slice). Outside
a context, or at model extent 1, all three are the identity, so a
single-rank run keeps its bits.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import CLIENT_AXES, MODEL_AXIS, FederatedMesh

MeshAxes = Union[None, str, Tuple[str, ...]]


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
# the same bytes by kind (the dry run's table, launch/dryrun.py)
collective_bytes: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def _count(kind: str, t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    collectives[kind] += 1
    collectives["bytes"] += n
    collective_bytes[kind] += n


def reset_collectives() -> None:
    for counts in (collectives, collective_bytes):
        for k in counts:
            counts[k] = 0


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
        _count("all_reduce", flat)
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
    _count("all_gather", x)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# the logical half: axis rules and the model axis' collectives
# ---------------------------------------------------------------------------

_state = threading.local()

DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "client": ("pod", "data"),
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,
    "seq": None,
    "kv_seq": None,
}


@contextlib.contextmanager
def logical_axis_rules(mesh: FederatedMesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Within the block, logical axis names resolve against ``mesh`` (the
    JAX package's context) and the model layers run on this rank's pieces
    of the parameters, completing their products over ``mesh``'s model
    group."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield
    finally:
        _state.ctx = prev


def current_context():
    """The active ``(mesh, rules)``, or None: what a recomputation taken
    later (``models.transformer._Remat``'s backward) re-enters."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def restored_context(ctx):
    """Re-enter a context captured by ``current_context`` (None: none)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh() -> Optional[FederatedMesh]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def _mesh_axes_for(name, rules, mesh) -> Tuple[str, ...]:
    ax = rules.get(name) if name else None
    if ax is None:
        return ()
    if isinstance(ax, str):
        ax = (ax,)
    return tuple(a for a in ax if a in mesh.shape)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]]):
    """Logical axes -> a spec (a tuple of None / axis name / tuple of
    names) for a concrete shape, or None outside a context; a mapping whose
    mesh axes do not divide the dimension evenly drops to None, as in the
    JAX package."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return None
    mesh, rules = ctx
    out, used = [], set()
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in _mesh_axes_for(name, rules, mesh) if a not in used)
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if axes and total > 1 and dim % total == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The JAX package's sharding constraint by logical names. The port
    lays its tensors out by construction, so this returns ``x``."""
    return x


def model_size() -> int:
    """The model axis' extent in the active context (1 outside one)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.model_size


def model_rank() -> int:
    """This rank's model coordinate in the active context (0 outside one)."""
    mesh = current_mesh()
    return 0 if mesh is None or mesh.model_size == 1 else mesh.coords[MODEL_AXIS]


def _model_group():
    mesh = current_mesh()
    return None if mesh is None or mesh.model_size == 1 else mesh.model_group


class _ReduceOut(torch.autograd.Function):
    """Forward: sum over the model group; backward: identity."""

    @staticmethod
    def forward(x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        _count("all_reduce", y)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _CopyIn.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        xd = in_dims[0]
        return _ReduceOut.apply(x if xd is None else x.movedim(xd, 0), group), \
            (None if xd is None else 0)


class _CopyIn(torch.autograd.Function):
    """Forward: identity; backward: sum over the model group (the input's
    gradient is the sum of the ranks' partial ones)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceOut.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyIn.apply(x, group), in_dims[0]


class _GatherLast(torch.autograd.Function):
    """Forward: the ranks' pieces [..., n] concatenated on the last dim in
    model order, [..., M * n]; backward: this rank's slice."""

    @staticmethod
    def forward(x, group, rank):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        _count("all_gather", x)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.rank = inputs[0].shape[-1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None

    @staticmethod
    def vmap(info, in_dims, x, group, rank):
        xd = in_dims[0]
        return _GatherLast.apply(x if xd is None else x.movedim(xd, 0), group, rank), \
            (None if xd is None else 0)


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """Before a column-parallel product: identity forward, all-reduce of
    the gradient over the model group (identity without a model axis)."""
    g = _model_group()
    return x if g is None else _CopyIn.apply(x, g)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """After a row-parallel product: the ranks' partial sums all-reduced
    over the model group (identity without a model axis)."""
    g = _model_group()
    return x if g is None else _ReduceOut.apply(x, g)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The ranks' pieces on the last dim, gathered in model order
    (identity without a model axis)."""
    g = _model_group()
    return x if g is None else _GatherLast.apply(x, g, model_rank())
