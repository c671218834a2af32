"""Parameter partitioning on the model axis (port of
``repro/sharding/partition.py``).

Two halves:

  * **The JAX package's specs, as data.** ``leaf_spec``, ``param_specs``,
    ``batch_specs``, ``cache_specs`` and ``paged_cache_specs`` return, for
    the same paths and shapes, exactly the JAX package's PartitionSpecs, as
    tuples of None / axis name / tuple of names. Params are the port's
    flat dicts keyed by ``/``-joined paths; a leaf is anything with a
    ``shape``. ``mesh`` is anything with a ``shape`` dict.
  * **The port's execution layout.** GSPMD reshards around a spec that
    cuts mid-head; explicit collectives cannot, so the layout the port runs
    (``ModelLayout``, ``layout``) is head-granular and shards or
    replicates a whole block:

      - attention: q/k/v column-parallel and o row-parallel when
        Hq % m == 0 and Hkv % m == 0, else replicated (every rank
        computes every head);
      - MLP (and the MoE's shared experts): ``d_ff % m``;
      - MoE experts ``[E, d, f]``: on E when E % m == 0 (pad experts
        counted), else each expert on its hidden dim when
        ``moe_d_ff % m == 0``, else replicated; the router replicated;
      - ``lm_head``: vocab-parallel when V % m == 0;
      - ``embed`` / ``pos_embed``: on d when d % m == 0 (the JAX rule);
      - norms, biases of row-parallel outputs, ``vision_proj``:
        replicated.

    ``shard_params`` cuts a full tree to this rank's pieces and
    ``gather_params`` rebuilds it by all-gather. Where this departs from
    ``param_specs`` is ROADMAP.md's known difference P12. The dense and
    MoE families (and the toy models, all replicated) run on a model axis;
    the hybrid, ssm, audio and vlm families raise (ROADMAP.md A18c).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, FrozenSet, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import not_ported

Spec = Tuple[Any, ...]


def _axis_size(mesh, *names: str) -> int:
    n = 1
    for a in names:
        n *= mesh.shape.get(a, 1)
    return n


# weight-name classes (the JAX package's)
_COL_PARALLEL = {  # 2D [in, out]: shard out (last dim)
    "w_q", "w_k", "w_v", "w_gate", "w_up", "w_in", "w_x", "lm_head",
}
_ROW_PARALLEL = {  # 2D [in, out]: shard in (first dim)
    "w_o", "w_down", "w_out",
}
_SHARD_DIM0_VEC = {  # 1D vectors living in the sharded feature space
    "b_q", "b_k", "b_v", "b_up", "dt_bias", "D",
}


def leaf_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The JAX package's spec of one (unstacked) leaf."""
    m = _axis_size(mesh, "model")
    name = path.split("/")[-1]

    def ok(dim: int) -> bool:
        return m > 1 and dim < len(shape) and shape[dim] % m == 0

    if m <= 1:
        return ()
    if name in ("embed", "pos_embed", "enc_pos"):
        return (None, "model" if ok(1) else None)
    if len(shape) == 3 and name in ("w_gate", "w_up", "w_down"):
        if ok(0):
            return ("model", None, None)
        if name == "w_down":
            return (None, "model" if ok(1) else None, None)
        return (None, None, "model" if ok(2) else None)
    if name == "w_r":
        return (None, None, None)
    if len(shape) == 2:
        if name in _COL_PARALLEL:
            return (None, "model" if ok(1) else None)
        if name in _ROW_PARALLEL:
            return ("model" if ok(0) else None, None)
        if name in ("conv_w",):
            return (None, "model" if ok(1) else None)
        if name in ("w_bc", "w_dt", "A_log"):
            return ("model" if ok(0) else None, None)
        if name in ("w_if", "router", "frame_proj", "vision_proj", "fc1", "fc2", "w", "b"):
            return (None, None)
        return (None,) * len(shape)
    if len(shape) == 1 and name in _SHARD_DIM0_VEC:
        return ("model" if ok(0) else None,)
    return (None,) * len(shape)


def _stack_depth(path: str) -> int:
    """Leading layer-stack dims of a leaf: 1 under layers/enc_layers/
    dec_layers, 2 under xlstm ([n_super, n_per_super, ...])."""
    parts = path.split("/")
    if "xlstm" in parts:
        return 2
    if any(s in parts for s in ("layers", "enc_layers", "dec_layers")):
        return 1
    return 0


def param_specs(params: Dict[str, Any], mesh, leading: Tuple = ()) -> Dict[str, Spec]:
    """Spec of every leaf of a flat params dict: the layer-stack dims map to
    None and ``leading`` (e.g. the round's client axis) is prepended, None
    where the client axes do not divide the leading dim."""
    out = {}
    for path, leaf in params.items():
        shape = tuple(leaf.shape)
        nlead, extra = len(leading), _stack_depth(path)
        base = leaf_spec(path, shape[nlead + extra:], mesh)
        lead = tuple(leading) if nlead else ()
        if nlead:
            csz = _axis_size(mesh, *(a for grp in leading
                                     for a in (grp if isinstance(grp, tuple) else (grp,))))
            if shape[0] % csz != 0:
                lead = (None,)
        out[path] = (*lead, *([None] * extra), *base)
    return out


def _map_leaves(fn, tree):
    """``fn`` over the leaves (anything with a shape) of nested dicts,
    tuples and NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        vals = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def _data_axes(mesh):
    """(extent, spec entry) of the data axes ('pod', 'data') of ``mesh``."""
    daxes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return _axis_size(mesh, *daxes), (daxes if len(daxes) > 1 else
                                      (daxes[0] if daxes else None))


def batch_specs(batch, mesh, batch_axes=("pod", "data")):
    """The leading (batch or client) dim of every leaf on the batch axes."""
    axes = tuple(a for a in batch_axes if a in mesh.shape)
    n = _axis_size(mesh, *axes)

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0 or n <= 1 or leaf.shape[0] % n != 0:
            return (None,) * nd
        return (axes if len(axes) > 1 else axes[0], *([None] * (nd - 1)))

    return _map_leaves(one, batch)


def paged_cache_specs(cache, mesh, cache_update: str = "mask"):
    """Pool leaves [L, N, ps, Hkv, hd]: pages on the data axes and kv heads
    on the model axis when they divide ("kernel": replicated); hybrid SSM
    rows [L, B, ...] batch-sharded (the JAX package's rule)."""
    dn, dspec = _data_axes(mesh)
    m = _axis_size(mesh, "model")

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) == 5:
            if cache_update == "kernel":
                return tuple(spec)
            if dn > 1 and shape[1] % dn == 0:
                spec[1] = dspec
            if m > 1 and shape[3] % m == 0:
                spec[3] = "model"
        elif len(shape) >= 3:
            if dn > 1 and shape[1] % dn == 0:
                spec[1] = dspec
        return tuple(spec)

    return _map_leaves(one, cache)


def cache_specs(cache, mesh, kv_seq_shard: bool = False):
    """Decode-cache specs: the batch dim on the data axes, kv heads on the
    model axis when they divide; with ``kv_seq_shard`` the cache LENGTH on
    the model axis where the heads do not divide (the JAX package's rule;
    the port does not build length-sharded caches, ROADMAP.md P12)."""
    dn, dspec = _data_axes(mesh)
    m = _axis_size(mesh, "model")

    def one(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 3:
            bdim = 1
            if nd >= 4 and shape[0] < 16 and shape[1] < 16:
                bdim = 2 if shape[2] % max(dn, 1) == 0 and shape[1] <= 8 else 1
            if dn > 1 and shape[bdim] % dn == 0:
                spec[bdim] = dspec
            elif dn > 1 and nd >= 5 and shape[2] % dn == 0:
                spec[2] = dspec
            if nd >= 5 and m > 1 and shape[3] % m == 0:
                spec[3] = "model"
            elif (kv_seq_shard and nd >= 5 and m > 1 and spec[2] is None
                  and shape[2] % m == 0):
                spec[2] = "model"
            elif (kv_seq_shard and nd == 3 and m > 1 and spec[2] is None
                  and shape[2] % m == 0):
                spec[2] = "model"
        return tuple(spec)

    return _map_leaves(one, cache)


# ---------------------------------------------------------------------------
# the port's execution layout
# ---------------------------------------------------------------------------

MODEL_AXIS_FAMILIES = ("dense", "moe", "toy")


@dataclasses.dataclass(frozen=True)
class ModelLayout:
    """How one config's blocks split over a model axis of extent ``m``:
    which blocks are sharded, and the rank-local widths the layers run
    on (the global ones where a block is replicated)."""

    m: int
    attn: bool  # q/k/v/o by heads
    heads: int
    kv_heads: int
    mlp: bool  # the dense MLP by d_ff
    shared: bool  # the MoE's shared experts by their d_ff
    experts: Optional[str]  # "experts" (on E), "ff" (each on its f) or None
    experts_local: int
    vocab: bool  # lm_head by vocab
    embed: bool  # embed / pos_embed by d


@functools.lru_cache(maxsize=None)
def layout(cfg, m: int) -> ModelLayout:
    """The execution layout of ``cfg`` on a model axis of extent ``m``;
    families other than dense, MoE and toy raise naming A18c at m > 1."""
    if m > 1 and cfg.family not in MODEL_AXIS_FAMILIES:
        raise not_ported(f"a model axis of {m} for family={cfg.family!r} ({cfg.name}: its "
                         "channel-parallel rules)", "A18c")
    toy = cfg.family == "toy"
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    attn = m > 1 and not toy and Hq % m == 0 and Hkv % m == 0
    E = cfg.num_experts + cfg.num_experts_pad if cfg.is_moe else 0
    f = cfg.moe_d_ff or cfg.d_ff
    experts = None
    if m > 1 and E:
        experts = "experts" if E % m == 0 else ("ff" if f % m == 0 else None)
    return ModelLayout(
        m=m, attn=attn, heads=Hq // m if attn else Hq, kv_heads=Hkv // m if attn else Hkv,
        mlp=m > 1 and not toy and not cfg.is_moe and bool(cfg.d_ff) and cfg.d_ff % m == 0,
        shared=m > 1 and bool(E) and cfg.num_shared_experts > 0
        and (cfg.num_shared_experts * f) % m == 0,
        experts=experts, experts_local=E // m if experts == "experts" else E,
        vocab=m > 1 and not toy and not cfg.tie_embeddings and cfg.vocab_size % m == 0,
        embed=m > 1 and not toy and cfg.d_model % m == 0)


def exec_dim(path: str, ndim: int, lay: ModelLayout) -> Optional[int]:
    """The dim of leaf ``path`` (of ``ndim`` dims, layer stacks included)
    that the port's layout shards on the model axis, or None."""
    if lay.m <= 1:
        return None
    parts = path.split("/")
    name = parts[-1]
    if name in ("embed", "pos_embed"):
        return ndim - 1 if lay.embed else None
    if name == "lm_head":
        return ndim - 1 if lay.vocab else None
    if "attn" in parts and lay.attn:
        if name in ("w_q", "w_k", "w_v", "b_q", "b_k", "b_v"):
            return ndim - 1
        if name == "w_o":
            return ndim - 2
        return None
    sharded = (lay.shared if "shared" in parts else
               lay.mlp if "mlp" in parts else False)
    if "moe" in parts and "shared" not in parts and name in ("w_gate", "w_up", "w_down"):
        if lay.experts == "experts":
            return ndim - 3
        sharded = lay.experts == "ff"
    if sharded:
        if name in ("w_gate", "w_up", "b_up"):
            return ndim - 1
        if name == "w_down":
            return ndim - 2
    return None


def _dims(params: Dict[str, Any], lay: ModelLayout) -> Dict[str, Optional[int]]:
    return {k: exec_dim(k, len(v.shape), lay) for k, v in params.items()}


def sharded_keys(params: Dict[str, Any], lay: ModelLayout) -> FrozenSet[str]:
    """The leaves the layout shards (their norms are partial on a rank)."""
    return frozenset(k for k, d in _dims(params, lay).items() if d is not None)


def _model_coord(mesh) -> Tuple[int, int]:
    m = mesh.shape.get("model", 1)
    return m, (mesh.coords["model"] if m > 1 else 0)


def shard_params(full: Dict[str, torch.Tensor], mesh, cfg, *, lead: int = 0):
    """This rank's pieces of a full params tree (contiguous copies of the
    sharded leaves; replicated leaves as they are). ``lead`` leading dims
    (a client axis) precede each leaf's own."""
    m, r = _model_coord(mesh)
    lay = layout(cfg, m)
    out = {}
    for k, v in full.items():
        d = exec_dim(k, v.dim() - lead, lay)
        if d is None:
            out[k] = v
        else:
            n = v.shape[lead + d] // m
            out[k] = v.narrow(lead + d, r * n, n).contiguous()
    return out


def gather_params(local: Dict[str, torch.Tensor], mesh, cfg, *, lead: int = 0):
    """The full tree rebuilt from every rank's pieces by all-gather over the
    model group (tests, checkpoints, comparisons against one rank)."""
    m, _ = _model_coord(mesh)
    lay = layout(cfg, m)
    out = {}
    for k in sorted(local):
        v = local[k]
        d = exec_dim(k, v.dim() - lead, lay)
        if d is None:
            out[k] = v
            continue
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(m)]
        dist.all_gather(parts, v, group=mesh.model_group)
        out[k] = torch.cat(parts, dim=lead + d)
    return {k: out[k] for k in local}


class ModelAxis:
    """What the federated round needs of the model axis: its process group
    and the leaves that are sharded (their squared norms are partial on a
    rank and complete with one all-reduce; the replicated ones count
    once)."""

    def __init__(self, group, sharded: FrozenSet[str], size: int):
        self.group = group
        self.sharded = frozenset(sharded)
        self.size = size

    def split(self, tree: Dict[str, Any]):
        """(sharded leaves, replicated leaves) of a flat tree."""
        return ({k: v for k, v in tree.items() if k in self.sharded},
                {k: v for k, v in tree.items() if k not in self.sharded})


def model_axis(mesh, cfg, params: Dict[str, Any]) -> Optional[ModelAxis]:
    """The round's view of ``mesh``'s model axis for ``cfg`` (None at model
    extent 1); ``params`` gives the keys (any tree of the model's)."""
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if m <= 1:
        return None
    return ModelAxis(mesh.model_group, sharded_keys(params, layout(cfg, m)), m)
