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
    (``ModelLayout``, ``layout``) is head- or channel-granular and shards
    or replicates a whole block:

      - attention (the encoder-decoder's self- and cross-attention too):
        q/k/v column-parallel and o row-parallel when Hq % m == 0 and
        Hkv % m == 0, else replicated (every rank computes every head);
      - MLP (and the MoE's shared experts): ``d_ff % m``;
      - MoE experts ``[E, d, f]``: on E when E % m == 0 (pad experts
        counted), else each expert on its hidden dim when
        ``moe_d_ff % m == 0``, else replicated; the router replicated;
      - the hybrid family's SSM: channel-parallel on ``d_in`` when
        ``d_in % m == 0``: ``w_in`` (x and gate, each half cut by
        ``d_in / m``), ``conv_w``, ``A_log``, ``dt_bias``, ``D`` on the
        rank's channels, ``w_bc``, ``w_dt``, ``w_out`` row-parallel;
      - xLSTM blocks on heads when H % m == 0 (hd contiguous): mLSTM
        ``w_up`` (x and output gate, each half cut), ``w_q/w_k/w_v``
        column-parallel, ``w_if``/``b_if`` (input and forget gates, each
        half cut), ``w_down`` row-parallel; sLSTM ``w_x``/``b`` (laid out
        ``(H, 4 hd)``) and ``w_r`` on heads, ``w_down`` row-parallel;
      - ``lm_head``: vocab-parallel when V % m == 0;
      - ``embed`` / ``pos_embed`` / ``enc_pos``: on d when d % m == 0
        (the JAX rule);
      - norms, biases of row-parallel outputs, the router,
        ``frame_proj``, ``vision_proj``: replicated.

    ``shard_params`` cuts a full tree to this rank's pieces (``piece``) and
    ``gather_params`` rebuilds it by all-gather. Where this departs from
    ``param_specs`` is ROADMAP.md's known difference P12. Every family
    runs on a model axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

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
    embed: bool  # embed / pos_embed / enc_pos by d
    ssm: bool  # the hybrid family's SSM by its d_in channels
    ssm_channels: int  # d_in a rank
    xlstm: bool  # the xLSTM blocks by heads
    xlstm_heads: int  # xLSTM heads a rank


@functools.lru_cache(maxsize=None)
def layout(cfg, m: int) -> ModelLayout:
    """The execution layout of ``cfg`` on a model axis of extent ``m``."""
    toy, rec = cfg.family == "toy", cfg.family == "ssm"
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    attn = m > 1 and not (toy or rec) and Hq % m == 0 and Hkv % m == 0
    E = cfg.num_experts + cfg.num_experts_pad if cfg.is_moe else 0
    f = cfg.moe_d_ff or cfg.d_ff
    experts = None
    if m > 1 and E:
        experts = "experts" if E % m == 0 else ("ff" if f % m == 0 else None)
    d_in = cfg.ssm_expand * cfg.d_model if cfg.hybrid_parallel_ssm else 0
    ssm = m > 1 and bool(d_in) and d_in % m == 0
    xlstm = m > 1 and rec and Hq % m == 0
    return ModelLayout(
        m=m, attn=attn, heads=Hq // m if attn else Hq, kv_heads=Hkv // m if attn else Hkv,
        mlp=m > 1 and not toy and not cfg.is_moe and bool(cfg.d_ff) and cfg.d_ff % m == 0,
        shared=m > 1 and bool(E) and cfg.num_shared_experts > 0
        and (cfg.num_shared_experts * f) % m == 0,
        experts=experts, experts_local=E // m if experts == "experts" else E,
        vocab=m > 1 and not toy and not cfg.tie_embeddings and cfg.vocab_size % m == 0,
        embed=m > 1 and not toy and cfg.d_model % m == 0,
        ssm=ssm, ssm_channels=d_in // m if ssm else d_in,
        xlstm=xlstm, xlstm_heads=Hq // m if xlstm else Hq)


_ATTN = ("attn", "self_attn", "cross_attn")
# leaves whose cut dim holds two halves (x and gate; input and forget
# gates), each cut by m: the rank holds its slice of each
_HALVES = {("ssm", "w_in"), ("m", "w_up"), ("m", "w_if"), ("m", "b_if")}


def exec_dim(path: str, ndim: int, lay: ModelLayout) -> Optional[int]:
    """The dim of leaf ``path`` (of ``ndim`` dims, layer stacks included)
    that the port's layout shards on the model axis, or None."""
    if lay.m <= 1:
        return None
    parts = path.split("/")
    name = parts[-1]
    if name in ("embed", "pos_embed", "enc_pos"):
        return ndim - 1 if lay.embed else None
    if name == "lm_head":
        return ndim - 1 if lay.vocab else None
    if any(a in parts for a in _ATTN):
        if not lay.attn:
            return None
        if name in ("w_q", "w_k", "w_v", "b_q", "b_k", "b_v"):
            return ndim - 1
        return ndim - 2 if name == "w_o" else None
    if "ssm" in parts:
        if not lay.ssm:
            return None
        if name in ("w_in", "conv_w", "dt_bias", "D"):
            return ndim - 1
        return ndim - 2 if name in ("A_log", "w_bc", "w_dt", "w_out") else None
    if "xlstm" in parts:
        if not lay.xlstm or parts[-2] not in ("m", "s"):
            return None  # the blocks' norms
        if name in ("w_up", "w_q", "w_k", "w_v", "w_if", "b_if", "w_x", "b"):
            return ndim - 1
        if name == "w_r":  # [H, hd, 4 hd]
            return ndim - 3
        return ndim - 2 if name == "w_down" else None
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


def halves(path: str) -> int:
    """How many halves the cut dim of leaf ``path`` holds (2 for the SSM's
    ``w_in`` and the mLSTM's ``w_up``, ``w_if``, ``b_if``), each cut by m."""
    parts = path.split("/")
    return 2 if len(parts) >= 2 and (parts[-2], parts[-1]) in _HALVES else 1


def piece(v: torch.Tensor, dim: int, n_halves: int, rank: int, m: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``v`` cut on ``dim`` over ``m`` ranks: the
    rank's slice of each of the dim's ``n_halves`` halves, in order."""
    n = v.shape[dim] // (n_halves * m)
    if n_halves == 1:
        return v.narrow(dim, rank * n, n)
    return torch.cat([v.narrow(dim, (h * m + rank) * n, n) for h in range(n_halves)], dim)


def unpiece(parts, dim: int, n_halves: int) -> torch.Tensor:
    """The whole leaf from every rank's ``piece``, in rank order."""
    if n_halves == 1:
        return torch.cat(parts, dim)
    split = [p.chunk(n_halves, dim) for p in parts]
    return torch.cat([s[h] for h in range(n_halves) for s in split], dim)


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
        out[k] = v if d is None else piece(v, lead + d, halves(k), r, m).contiguous()
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
        out[k] = unpiece(parts, lead + d, halves(k))
    return {k: out[k] for k in local}


class Cut(NamedTuple):
    """How a sharded leaf is cut: its cut dim counted from the end (so a
    leading client axis does not move it), the halves that dim holds, and
    the whole leaf's shape."""

    dim: int
    halves: int
    shape: Tuple[int, ...]


class ModelAxis:
    """What the federated round needs of the model axis: its process group,
    its extent and this rank's coordinate, and how each sharded leaf is cut
    (``cuts``; their squared norms are partial on a rank and complete with
    one all-reduce, the replicated ones count once; the wire codecs take
    whole-leaf decisions from the cuts)."""

    def __init__(self, group, cuts: Dict[str, Cut], size: int, rank: int):
        self.group = group
        self.cuts = dict(cuts)
        self.sharded = frozenset(cuts)
        self.size = size
        self.rank = rank

    def split(self, tree: Dict[str, Any]):
        """(sharded leaves, replicated leaves) of a flat tree."""
        return ({k: v for k, v in tree.items() if k in self.sharded},
                {k: v for k, v in tree.items() if k not in self.sharded})


def model_axis(mesh, cfg, params: Dict[str, Any]) -> Optional[ModelAxis]:
    """The round's view of ``mesh``'s model axis for ``cfg`` (None at model
    extent 1); ``params`` is the model's whole tree (shapes suffice)."""
    m, r = _model_coord(mesh) if mesh is not None else (1, 0)
    if m <= 1:
        return None
    lay = layout(cfg, m)
    cuts = {k: Cut(d - len(v.shape), halves(k), tuple(v.shape))
            for k, v in params.items() if (d := exec_dim(k, len(v.shape), lay)) is not None}
    return ModelAxis(mesh.model_group, cuts, m, r)
