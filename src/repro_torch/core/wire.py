"""Wire stage: client->server update codecs with error feedback (port of
``repro/core/wire.py``), on trees that are ``{keypath: tensor}`` dicts.

  * ``WireCodec.encode(tree)`` gives the *payload*: the tensors a real
    transport would carry, so their bytes are the wire cost (int8 buffers
    and one float32 scale a leaf, top-k index/value pairs, or the dense
    tree itself for identity);
  * ``WireCodec.decode(payload, like)`` rebuilds a dense tree with
    ``like``'s shapes and dtypes; the server reduces decoded trees
    (decode-before-reduce), so no aggregation code changes;
  * lossy codecs carry per-client error-feedback residuals, kept by the
    caller: a client sends ``encode(u + r)`` and keeps
    ``r' = (u + r) - decode(encode(u + r))``, so the decoded stream plus
    the last residual sums to the raw updates.

``IdentityCodec.is_identity`` tells callers to bypass the stage entirely
(no residual, no extra op), which keeps wire-off runs bitwise equal to
runs without the stage. The message-passing prototype
(``fed/prototype.py``) uses the codecs, and so does the engine
(``EngineConfig.wire``), whose per-client residual rows are its state.

**Under a model axis** (``wire_fold(..., model_axis=)``, a
``sharding.partition.ModelAxis``) a rank holds pieces of the sharded
leaves, and each codec takes its whole-leaf decision across the model
group, so that the decoded pieces are bitwise the unsharded codec's,
sliced: int8's scale is the whole leaf's ``max|x|`` (the local maxima of
every row and leaf, then ONE all-reduce ``max``); top-k keeps the whole
leaf's k entries (each rank's local top-k as (global flat index, value)
candidates, ONE all-gather of every row's and leaf's candidates, the k
largest magnitudes with the lower index first, then each rank keeps the
entries in its piece). A leaf of at most k entries is sent whole, decided
on its global count. Replicated leaves take the unsharded path, and the
payload bytes stay the whole leaves' (``payload_nbytes`` of the global
shapes).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.sharding.api import all_gather, all_reduce

Tree = Dict[str, torch.Tensor]


def _count(x) -> int:
    """Element count of a tensor, array or anything with a ``.shape``."""
    return int(np.prod(tuple(x.shape), dtype=np.int64))


class WireCodec:
    """One client's update codec. Stateless: residuals live in the caller,
    keyed by client."""

    name: str = "base"
    is_identity: bool = False

    def encode(self, tree: Tree) -> Any:
        """Dense update tree -> payload (what the wire carries)."""
        raise NotImplementedError

    def decode(self, payload, like) -> Tree:
        """Payload -> dense tree with ``like``'s shapes and dtypes (only
        ``.shape`` and ``.dtype`` of ``like``'s leaves are read)."""
        raise NotImplementedError

    def payload_nbytes(self, like) -> int:
        """Wire bytes of ONE client's update shaped like ``like``."""
        raise NotImplementedError

    def roundtrip(self, tree: Tree) -> Tree:
        """decode(encode(tree)): the lossy projection the server sees."""
        return self.decode(self.encode(tree), tree)

    def roundtrip_pieces(self, rows: Tree, model_axis) -> Tree:
        """``roundtrip`` of every client row of ``rows`` (leaves [C, ...],
        this rank's pieces of the leaves ``model_axis`` cuts), with the
        codec's decisions taken over each whole leaf."""
        raise NotImplementedError(f"codec {self.name!r} has no model-axis form")


class IdentityCodec(WireCodec):
    """Bitwise no-op: the payload is the dense tree itself."""

    name = "identity"
    is_identity = True

    def encode(self, tree):
        return tree

    def decode(self, payload, like):
        return payload

    def payload_nbytes(self, like) -> int:
        return sum(_count(x) * x.dtype.itemsize for x in like.values())


class Int8QuantCodec(WireCodec):
    """Per-leaf symmetric int8 quantization: q = round(x / s) with
    s = max|x| / 127, so the worst-case error is s/2 an element. An
    all-zero leaf divides by 1 and sends q = 0."""

    name = "int8"

    def encode(self, tree):
        q, scale = {}, {}
        for k, x in tree.items():
            a = x.float()
            s = a.abs().max() / 127.0
            # torch.round, like jnp.round, rounds half to even
            q[k] = torch.clamp(torch.round(a / torch.where(s > 0, s, 1.0)),
                               -127, 127).to(torch.int8)
            scale[k] = s
        return dict(q=q, scale=scale)

    def decode(self, payload, like):
        return {k: (payload["q"][k].float() * payload["scale"][k]).to(like[k].dtype)
                for k in like}

    def payload_nbytes(self, like) -> int:
        # one int8 an element + one float32 scale a leaf
        return sum(_count(x) + 4 for x in like.values())

    def roundtrip_pieces(self, rows, model_axis):
        keys = sorted(rows)
        C = rows[keys[0]].shape[0]
        # every row's local max|x| of every leaf, completed in one all-reduce
        amax = torch.stack([rows[k].float().abs().reshape(C, -1).amax(1) for k in keys])
        amax = all_reduce([amax], model_axis.group, op="max")[0]
        out = {}
        for k, s in zip(keys, amax / 127.0):
            a = rows[k].float()
            s = s.reshape((C,) + (1,) * (a.dim() - 1))
            q = torch.clamp(torch.round(a / torch.where(s > 0, s, 1.0)), -127, 127).to(torch.int8)
            out[k] = (q.float() * s).to(rows[k].dtype)
        return out


class TopKCodec(WireCodec):
    """Magnitude sparsification: each leaf's k largest-|x| entries as
    (int32 index, float32 value) pairs; everything else decodes to zero.
    Leaves with fewer than k entries are sent whole. Among equal
    magnitudes the lower index wins, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order for ties, so a stable sort selects)."""

    name = "topk"

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"top-k needs k >= 1, got {k}")
        self.k = int(k)
        self.name = f"topk:{self.k}"

    def encode(self, tree):
        idx, val = {}, {}
        for key, x in tree.items():
            flat = x.float().reshape(-1)
            order = torch.sort(flat.abs(), descending=True, stable=True).indices
            order = order[:min(self.k, flat.numel())]
            idx[key], val[key] = order.to(torch.int32), flat[order]
        return dict(idx=idx, val=val)

    def decode(self, payload, like):
        out = {}
        for key, l in like.items():
            val = payload["val"][key]
            flat = torch.zeros(_count(l), dtype=torch.float32, device=val.device)
            flat[payload["idx"][key].long()] = val
            out[key] = flat.reshape(tuple(l.shape)).to(l.dtype)
        return out

    def payload_nbytes(self, like) -> int:
        # (int32 idx, float32 val) a kept entry
        return sum(8 * min(self.k, _count(x)) for x in like.values())

    def roundtrip_pieces(self, rows, model_axis):
        out, picks, cands = {}, {}, []
        for key in sorted(rows):
            x = rows[key]
            cut = model_axis.cuts[key]
            if int(np.prod(cut.shape, dtype=np.int64)) <= self.k:  # sent whole
                out[key] = x.float().to(x.dtype)
                continue
            flat = x.float().reshape(x.shape[0], -1)
            kk = min(self.k, flat.shape[1])
            # a stable sort of the piece: ties keep the piece's order, which
            # is the whole leaf's (the index map is increasing)
            order = torch.sort(flat.abs(), dim=1, descending=True, stable=True).indices[:, :kk]
            gidx = _whole_index(cut, model_axis, order)
            picks[key] = kk
            cands.append(torch.stack([gidx.double(), flat.gather(1, order).double()], dim=-1))
        if not picks:
            return out
        # every rank's (whole-leaf index, value) candidates of every row and
        # leaf in ONE all-gather: [m, C, sum kk, 2] (float64 holds both exactly)
        every = all_gather(torch.cat(cands, dim=1)[None], model_axis.group)
        off = 0
        for key, kk in picks.items():
            x = rows[key]
            C = x.shape[0]
            cand = every[:, :, off:off + kk].transpose(0, 1).reshape(C, -1, 2)
            off += kk
            gidx, val = cand[..., 0].long(), cand[..., 1].float()
            # the k largest magnitudes, the lower index first among equals
            order = torch.sort(gidx, dim=1).indices
            gidx, val = gidx.gather(1, order), val.gather(1, order)
            order = torch.sort(val.abs(), dim=1, descending=True, stable=True).indices[:, :self.k]
            gidx, val = gidx.gather(1, order), val.gather(1, order)
            # the kept entries of this rank's piece, at their piece index
            li = _piece_index(model_axis.cuts[key], model_axis, gidx)
            keep = li >= 0
            flat = torch.zeros((C, x[0].numel()), dtype=torch.float32, device=x.device)
            row = torch.arange(C, device=x.device)[:, None].expand_as(li)
            flat[row[keep], li[keep]] = val[keep]
            out[key] = flat.reshape(x.shape).to(x.dtype)
        return out


def _geometry(cut, m: int):
    """(halves, n, inner, the cut dim's extent) of a cut leaf: the whole
    leaf's cut dim is (halves, m, n), a piece's (halves, n)."""
    shape = cut.shape
    d = len(shape) + cut.dim
    inner = int(np.prod(shape[d + 1:], dtype=np.int64))
    return cut.halves, shape[d] // (cut.halves * m), inner, shape[d]


def _whole_index(cut, model_axis, li: torch.Tensor) -> torch.Tensor:
    """Piece flat indices ``li`` -> the whole leaf's flat indices (an
    increasing map)."""
    h, n, inner, _ = _geometry(cut, model_axis.size)
    i, c = li % inner, li // inner
    jj, c = c % n, c // n
    hf, o = c % h, c // h
    return (((o * h + hf) * model_axis.size + model_axis.rank) * n + jj) * inner + i


def _piece_index(cut, model_axis, gi: torch.Tensor) -> torch.Tensor:
    """The whole leaf's flat indices ``gi`` -> this rank's piece indices, -1
    where the entry lies in another rank's piece."""
    h, n, inner, D = _geometry(cut, model_axis.size)
    m = model_axis.size
    i, c, o = gi % inner, (gi // inner) % D, gi // (inner * D)
    hf, rr, jj = c // (m * n), (c // n) % m, c % n
    li = ((o * h + hf) * n + jj) * inner + i
    return torch.where(rr == model_axis.rank, li, torch.full_like(li, -1))


def roundtrip_rows(codec: WireCodec, total: Tree) -> Tree:
    """``codec.roundtrip`` of each client row of ``total`` (leaves [C, ...])."""
    C = next(iter(total.values())).shape[0]
    rows = [codec.roundtrip({k: v[c] for k, v in total.items()}) for c in range(C)]
    return {k: torch.stack([r[k] for r in rows]) for k in total}


def wire_fold(codec: WireCodec, updates: Tree, residuals: Tree, model_axis=None):
    """Error-feedback fold over STACKED client rows (leaves [C, ...]).

    Per client c: t_c = u_c + r_c; dec_c = decode(encode(t_c));
    r'_c = t_c - dec_c. Returns (decoded rows, new residual rows). The
    codec runs client by client, so each row gets its own scale or top-k
    selection, exactly as one client's ``roundtrip``; under ``model_axis``
    the sharded leaves' rows are this rank's pieces and the codec decides
    over the whole leaves (``roundtrip_pieces``).
    """
    total = {k: u + residuals[k].to(u.dtype) for k, u in updates.items()}
    if model_axis is None:
        decoded = roundtrip_rows(codec, total)
    else:
        sh, rep = model_axis.split(total)
        decoded = dict(roundtrip_rows(codec, rep) if rep else {},
                       **(codec.roundtrip_pieces(sh, model_axis) if sh else {}))
    return {k: decoded[k] for k in total}, {k: total[k] - decoded[k] for k in total}


def make_codec(spec) -> WireCodec:
    """'none' | 'identity' | 'int8' | 'topk:K' | WireCodec | None -> codec."""
    if isinstance(spec, WireCodec):
        return spec
    if spec is None or spec in ("none", "", "identity"):
        return IdentityCodec()
    if spec == "int8":
        return Int8QuantCodec()
    if isinstance(spec, str) and spec.startswith("topk:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad top-k wire spec {spec!r}: expected topk:K")
        return TopKCodec(k)
    raise ValueError(f"unknown wire codec {spec!r}; valid: none|identity|int8|topk:K")
