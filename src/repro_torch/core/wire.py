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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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


def wire_fold(codec: WireCodec, updates: Tree, residuals: Tree):
    """Error-feedback fold over STACKED client rows (leaves [C, ...]).

    Per client c: t_c = u_c + r_c; dec_c = decode(encode(t_c));
    r'_c = t_c - dec_c. Returns (decoded rows, new residual rows). The
    codec runs client by client, so each row gets its own scale or top-k
    selection, exactly as one client's ``roundtrip``.
    """
    total = {k: u + residuals[k].to(u.dtype) for k, u in updates.items()}
    C = next(iter(total.values())).shape[0]
    rows = [codec.roundtrip({k: v[c] for k, v in total.items()}) for c in range(C)]
    decoded = {k: torch.stack([r[k] for r in rows]) for k in total}
    return decoded, {k: total[k] - decoded[k] for k in total}


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
