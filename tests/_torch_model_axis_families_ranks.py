"""The port's side of ``tests/test_torch_model_axis_families.py``: the
hybrid, xLSTM, audio and VLM families on each rank of a spawned gloo world
of 8 ranks, mesh (data 4, model 2), and the same scenarios unsharded in
the test process. Torch only; results are numpy.

  * ``round/<arch>``: the ``fedveca_round`` bundle of reduced Hymba-1.5B
    and xLSTM-1.3B at ``_model_axis_setup.ROUND``'s sizes;
  * ``fwd/<arch>``: forward (``impl`` auto and pallas), loss and its
    gradient (remat True and "dots") of reduced Hymba-1.5B, xLSTM-1.3B,
    whisper-medium and phi-3-vision-4.2B on the rank's pieces;
  * ``serve/<arch>/<bundle>``: serving bundles on states made with numpy
    from a seed: Hymba's prefill, contiguous decode and paged decode
    (``cache_update="kernel"``, SSM rows beside the pool), xLSTM's
    prefill, contiguous and slot-masked decode, whisper's prefill,
    phi-3-vision's prefill and paged decode.

Gathered trees and logits are full on every rank; each cache leaf comes
back gathered over the model group (its rows stay the rank's client
shard's where the bundle cuts rows).
"""
import numpy as np
import torch
import torch.distributed as dist

import _model_axis_setup as S
from repro_torch import strict_fp32
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fedveca import make_round_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import api, partition
from repro_torch.train.steps import build_bundle

FWD = ("hymba-1.5b", "xlstm-1.3b", "whisper-medium", "phi-3-vision-4.2b")
SERVE = {"hymba-1.5b": ("prefill", "decode", "paged"),
         "xlstm-1.3b": ("prefill", "decode", "slots"),
         "whisper-medium": ("prefill",),
         "phi-3-vision-4.2b": ("prefill", "paged")}
B, S_PROMPT, CAP, PAGE = 8, 16, 32, 16
BUNDLE_KW = dict(prefill=("prefill", {}), decode=("decode", {}),
                 slots=("decode", dict(slot_masked=True)),
                 paged=("decode", dict(paged=True, cache_update="kernel")))


def config(name):
    return get_arch(name).reduced()


def _np(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_np(v) for v in x)) if hasattr(x, "_fields") else \
            tuple(_np(v) for v in x)
    return x.detach().cpu().numpy()


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _counted(fn):
    api.reset_collectives()
    out = fn()
    return out, dict(api.collectives)


def _extras(cfg, r, b):
    """The audio family's frames and the VLM family's patches, float32."""
    out = {}
    if cfg.family == "audio":
        out["frames"] = r.randn(b, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = r.randn(b, cfg.num_patches, cfg.vision_dim).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the round bundles
# ---------------------------------------------------------------------------


def round_sharded(mesh, arch, init):
    cfg = config(arch)
    model = build_model(cfg, device="cpu", mesh=mesh)
    b = build_bundle(model, mesh, ShapeConfig("t", S.ROUND["seq"], S.ROUND["batch"], "train"),
                     tau_max=S.ROUND["tau_max"], eta=S.ROUND["eta"])
    batches, tau, p, g = S.round_inputs(arch)
    ins = b.shard_inputs(_t(init), _t(batches), torch.from_numpy(tau), torch.from_numpy(p),
                         torch.tensor(g))
    (newp, st), coll = _counted(lambda: b.fn(*ins))
    return dict(params=_np(partition.gather_params(newp, mesh, cfg)), collectives=coll,
                **{k: getattr(st, k).numpy() for k in S.STATS + ("tau_k",)})


def round_unsharded(arch, init):
    model = build_model(config(arch), device="cpu")
    step = make_round_step(model.loss, eta=S.ROUND["eta"])
    batches, tau, p, g = S.round_inputs(arch)
    with strict_fp32():
        newp, st, _ = step(_t(init), _t(batches), torch.from_numpy(tau), torch.from_numpy(p),
                           torch.tensor(g))
    return dict(params=_np(newp), **{k: getattr(st, k).numpy() for k in S.STATS + ("tau_k",)})


# ---------------------------------------------------------------------------
# forward, loss, gradient
# ---------------------------------------------------------------------------


def fwd_batch(cfg):
    r = np.random.RandomState(3)
    b = dict(tokens=r.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             targets=r.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    return _t(dict(b, **_extras(cfg, r, 2)))


def forward(mesh, name):
    cfg = config(name)
    model = build_model(cfg, device="cpu", mesh=mesh)
    params, batch = model.init(0), fwd_batch(cfg)

    def run():
        out = {f"logits_{impl}": model.forward(params, batch, impl=impl)[0]
               for impl in ("auto", "pallas")}
        out["loss"] = model.loss(params, batch)[0]
        for remat in (True, "dots"):
            out[f"grad_{remat}"] = torch.func.grad(
                lambda p: model.loss(p, batch, remat=remat)[0])(params)
        return out

    out, coll = _counted(run)
    grads = {k: partition.gather_params(out.pop(k), mesh, cfg) if mesh.model_size > 1
             else out.pop(k) for k in ("grad_True", "grad_dots")}
    return dict(_np(out), **_np(grads), collectives=coll)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _fill(x, r):
    """Random numpy values for a state's leaves (meta tensors): floats
    N(0, 1), a recurrent normalizer ``n`` positive, KV positions live up to
    a random length a row."""
    if not (isinstance(x, tuple) and hasattr(x, "_fields")):
        return r.randn(*x.shape).astype(np.float32)
    vals = []
    for f, v in zip(x._fields, x):
        if v is None or f == "pos":
            vals.append(None if v is None else _pos(v, r))
        else:
            vals.append(np.abs(_fill(v, r)) + 0.5 if f == "n" else _fill(v, r))
    return type(x)(*vals)


def _pos(meta, r):
    L, b, W = meta.shape
    live = r.randint(4, W - 1, b)
    pos = np.where(np.arange(W)[None] < live[:, None], np.arange(W)[None], -1)
    return np.broadcast_to(pos, (L, b, W)).astype(np.int32).copy()


def serve_inputs(cfg, name, metas):
    """Full inputs of a serving bundle, numpy, from a seed, shaped as the
    bundle's ``make_inputs`` (``metas``, the params left out)."""
    r = np.random.RandomState(4)
    if name == "prefill":
        return (dict(tokens=r.randint(0, cfg.vocab_size, (B, S_PROMPT)).astype(np.int32),
                     **_extras(cfg, r, B)),)
    state = _fill(metas[0], r)
    if name in ("decode", "slots"):
        live = (state.kv.pos[0] >= 0).sum(-1) if state.kv is not None else \
            r.randint(4, CAP - 1, B)
        ins = (state, r.randint(0, cfg.vocab_size, B).astype(np.int32), live.astype(np.int32))
        return ins + ((np.arange(B) % 3 != 1),) if name == "slots" else ins
    n_pages, P = metas[0].kv.k.shape[1], metas[1].shape[1]
    table = r.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return (state, table, r.randint(0, cfg.vocab_size, B).astype(np.int32),
            r.randint(0, P * PAGE, B).astype(np.int32), np.arange(B) % 4 != 3)


def _torch(x):
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_torch(v) for v in x))
    if isinstance(x, dict):
        return _t(x)
    return torch.from_numpy(np.array(x))


def _cut_dims(cfg, mesh, name):
    """{leaf path: (row dim or None, model-cut dim or None)} of a serving
    bundle's cache, as ``train.steps._shard_cache`` cuts it."""
    lay = partition.layout(cfg, mesh.model_size)
    rows = name in ("prefill", "decode", "slots")
    heads = 3 if lay.attn else None
    out = {"kv/k": (1, heads), "kv/v": (1, heads), "kv/pos": (1, None),
           "ssm/h": (1, 2 if lay.ssm else None), "ssm/conv": (1, 3 if lay.ssm else None)}
    for f in ("C", "n", "m", "c", "h"):
        for kind in ("xlstm_m", "xlstm_s"):
            out[f"{kind}/{f}"] = (2, 3 if lay.xlstm else None)
    return {k: (r if rows else None, d) for k, (r, d) in out.items()}


def _leaves(cache):
    """{path: tensor} of a ``DecodeCache``/``PagedDecodeCache`` (or the audio
    family's prefill dict)."""
    if isinstance(cache, dict):
        return {f"kv/{f}": t for f, t in zip(cache["kv"]._fields, cache["kv"])}
    out = {}
    for f, st in zip(cache._fields, cache):
        if st is not None:
            out.update({f"{f}/{g}": t for g, t in zip(st._fields, st)})
    return out


def _gather_model(mesh, t, dim):
    if dim is None or mesh.model_size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def serve(mesh, arch, name):
    """One serving bundle on ``mesh`` from the full state: (logits, the
    cache's leaves gathered over the model group, their row dims)."""
    cfg = config(arch)
    kind, kw = BUNDLE_KW[name]
    model = build_model(cfg, device="cpu")
    b = build_bundle(model, mesh, ShapeConfig("s", CAP, B, kind), **kw)
    full = [_torch(x) for x in serve_inputs(cfg, name, b.make_inputs()[1:])]
    ins = b.shard_inputs(model.init(0), *full)
    (logits, cache), coll = _counted(lambda: b.fn(*ins))
    dims = _cut_dims(cfg, mesh, name)
    leaves = {k: _np(_gather_model(mesh, t, dims[k][1])) for k, t in _leaves(cache).items()}
    return dict(logits=_np(logits), cache=leaves, rows={k: dims[k][0] for k in leaves},
                collectives=coll)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def rank_main(inits):
    mesh = make_host_mesh(S.DATA, S.MODEL, device="cpu")
    heavy = mesh.coords["data"] == 0  # model-sized results from one client shard
    out = dict(rank=mesh.rank, coords=mesh.coords,
               round={a: round_sharded(mesh, a, inits[a]) for a in S.FAMILY_ROUNDS},
               fwd={n: forward(mesh, n) for n in FWD},
               serve={f"{a}/{n}": serve(mesh, a, n) for a, names in SERVE.items()
                      for n in names})
    if not heavy:  # the other client shards' model-sized outputs are checked equal
        for f in out["fwd"].values():
            f.pop("grad_True"), f.pop("grad_dots")
    return out


def unsharded(inits):
    mesh = make_host_mesh(1, 1, device="cpu")
    return dict(round={a: round_unsharded(a, inits[a]) for a in S.FAMILY_ROUNDS},
                fwd={n: forward(mesh, n) for n in FWD},
                serve={f"{a}/{n}": serve(mesh, a, n) for a, names in SERVE.items()
                       for n in names})
