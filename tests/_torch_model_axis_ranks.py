"""The port's side of ``tests/test_torch_model_axis.py``: every scenario on
each rank of a spawned gloo world of 8 ranks, mesh (data 4, model 2); and
the same scenarios unsharded in the test process. Torch only; results are
numpy.

  * ``round``: the ``fedveca_round`` bundle of ``_model_axis_setup.ROUND``;
  * ``sgd``: the ``train_step[sgd]`` bundle of ``_model_axis_setup.SGD``;
  * ``fwd/<arch>``: forward (``impl`` auto and pallas), loss and its
    gradient (remat True and "dots") of reduced Qwen1.5-32B, StarCoder2-3B
    and a one-kv-head copy (attention replicated) on the rank's pieces;
  * ``serve/<arch>/<bundle>``: the five serving bundles on states made
    with numpy from a seed, reduced Qwen1.5-32B (and granite-moe's prefill
    and paged decode).

Gathered trees (``sharding.partition.gather_params``) and logits are full
on every rank; caches come back as the rank's pieces.
"""
import dataclasses
import warnings

import numpy as np
import torch

import _model_axis_setup as S
from repro_torch import strict_fp32
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.fedveca import make_round_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.sharding import api
from repro_torch.sharding.partition import gather_params
from repro_torch.train.steps import build_bundle

FWD = ("qwen1.5-32b", "starcoder2-3b", "qwen1.5-32b-kv1")
SERVE = {"qwen1.5-32b": ("prefill", "decode", "slots", "paged", "chunk"),
         "granite-moe-1b-a400m": ("prefill", "paged")}
B, S_PROMPT, CAP, PAGE, CHUNK = 8, 16, 32, 16, 16


def fwd_config(name):
    if name.endswith("-kv1"):
        return dataclasses.replace(get_arch(name[:-4]).reduced(), num_kv_heads=1)
    cfg = get_arch(name).reduced()
    return dataclasses.replace(cfg, capacity_factor=100.0) if cfg.is_moe else cfg


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_np(v) for v in tree)) if hasattr(tree, "_fields") else \
            tuple(_np(v) for v in tree)
    return None if tree is None else tree.detach().cpu().numpy()


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _counted(fn):
    api.reset_collectives()
    out = fn()
    return out, dict(api.collectives)


# ---------------------------------------------------------------------------
# the round and the SGD step
# ---------------------------------------------------------------------------


def round_sharded(mesh, init):
    cfg = get_arch(S.ROUND["arch"]).reduced()
    model = build_model(cfg, device="cpu", mesh=mesh)
    b = build_bundle(model, mesh, ShapeConfig("t", S.ROUND["seq"], S.ROUND["batch"], "train"),
                     tau_max=S.ROUND["tau_max"], eta=S.ROUND["eta"])
    batches, tau, p, g = S.round_inputs()
    ins = b.shard_inputs(_t(init), _t(batches), torch.from_numpy(tau), torch.from_numpy(p),
                         torch.tensor(g))
    (newp, st), coll = _counted(lambda: b.fn(*ins))
    return dict(params=_np(gather_params(newp, mesh, cfg)), collectives=coll,
                **{k: getattr(st, k).numpy() for k in S.STATS + ("tau_k",)})


def round_unsharded(init):
    cfg = get_arch(S.ROUND["arch"]).reduced()
    model = build_model(cfg, device="cpu")
    step = make_round_step(model.loss, eta=S.ROUND["eta"])
    batches, tau, p, g = S.round_inputs()
    with strict_fp32():
        newp, st, _ = step(_t(init), _t(batches), torch.from_numpy(tau), torch.from_numpy(p),
                           torch.tensor(g))
    return dict(params=_np(newp), **{k: getattr(st, k).numpy() for k in S.STATS + ("tau_k",)})


def sgd(mesh, init):
    cfg = get_arch(S.SGD["arch"]).reduced()
    b = build_bundle(build_model(cfg, device="cpu"), mesh,
                     ShapeConfig("t", S.SGD["seq"], S.SGD["batch"], "train"), plain_sgd=True,
                     eta=S.SGD["eta"])
    ins = b.shard_inputs(_t(init), _t(S.sgd_batch()))
    (newp, loss), coll = _counted(lambda: b.fn(*ins))
    if mesh.model_size > 1:
        newp = gather_params(newp, mesh, cfg)
    return dict(params=_np(newp), loss=float(loss), collectives=coll)


# ---------------------------------------------------------------------------
# forward, loss, gradient
# ---------------------------------------------------------------------------


def _fwd_batch(cfg):
    r = np.random.RandomState(3)
    return _t(dict(tokens=r.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32),
                   targets=r.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)))


def forward(mesh, name):
    cfg = fwd_config(name)
    model = build_model(cfg, device="cpu", mesh=mesh)
    params, batch = model.init(0), _fwd_batch(cfg)

    def run():
        out = {f"logits_{impl}": model.forward(params, batch, impl=impl)[0]
               for impl in ("auto", "pallas")}
        out["loss"] = model.loss(params, batch)[0]
        for remat in (True, "dots"):
            out[f"grad_{remat}"] = torch.func.grad(
                lambda p: model.loss(p, batch, remat=remat)[0])(params)
        return out

    out, coll = _counted(run)
    grads = {k: gather_params(out.pop(k), mesh, cfg) if mesh.model_size > 1 else out.pop(k)
             for k in ("grad_True", "grad_dots")}
    return dict(_np(out), **_np(grads), collectives=coll)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serve_inputs(cfg, name):
    """Full inputs of a serving bundle, numpy, from a seed."""
    r = np.random.RandomState(4)
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if name == "prefill":
        return (dict(tokens=r.randint(0, cfg.vocab_size, (B, S_PROMPT)).astype(np.int32)),)
    if name in ("decode", "slots"):
        k = r.randn(L, B, CAP, Hkv, hd).astype(np.float32)
        v = r.randn(L, B, CAP, Hkv, hd).astype(np.float32)
        live = r.randint(4, CAP - 1, B)
        pos = np.where(np.arange(CAP)[None] < live[:, None], np.arange(CAP)[None], -1)
        ins = (transformer.DecodeCache(kv=(k, v, np.broadcast_to(
            pos, (L, B, CAP)).astype(np.int32).copy())),
               r.randint(0, cfg.vocab_size, B).astype(np.int32), live.astype(np.int32))
        return ins + ((np.arange(B) % 3 != 1),) if name == "slots" else ins
    n_pages = B * (CAP // PAGE)
    pool = transformer.PagedDecodeCache(kv=(
        r.randn(L, n_pages, PAGE, Hkv, hd).astype(np.float32),
        r.randn(L, n_pages, PAGE, Hkv, hd).astype(np.float32)))
    table = r.permutation(n_pages).reshape(B, CAP // PAGE).astype(np.int32)
    if name == "paged":
        return (pool, table, r.randint(0, cfg.vocab_size, B).astype(np.int32),
                r.randint(0, CAP, B).astype(np.int32), np.arange(B) % 4 != 3)
    return (pool, table[0], r.randint(0, cfg.vocab_size, (1, CHUNK)).astype(np.int32),
            S_PROMPT, 12)


def _torch_state(x):
    if isinstance(x, transformer.DecodeCache):
        return transformer.DecodeCache(kv=transformer.attn.KVCache(
            *(torch.from_numpy(np.array(t)) for t in x.kv)))
    if isinstance(x, transformer.PagedDecodeCache):
        return transformer.PagedDecodeCache(kv=transformer.attn.PagedKVPool(
            *(torch.from_numpy(np.array(t)) for t in x.kv)))
    if isinstance(x, dict):
        return _t(x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    return x


BUNDLE_KW = dict(prefill=("prefill", {}), decode=("decode", {}),
                 slots=("decode", dict(slot_masked=True)),
                 paged=("decode", dict(paged=True, cache_update="kernel")),
                 chunk=("prefill", dict(paged=True, cache_update="kernel")))


def serve(mesh, arch, name):
    """One serving bundle on ``mesh`` from the full state: (logits, the
    rank's cache pieces)."""
    cfg = fwd_config(arch)
    kind, kw = BUNDLE_KW[name]
    model = build_model(cfg, device="cpu")
    b = build_bundle(model, mesh, ShapeConfig("s", CAP, B, kind), **kw)
    full = [_torch_state(x) for x in serve_inputs(cfg, name)]
    ins = b.shard_inputs(model.init(0), *full)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the chunk write's P6 notice
        (logits, cache), coll = _counted(lambda: b.fn(*ins))
    return dict(logits=_np(logits), cache=tuple(_np(t) for t in cache.kv), collectives=coll)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def rank_main(round_init, sgd_init):
    mesh = make_host_mesh(S.DATA, S.MODEL, device="cpu")
    heavy = mesh.coords["data"] == 0  # model-sized results from one client shard
    out = dict(rank=mesh.rank, coords=mesh.coords, round=round_sharded(mesh, round_init),
               sgd=sgd(mesh, sgd_init))
    out["fwd"] = {n: forward(mesh, n) for n in FWD}
    out["serve"] = {f"{a}/{n}": serve(mesh, a, n) for a, names in SERVE.items()
                    for n in names}
    if not heavy:  # the other client shards' model-sized outputs are checked equal
        for f in out["fwd"].values():
            f.pop("grad_True"), f.pop("grad_dots")
    return out


def unsharded(round_init, sgd_init):
    mesh = make_host_mesh(1, 1, device="cpu")
    return dict(round=round_unsharded(round_init), sgd=sgd(mesh, sgd_init),
                fwd={n: forward(mesh, n) for n in FWD},
                serve={f"{a}/{n}": serve(mesh, a, n) for a, names in SERVE.items()
                       for n in names})
