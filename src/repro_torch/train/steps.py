"""Step bundles: the FedVeca round, an SGD train step, prefill and decode
on a mesh (port of ``repro/train/steps.py``).

Each builder returns a ``StepBundle(fn, make_inputs, name, shard_inputs)``
with the JAX package's keywords:

  * ``make_inputs()`` gives the step's GLOBAL inputs in call order, with
    the JAX package's shapes and dtypes, as ``meta`` tensors (nothing is
    drawn);
  * ``shard_inputs(*full)`` cuts full inputs (real tensors of those
    shapes) to this rank's pieces on the mesh's device: the parameters by
    the port's model-axis layout (``sharding.partition.shard_params``),
    client and batch rows by the rank's client coordinates, cache and pool
    leaves to the rank's kv heads;
  * ``fn(*pieces)`` runs the step on this rank's pieces under
    ``sharding.api.logical_axis_rules(mesh)``, issuing the collectives
    that the JAX package leaves to GSPMD.

Where the JAX package lays an input out by ``param_specs`` /
``batch_specs`` / ``cache_specs`` / ``paged_cache_specs``, the port's
layout is head-granular and keeps paged pools whole over the data axes;
ROADMAP.md P12 lists every difference, and which of the keywords
``fed_batch_rules``, ``stat_dtype``, ``remat``, ``cache_update`` and
``kv_seq_shard`` the layout makes moot. ``unroll``/``unroll_tau`` are the
JAX package's compile knobs and are accepted and ignored.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value

from repro_torch import strict_fp32
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.fedveca import make_round_step
from repro_torch.launch.mesh import num_clients
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache, PagedKVPool
from repro_torch.models.model import build_model, input_specs, params_struct
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import DecodeCache, PagedDecodeCache
from repro_torch.sharding import partition
from repro_torch.sharding.api import (all_reduce, all_reduce_tree, client_group,
                                      client_rows, logical_axis_rules)

__all__ = ["StepBundle", "params_struct", "build_bundle", "make_fedveca_round_bundle",
           "make_train_step_bundle", "make_prefill_bundle", "make_decode_bundle",
           "make_slot_decode_bundle", "make_paged_decode_bundle",
           "make_paged_prefill_bundle"]


class StepBundle(NamedTuple):
    fn: Any  # the step on this rank's pieces
    make_inputs: Callable[[], tuple]  # global meta tensors in call order
    name: str
    shard_inputs: Optional[Callable[..., tuple]] = None  # full inputs -> this rank's


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _on(model, mesh):
    """``model`` built for ``mesh`` (rebuilt when it was built for another
    or none: the parameters are not touched)."""
    if model.mesh is mesh or (model.mesh is None and mesh.model_size == 1):
        return model
    return build_model(model.config, device=mesh.device, mesh=mesh)


def _rows(mesh, n: int) -> Optional[range]:
    """The rows of a leading batch dim of ``n`` this rank holds: its client
    shard's (the data axes divide ``n``), or every row."""
    k = mesh.size // mesh.model_size
    return client_rows(mesh, n) if k > 1 and n % k == 0 else None


def _take(t: torch.Tensor, rows: Optional[range], dim: int = 0) -> torch.Tensor:
    return t if rows is None else t.narrow(dim, rows.start, len(rows))


def _cut(mesh, split: bool, t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``'s ``dim`` cut to this rank's share when ``split`` (kv heads,
    SSM channels or xLSTM heads of a layout that splits them)."""
    if not split:
        return t
    m, r = mesh.model_size, mesh.coords["model"]
    n = t.shape[dim] // m
    return t.narrow(dim, r * n, n)


def _to(mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device).contiguous()


def _shard_params(mesh, cfg, params):
    return {k: _to(mesh, v) for k, v in partition.shard_params(params, mesh, cfg).items()}


def _shard_cache(mesh, cfg, cache):
    """A contiguous ``DecodeCache``'s or a ``PagedDecodeCache``'s leaves cut
    to this rank: batch rows over the data axes (contiguous caches, where
    they divide) and, over the model axis, kv heads, the hybrid family's
    SSM channels (``h`` [.., d_in, N], ``conv`` [.., K-1, d_in]) and the
    xLSTM states' heads."""
    lay = partition.layout(cfg, mesh.model_size)

    def ssm(st, rows):
        if st is None:
            return None
        h, conv = (_take(t, rows, 1) for t in st)
        return SSMState(_to(mesh, _cut(mesh, lay.ssm, h, 2)),
                        _to(mesh, _cut(mesh, lay.ssm, conv, 3)))

    if isinstance(cache, PagedDecodeCache):  # every slot on every data rank (P12)
        return PagedDecodeCache(
            kv=PagedKVPool(*(_to(mesh, _cut(mesh, lay.attn, t, 3)) for t in cache.kv)),
            ssm=ssm(cache.ssm, None))
    if cache.kv is None:  # xLSTM: [n_super, n_per, B, H, ...]
        rows = _rows(mesh, cache.xlstm_m.C.shape[2])
        return DecodeCache(kv=None, **{
            f: type(st)(*(_to(mesh, _cut(mesh, lay.xlstm, _take(t, rows, 2), 3)) for t in st))
            for f, st in (("xlstm_m", cache.xlstm_m), ("xlstm_s", cache.xlstm_s))})
    rows = _rows(mesh, cache.kv.k.shape[1])
    k, v, pos = cache.kv
    return DecodeCache(kv=KVCache(
        _to(mesh, _cut(mesh, lay.attn, _take(k, rows, 1), 3)),
        _to(mesh, _cut(mesh, lay.attn, _take(v, rows, 1), 3)),
        _to(mesh, _take(pos, rows, 1))), ssm=ssm(cache.ssm, rows))


def _loss_kw(cfg: ArchConfig, remat) -> dict:
    return {} if cfg.family == "toy" or remat == "keep" else {"remat": remat}


# ---------------------------------------------------------------------------
# FedVeca federated round at scale (the paper's technique)
# ---------------------------------------------------------------------------


def make_fedveca_round_bundle(
    model, mesh, shape: ShapeConfig, *, tau_max: int = 2, eta: float = 1e-3,
    mode: str = "fedveca", stat_dtype=torch.float32, unroll: int = 1,
    unroll_tau: bool = False, remat="keep", fed_batch_rules: str = "client_exclusive",
) -> StepBundle:
    """One round over C = the data extent clients (one a client shard),
    each on ``global_batch / C`` rows a step. ``fn(params, batches, tau, p,
    gprev_sqnorm)`` takes the rank's pieces (its clients' rows of the
    [C, ...] inputs) and returns (new params pieces, ``RoundStats`` with the
    rank's per-client rows); the reduce is the vecavg kernel, completed
    over the client and model groups."""
    del unroll, unroll_tau
    model = _on(model, mesh)
    cfg: ArchConfig = model.config
    C = num_clients(mesh)
    if shape.global_batch % C:
        raise ValueError(f"global batch {shape.global_batch} does not divide over C={C}")
    b = shape.global_batch // C
    lkw = _loss_kw(cfg, remat)
    loss = functools.partial(model.loss, **lkw) if lkw else model.loss
    round_fn = make_round_step(loss, eta=eta, mode=mode, axis_name=client_group(mesh),
                               model_axis=model.model_axis, stat_dtype=stat_dtype)
    # inside the round the data axes are the clients' (the JAX package's
    # "client_exclusive" rule); the port's activations are laid out by
    # construction, so the rule changes nothing here (P12)
    rules = {"batch": None} if fed_batch_rules == "client_exclusive" else {}

    def fn(params, batches, tau, p, gprev_sqnorm):
        with logical_axis_rules(mesh, rules), strict_fp32():
            new_params, stats, _ = round_fn(params, batches, tau, p, gprev_sqnorm)
        return new_params, stats

    def make_inputs():
        spec = input_specs(cfg, shape)
        return (params_struct(model),
                {k: _meta((C, tau_max, b) + tuple(v.shape[1:]), v.dtype)
                 for k, v in spec.items()},
                _meta((C,), torch.int32), _meta((C,), torch.float32),
                _meta((), torch.float32))

    def shard_inputs(params, batches, tau, p, gprev_sqnorm):
        rows = client_rows(mesh, C)
        return (_shard_params(mesh, cfg, params),
                {k: _to(mesh, _take(v, rows)) for k, v in batches.items()},
                _to(mesh, _take(tau, rows)), _to(mesh, _take(p, rows)),
                _to(mesh, torch.as_tensor(gprev_sqnorm, dtype=torch.float32)))

    return StepBundle(fn, make_inputs, f"fedveca_round[{mode}]", shard_inputs)


# ---------------------------------------------------------------------------
# plain data-parallel SGD train step (centralized baseline at scale)
# ---------------------------------------------------------------------------


def make_train_step_bundle(model, mesh, shape: ShapeConfig, *, eta: float = 1e-3,
                           unroll: int = 1) -> StepBundle:
    """``fn(params, batch) -> (new params pieces, loss)``: the rank's batch
    rows (the data axes), its gradient averaged over the data group (the
    global batch's mean loss where the shards hold equal token counts;
    P12), one SGD step in float32 cast back."""
    del unroll
    model = _on(model, mesh)
    cfg = model.config
    group = client_group(mesh)
    B = shape.global_batch
    k = mesh.size // mesh.model_size if _rows(mesh, B) is not None else 1
    gv = grad_and_value(model.loss, has_aux=True)

    def fn(params, batch):
        with logical_axis_rules(mesh):
            g, (loss_v, _) = gv(params, batch)
            if k > 1:
                g = {n: x / k for n, x in all_reduce_tree(g, group).items()}
                loss_v = all_reduce([loss_v], group)[0] / k
            new = {n: (w.float() - eta * g[n].float()).to(w.dtype) for n, w in params.items()}
        return new, loss_v

    def shard_inputs(params, batch):
        rows = _rows(mesh, B)
        return (_shard_params(mesh, cfg, params),
                {n: _to(mesh, _take(v, rows)) for n, v in batch.items()})

    return StepBundle(fn, lambda: (params_struct(model), input_specs(cfg, shape)),
                      "train_step[sgd]", shard_inputs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_bundle(model, mesh, shape: ShapeConfig, *, unroll: int = 1) -> StepBundle:
    """``fn(params, batch) -> (last-token logits, cache)`` on the rank's
    batch rows; the cache holds the rank's kv heads."""
    model = _on(model, mesh)
    cfg = model.config

    def fn(params, batch):
        with logical_axis_rules(mesh):
            return model.prefill(params, batch, unroll=unroll)

    def shard_inputs(params, batch):
        rows = _rows(mesh, shape.global_batch)
        return (_shard_params(mesh, cfg, params),
                {n: _to(mesh, _take(v, rows)) for n, v in batch.items()})

    return StepBundle(fn, lambda: (params_struct(model), input_specs(cfg, shape)), "prefill",
                      shard_inputs)


def _decode_bundle(model, mesh, shape: ShapeConfig, *, unroll: int, cache_update: str,
                   kv_seq_shard: bool, slots: bool) -> StepBundle:
    del kv_seq_shard  # the port keeps the cache length whole (P12)
    model = _on(model, mesh)
    cfg: ArchConfig = model.config
    B = shape.global_batch
    dkw = {} if cfg.family == "ssm" else {"cache_update": cache_update}

    def fn(params, cache, token, pos, active=None):
        with logical_axis_rules(mesh):
            kw = dict(dkw, active=active) if slots else dkw
            return model.decode_step(params, cache, token, pos, unroll=unroll, **kw)

    def make_inputs():
        ins = (params_struct(model),
               transformer.init_cache(cfg, B, shape.seq_len, device="meta"),
               _meta((B,), torch.int32), _meta((B,), torch.int32))
        return ins + (_meta((B,), torch.bool),) if slots else ins

    def shard_inputs(params, cache, token, pos, *active):
        rows = _rows(mesh, B)
        return (_shard_params(mesh, cfg, params), _shard_cache(mesh, cfg, cache),
                *(_to(mesh, _take(t, rows)) for t in (token, pos, *active)))

    return StepBundle(fn, make_inputs, "decode_step[slots]" if slots else "decode_step",
                      shard_inputs)


def make_decode_bundle(model, mesh, shape: ShapeConfig, *, unroll: int = 1,
                       cache_update: str = "mask", kv_seq_shard: bool = True) -> StepBundle:
    """``fn(params, cache, token, pos) -> (logits [B, V], cache)`` on the
    rank's rows and kv heads; the cache is updated in place."""
    return _decode_bundle(model, mesh, shape, unroll=unroll, cache_update=cache_update,
                          kv_seq_shard=kv_seq_shard, slots=False)


def make_slot_decode_bundle(model, mesh, shape: ShapeConfig, *, unroll: int = 1,
                            cache_update: str = "mask",
                            kv_seq_shard: bool = True) -> StepBundle:
    """The slot-masked decode: ``fn(params, cache, token, pos, active)``;
    inactive rows leave every cache entry as it was."""
    return _decode_bundle(model, mesh, shape, unroll=unroll, cache_update=cache_update,
                          kv_seq_shard=kv_seq_shard, slots=True)


def _paged_sizes(cfg, shape: ShapeConfig, page_size: int, n_pages: Optional[int]):
    W = cfg.sliding_window
    P_slot = -(-(W if W else shape.seq_len) // page_size)
    return P_slot, (shape.global_batch * P_slot if n_pages is None else n_pages)


def make_paged_decode_bundle(model, mesh, shape: ShapeConfig, *, page_size: int = 16,
                             n_pages: Optional[int] = None, cache_update: str = "mask",
                             unroll: int = 1) -> StepBundle:
    """``fn(params, cache, page_table, token, pos, active) -> (logits,
    cache)`` against the page pool ([L, n_pages, page_size, Hkv, hd], the
    rank's kv heads; every slot on every data rank, P12). ``cache_update=
    "kernel"`` walks the local pool with the paged decode kernel through
    the same page table on every rank."""
    del unroll
    model = _on(model, mesh)
    cfg: ArchConfig = model.config
    if model.paged_decode_step is None or model.init_paged_cache is None:
        raise ValueError(f"{cfg.name}: no paged decode path (family has no KV cache to page)")
    B = shape.global_batch
    P_slot, N = _paged_sizes(cfg, shape, page_size, n_pages)

    def fn(params, cache, page_table, token, pos, active):
        with logical_axis_rules(mesh):
            return model.paged_decode_step(params, cache, page_table, token, pos,
                                           cache_update=cache_update, active=active)

    def make_inputs():
        return (params_struct(model),
                transformer.init_paged_cache(cfg, B, N, page_size, device="meta"),
                _meta((B, P_slot), torch.int32), _meta((B,), torch.int32),
                _meta((B,), torch.int32), _meta((B,), torch.bool))

    def shard_inputs(params, cache, page_table, token, pos, active):
        return (_shard_params(mesh, cfg, params), _shard_cache(mesh, cfg, cache),
                *(_to(mesh, t) for t in (page_table, token, pos, active)))

    return StepBundle(fn, make_inputs, "decode_step[paged]", shard_inputs)


def make_paged_prefill_bundle(model, mesh, shape: ShapeConfig, *, page_size: int = 16,
                              n_pages: Optional[int] = None, chunk: int = 16,
                              cache_update: str = "mask", unroll: int = 1) -> StepBundle:
    """``fn(params, cache, page_row, tokens, start, length) -> (logits,
    cache)``: one batch-1 chunk of ``chunk`` tokens written into the pool
    (the rank's kv heads) and attended against it. ``cache_update=
    "kernel"`` warns and takes the mask write, as the JAX package does
    (ROADMAP.md P6)."""
    model = _on(model, mesh)
    cfg: ArchConfig = model.config
    if model.paged_prefill_chunk is None:
        raise ValueError(f"{cfg.name}: no paged chunk-prefill path")
    if cfg.sliding_window or cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        raise ValueError(f"{cfg.name}: chunk prefill is full-attention KV-only "
                         "(see models.transformer.paged_prefill_chunk)")
    P_slot, N = _paged_sizes(cfg, shape, page_size, n_pages)
    if cache_update == "kernel":
        transformer.warn_kernel_extend_fallback("train.steps.make_paged_prefill_bundle")
    cu = "mask" if cache_update == "kernel" else cache_update

    def fn(params, cache, page_row, tokens, start, length):
        with logical_axis_rules(mesh):
            return model.paged_prefill_chunk(params, cache, page_row, tokens, int(start),
                                             int(length), unroll=unroll, cache_update=cu)

    def make_inputs():
        return (params_struct(model),
                transformer.init_paged_cache(cfg, shape.global_batch, N, page_size,
                                             device="meta"),
                _meta((P_slot,), torch.int32), _meta((1, chunk), torch.int32),
                _meta((), torch.int32), _meta((), torch.int32))

    def shard_inputs(params, cache, page_row, tokens, start, length):
        return (_shard_params(mesh, cfg, params), _shard_cache(mesh, cfg, cache),
                _to(mesh, page_row), _to(mesh, tokens), start, length)

    return StepBundle(fn, make_inputs, "prefill_chunk[paged]", shard_inputs)


def build_bundle(model, mesh, shape: ShapeConfig, *, kind: Optional[str] = None,
                 **kw) -> StepBundle:
    """The bundle of ``shape.kind`` (or ``kind``), as the JAX package picks
    it: train -> the FedVeca round (the toy models, or ``plain_sgd=True``:
    the SGD step); prefill -> ``paged=True``: the chunk prefill; decode ->
    ``paged=True``: the paged decode, ``slot_masked=True``: the
    slot-masked one."""
    kind = kind or shape.kind
    if kind == "train":
        if model.config.family == "toy" or kw.pop("plain_sgd", False):
            kw.pop("unroll_tau", None)
            kw.pop("tau_max", None)
            return make_train_step_bundle(model, mesh, shape, **kw)
        return make_fedveca_round_bundle(model, mesh, shape, **kw)
    if kind == "prefill":
        if kw.pop("paged", False):
            return make_paged_prefill_bundle(
                model, mesh, shape, unroll=kw.get("unroll", 1),
                page_size=kw.get("page_size", 16), n_pages=kw.get("n_pages"),
                chunk=kw.get("chunk", 16), cache_update=kw.get("cache_update", "mask"))
        return make_prefill_bundle(model, mesh, shape, unroll=kw.get("unroll", 1))
    if kind == "decode":
        if kw.pop("paged", False):
            return make_paged_decode_bundle(
                model, mesh, shape, unroll=kw.get("unroll", 1),
                page_size=kw.get("page_size", 16), n_pages=kw.get("n_pages"),
                cache_update=kw.get("cache_update", "mask"))
        maker = make_slot_decode_bundle if kw.pop("slot_masked", False) \
            else make_decode_bundle
        return maker(model, mesh, shape, unroll=kw.get("unroll", 1),
                     cache_update=kw.get("cache_update", "mask"),
                     kv_seq_shard=kw.get("kv_seq_shard", True))
    raise ValueError(kind)
