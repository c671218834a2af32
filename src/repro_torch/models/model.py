"""Model API of the port (``repro/models/model.py``).

    model = build_model(cfg, device="cuda")
    params = model.init(seed)                          -> flat dict of tensors
    model.loss(params, batch[, impl=, remat=])         -> (scalar, metrics)
    model.forward(params, batch[, impl=, remat=])      -> (logits, aux) / scores [toy]
    model.prefill(params, batch, impl=, window=, pad_to=, length=) -> (logits, DecodeCache)
    model.init_cache(batch, seq_len[, window]) -> DecodeCache
    model.decode_step(params, cache, token, pos, ...) -> (logits, DecodeCache)
    model.init_paged_cache(n_slots, n_pages, page_size) -> PagedDecodeCache
    model.paged_decode_step(params, cache, page_table, token, pos, ...)
    model.paged_prefill_chunk(params, cache, page_row, tokens, start, length, ...)

``build_model(cfg, device, mesh=)`` builds the model for one rank of a
mesh with a model axis (ROADMAP.md A18b, A18c; every family): ``init``
returns this rank's pieces of the seed's full parameters
(``sharding.partition.shard_params``: the same bits as the unsharded init,
cut), the cache builders make the rank's kv heads, SSM channels and xLSTM
heads, every other entry point runs under
``sharding.api.logical_axis_rules(mesh)``, and ``model_axis`` is what the
federated round needs of the axis (its group, the sharded leaves).

The decoder families (dense, MoE, hybrid, xLSTM, VLM: forward, loss,
prefill and contiguous decode; every one but xLSTM: paged decode; chunked
prefill for full-attention KV-only models, the function gates), the audio
encoder-decoder (forward, loss, prefill; no decode, as in the JAX package)
and the paper's toy models (svm-mnist, cnn-mnist, cnn-cifar10; training)
are ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import encdec, simple, transformer
from repro_torch.sharding import api
from repro_torch.sharding.partition import model_axis, shard_params


@dataclasses.dataclass(frozen=True)
class Model:
    config: ArchConfig
    device: torch.device
    init: Callable
    prefill: Optional[Callable]
    paged_decode_step: Optional[Callable]
    init_paged_cache: Optional[Callable]
    loss: Optional[Callable] = None
    forward: Optional[Callable] = None
    # chunk or suffix prefill straight into the page pool (prefix caching
    # and chunked prefill; full-attention KV-only models, the function gates)
    paged_prefill_chunk: Optional[Callable] = None
    # one token a slot against the contiguous cache (ServeLoop, SerialLoop)
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    # a model built for a mesh with a model axis (build_model(mesh=))
    mesh: Optional[object] = None
    model_axis: Optional[object] = None  # sharding.partition.ModelAxis


def _toy_model(cfg: ArchConfig, dev: torch.device) -> Model:
    svm = cfg.name.startswith("svm")
    init_fn = simple.svm_init if svm else simple.cnn_init

    def init(seed: int = 0):
        return init_fn(torch.Generator(device=dev).manual_seed(seed), cfg, dev)

    return Model(
        config=cfg, device=dev, init=init, prefill=None, paged_decode_step=None,
        init_paged_cache=None,
        loss=functools.partial(simple.svm_loss if svm else simple.cnn_loss, cfg),
        forward=functools.partial(simple.svm_forward if svm else simple.cnn_forward, cfg),
    )


def build_model(cfg: ArchConfig, device=None, mesh=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises when no
    GPU is present rather than running on the CPU). ``mesh``: build it for
    this rank of a mesh whose model axis exceeds 1; a mesh without one
    changes nothing."""
    dev = resolve_device(device)
    model = _build(cfg, dev)
    if mesh is None or mesh.model_size == 1:
        return model
    return _for_mesh(model, mesh)


def _for_mesh(model: Model, mesh) -> Model:
    cfg = model.config

    def ctx(fn):
        if fn is None:
            return None

        @functools.wraps(fn)
        def run(*args, **kw):
            if api.current_mesh() is mesh:
                return fn(*args, **kw)
            with api.logical_axis_rules(mesh):
                return fn(*args, **kw)

        return run

    def init(seed: int = 0):
        return shard_params(model.init(seed), mesh, cfg)

    kv = dict(model_size=mesh.model_size)  # the rank's heads and channels
    return dataclasses.replace(
        model, init=init, mesh=mesh,
        model_axis=model_axis(mesh, cfg, params_struct(model)),
        prefill=ctx(model.prefill), paged_decode_step=ctx(model.paged_decode_step),
        init_paged_cache=(None if model.init_paged_cache is None else
                          functools.partial(model.init_paged_cache, **kv)),
        loss=ctx(model.loss), forward=ctx(model.forward),
        paged_prefill_chunk=ctx(model.paged_prefill_chunk),
        decode_step=ctx(model.decode_step),
        init_cache=(None if model.init_cache is None else
                    functools.partial(model.init_cache, **kv)))


def params_struct(model: Model):
    """The model's full (global) parameters as ``meta`` tensors: shapes and
    dtypes, nothing drawn."""
    cfg = model.config
    if cfg.family == "toy":
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in _toy_model(cfg, torch.device("cpu")).init(0).items()}
    if cfg.family == "audio":
        return encdec.init_params(cfg, device="meta")
    return transformer.init_params(cfg, device="meta")


def _build(cfg: ArchConfig, dev: torch.device) -> Model:
    if cfg.family == "toy":
        return _toy_model(cfg, dev)
    if cfg.family == "audio":
        return Model(
            config=cfg, device=dev,
            init=lambda seed=0: encdec.init_params(cfg, seed=seed, device=dev),
            prefill=functools.partial(encdec.prefill, cfg),
            paged_decode_step=None, init_paged_cache=None,  # no decode for whisper
            loss=functools.partial(encdec.loss_fn, cfg),
            forward=functools.partial(encdec.forward, cfg),
        )
    transformer.check_full_sequence(cfg)
    return Model(
        config=cfg,
        device=dev,
        init=lambda seed=0: transformer.init_params(cfg, seed=seed, device=dev),
        prefill=functools.partial(transformer.prefill, cfg),
        paged_decode_step=functools.partial(transformer.paged_decode_step, cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg,
                                           device=dev),
        paged_prefill_chunk=functools.partial(transformer.paged_prefill_chunk, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg, device=dev),
        loss=functools.partial(transformer.loss_fn, cfg),
        forward=functools.partial(transformer.forward, cfg),
    )


def input_specs(cfg: ArchConfig, shape) -> dict:
    """A step's inputs as ``meta`` tensors (the JAX ``Model.input_specs``):
    train: tokens and targets [B, S]; prefill: tokens [B, S]; decode: token
    and pos [B]; the audio family's frames and the VLM family's patches in
    the compute type; the toy models' x and y."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if cfg.family == "toy":
        return dict(x=meta((B,) + tuple(cfg.input_shape), torch.float32),
                    y=meta((B,), torch.int32))
    ct = getattr(torch, cfg.compute_dtype)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = meta((B, cfg.encoder_seq, cfg.frontend_dim), ct)
    if cfg.family == "vlm":
        extras["patches"] = meta((B, cfg.num_patches, cfg.vision_dim), ct)
    if shape.kind == "train":
        return dict(tokens=meta((B, S), torch.int32), targets=meta((B, S), torch.int32),
                    **extras)
    if shape.kind == "prefill":
        return dict(tokens=meta((B, S), torch.int32), **extras)
    return dict(token=meta((B,), torch.int32), pos=meta((B,), torch.int32))


def decode_capability(model: Model) -> tuple[bool, str]:
    """Whether this model can serve the decode path, with the reason if not
    (the JAX package's gate and words)."""
    if model.decode_step is not None and model.init_cache is not None:
        return True, ""
    if model.config.family == "audio":
        return False, (
            f"{model.config.name}: whisper's decoder is 448-token encoder-"
            "conditioned (needs `frames`, no decode_step/init_cache) — "
            "decode serving n/a; use prefill/forward (DESIGN.md §5)")
    return False, (
        f"{model.config.name}: family={model.config.family!r} exposes no "
        "decode path (decode_step/init_cache are None)")


def build_model_by_name(name: str, reduced: bool = False, device=None, mesh=None) -> Model:
    cfg = get_arch(name)
    return build_model(cfg.reduced() if reduced else cfg, device=device, mesh=mesh)
