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


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises when no
    GPU is present rather than running on the CPU)."""
    dev = resolve_device(device)
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


def build_model_by_name(name: str, reduced: bool = False, device=None) -> Model:
    cfg = get_arch(name)
    return build_model(cfg.reduced() if reduced else cfg, device=device)
