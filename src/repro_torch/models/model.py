"""Model API of the port (serving surface of ``repro/models/model.py``).

    model = build_model(cfg, device="cuda")
    params = model.init(seed)                          -> flat dict of tensors
    model.prefill(params, batch, pad_to=, length=)     -> (logits, DecodeCache)
    model.init_paged_cache(n_slots, n_pages, page_size) -> PagedDecodeCache
    model.paged_decode_step(params, cache, page_table, token, pos, ...)

Only the dense decoder family is ported; the others raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    config: ArchConfig
    device: torch.device
    init: Callable
    prefill: Optional[Callable]
    paged_decode_step: Optional[Callable]
    init_paged_cache: Optional[Callable]


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The serving model of ``cfg`` on ``device`` (default ``cuda``; raises
    when no GPU is present rather than running on the CPU)."""
    dev = resolve_device(device)
    transformer.check_dense(cfg)
    return Model(
        config=cfg,
        device=dev,
        init=lambda seed=0: transformer.init_params(cfg, seed=seed, device=dev),
        prefill=functools.partial(transformer.prefill, cfg),
        paged_decode_step=functools.partial(transformer.paged_decode_step, cfg),
        init_paged_cache=functools.partial(transformer.init_paged_cache, cfg,
                                           device=dev),
    )


def decode_capability(model: Model) -> tuple[bool, str]:
    """Whether this model can serve the paged decode path, with the reason
    if not."""
    if model.paged_decode_step is not None and model.init_paged_cache is not None:
        return True, ""
    return False, (f"{model.config.name}: family={model.config.family!r} "
                   "exposes no paged decode path")


def build_model_by_name(name: str, reduced: bool = False, device=None) -> Model:
    cfg = get_arch(name)
    return build_model(cfg.reduced() if reduced else cfg, device=device)
