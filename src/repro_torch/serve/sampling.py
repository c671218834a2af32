"""Token selection for the serve loops (port of ``repro/serve/sampling.py``).

Only greedy decode is ported: ``argmax`` over the vocabulary, first index
on ties, as ``jnp.argmax``. Temperature / top-k sampling draws per-request
``jax.random`` streams that torch cannot reproduce; it is queued in
ROADMAP.md ("the rest of serving") and raises here.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """temperature: 0.0 = greedy argmax; top_k: 0 = full vocab; seed: base
    of the per-request sample streams (sampled decode is not ported)."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


GREEDY = SamplerConfig()


def make_sample_fn(sampler: SamplerConfig):
    """-> f(logits [B, V], rid [B], nstep [B]) -> tok [B] int32."""
    if sampler.temperature != 0.0:
        raise NotImplementedError(
            "sampled decode (temperature > 0) is not ported yet (ROADMAP.md, "
            "'the rest of serving'); use GREEDY")

    def greedy(logits, rid, nstep):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return greedy
