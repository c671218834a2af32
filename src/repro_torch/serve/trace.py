"""Synthetic request traces for the serve loop (benchmarks + tests).

A copy of the JAX package's ``serve/trace.py``: numpy ``RandomState``
draws, so the same arguments give the same trace in both packages.

A trace is a list of ``Request`` with Poisson arrivals (exponential
inter-arrival gaps, measured in loop ticks) and mixed prompt/decode
lengths — the ragged-workload regime continuous batching exists for.
The bursty/shared-prefix knobs model the production front-end regimes
the §12.2 scheduler targets: overload windows (preemption pressure) and
request families sharing a long system-prompt prefix (prefix-cache
hits).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.slots import Request


def poisson_trace(
    n_requests: int,
    *,
    rate: float = 2.0,  # mean arrivals per tick
    plen_choices: Sequence[int] = (8, 16, 24, 32),
    max_new_choices: Sequence[int] = (4, 8, 12),
    vocab_size: int = 256,
    eos_id: Optional[int] = None,
    seed: int = 0,
    burst_mult: float = 1.0,
    burst_period: int = 0,
    prefix_families: int = 0,
    prefix_len: int = 0,
) -> list:
    """Mixed-length Poisson request trace.

    Prompt lengths are drawn from ``plen_choices`` (a small set, so
    bucketed/exact prefill compiles a bounded number of programs), decode
    budgets from ``max_new_choices``; arrival ticks are the cumulative sum
    of Exp(rate) gaps, floored to ints.

    Bursty overload (``burst_mult > 1`` with ``burst_period > 0``):
    alternating windows of ``burst_period`` base-rate ticks; gaps whose
    base arrival falls in an odd window shrink by ``burst_mult`` —
    deterministic rate spikes that overload a fixed-size pool without
    changing any other draw.

    Shared-prefix families (``prefix_families > 0`` with
    ``prefix_len > 0``): each request is prepended with one of
    ``prefix_families`` fixed random prefixes of ``prefix_len`` tokens
    (``plen_choices`` become SUFFIX lengths) — the system-prompt regime
    prefix caching exists for.

    Determinism: same args, same trace — and the default values draw the
    exact RNG stream of the pre-burst trace generator, so seeds pinned by
    older tests/benchmarks reproduce bit-identically (new draws only
    happen when the new knobs are non-default, and they happen AFTER the
    gap draws in a dedicated order).
    """
    r = np.random.RandomState(seed)
    gaps = r.exponential(1.0 / max(rate, 1e-9), n_requests)
    if burst_period > 0 and burst_mult != 1.0:
        # window parity comes from the UNSCALED cumulative clock, so the
        # burst schedule is a property of the base process (same windows
        # at every burst_mult)
        base = np.cumsum(gaps)
        in_burst = (np.floor(base / burst_period).astype(int) % 2) == 1
        gaps = np.where(in_burst, gaps / burst_mult, gaps)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    fam_prefix = None
    if prefix_families > 0 and prefix_len > 0:
        fam_prefix = r.randint(0, vocab_size,
                               (prefix_families, prefix_len)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        plen = int(r.choice(plen_choices))
        toks = r.randint(0, vocab_size, plen).astype(np.int32)
        if fam_prefix is not None:
            fam = int(r.randint(prefix_families))
            toks = np.concatenate([fam_prefix[fam], toks])
        reqs.append(Request(
            rid=i,
            tokens=toks,
            max_new=int(r.choice(max_new_choices)),
            eos_id=eos_id,
            arrival=int(arrivals[i]),
        ))
    return reqs
