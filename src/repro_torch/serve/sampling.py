"""Token selection for the serve loops (port of ``repro/serve/sampling.py``).

``temperature == 0`` is greedy: ``argmax`` over the vocabulary, first
index on ties, as ``jnp.argmax`` — the exact greedy program, no epsilon
temperature.

``temperature > 0`` keeps the JAX package's contract, not its bits: the
draw for a request's ``n``-th generated token depends only on ``(seed,
rid, n)``, never on the slot the request landed in, the batch it shares or
the schedule. torch cannot reproduce ``jax.random.fold_in``, so the port
uses a counter-based stream of its own: every (row, vocabulary entry) gets
a uniform from an integer hash of ``(seed, rid, n, v)``, and the token is
the Gumbel-max over the scaled, top-k-masked logits,
``argmax(logits / T + g)`` with ``g = -log(-log(u))``, which draws from
``softmax(logits / T)`` over the kept entries.

Why a hash and not a ``torch.Generator`` a row: the hash is one batched
computation a tick (about twenty elementwise launches over ``[B, V]``),
where a generator a row costs B launches; and its uniforms are integer
arithmetic, so the CPU and the card give the same bits. Every product of
the hash stays inside int64 (32-bit multiplies done in 16-bit halves), so
nothing relies on signed overflow. The uniforms are exact float64 values
strictly inside (0, 1), so the noise is always finite (a float32 uniform
of 24 bits would round its top value to 1.0 and give +inf). The Gumbel
transform runs in float64 and is rounded to float32, so a last-bit
difference between two ``log`` implementations (vectorised and scalar
loops, CPU and card) almost never reaches the float32 noise.
"""
from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """temperature: 0.0 = greedy argmax; > 0 scales logits before the
    categorical draw. top_k: keep only the k highest logits (0 = full
    vocabulary; k > V keeps everything). seed: base of every request's
    sample stream."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


GREEDY = SamplerConfig()


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant ``c`` <
    2^32, with every intermediate below 2^49."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """A 32-bit integer finaliser (xor-shift-multiply, Wellons' "lowbias32")
    on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_bits(seed: int, rid, nstep, vocab_size: int):
    """The sample stream's raw draws: rid [B], nstep [B] int -> int64 [B, V]
    of 32-bit integers, a function of ``(seed, rid, n, v)`` alone."""
    dev = rid.device
    base = _hash32(torch.tensor(seed & _M32, dtype=torch.int64, device=dev))
    key = _hash32(base ^ (rid.to(torch.int64) & _M32))
    key = _hash32(key ^ (nstep.to(torch.int64) & _M32))  # [B]
    v = _hash32((torch.arange(vocab_size, dtype=torch.int64, device=dev) + 0x9E3779B9) & _M32)
    return _hash32(key[:, None] ^ v[None, :])


def stream_uniforms(seed: int, rid, nstep, vocab_size: int):
    """Uniforms ``(m + 0.5) / 2^32`` strictly inside (0, 1), float64 [B, V]:
    every step is exact in float64, so every device gives the same bits."""
    bits = stream_bits(seed, rid, nstep, vocab_size)
    return (bits.to(torch.float64) + 0.5) * 2.0 ** -32


def make_sample_fn(sampler: SamplerConfig):
    """-> f(logits [B, V], rid [B], nstep [B]) -> tok [B] int32.

    ``nstep`` is the request's generated-token counter (0 for the
    prefill-produced first token). Greedy ignores rid and nstep."""
    if sampler.temperature == 0.0:
        def greedy(logits, rid, nstep):
            return torch.argmax(logits, dim=-1).to(torch.int32)

        return greedy

    temp, top_k, seed = sampler.temperature, sampler.top_k, sampler.seed
    if temp < 0:
        raise ValueError(f"temperature must be >= 0, got {temp}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = full vocab), got {top_k}")

    def sample(logits, rid, nstep):
        scaled = logits.to(torch.float32) / temp
        V = scaled.shape[-1]
        if top_k:
            # k > V keeps the whole vocabulary, as the JAX sampler clamps it
            kth = torch.topk(scaled, min(top_k, V), dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled, torch.full_like(scaled, NEG_INF))
        u = stream_uniforms(seed, rid, nstep, V)
        gumbel = (-torch.log(-torch.log(u))).to(torch.float32)
        return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)

    return sample
