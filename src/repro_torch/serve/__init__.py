"""Continuous-batching decode serving on a paged KV pool (port of
``repro/serve``).

Public surface:
  * ``Request`` / ``RequestQueue`` / ``SlotTable`` / ``PageAllocator`` /
    ``PrefixCache`` — host-side bookkeeping (copied from the JAX package);
  * ``PagedServeLoop`` — admission + paged decode + retirement;
  * ``SamplerConfig`` / ``GREEDY`` — greedy token selection;
  * ``poisson_trace`` — mixed-length synthetic request traces;
  * ``ServeUnsupportedError`` — raised for models with no decode path.

Run ``python -m repro_torch.serve --help`` for the command line.
"""
from repro_torch.serve.loop import PagedServeLoop, ServeLoop, ServeUnsupportedError
from repro_torch.serve.sampling import GREEDY, SamplerConfig
from repro_torch.serve.slots import (PageAllocator, PrefixCache, Request,
                                     RequestQueue, SlotTable)
from repro_torch.serve.trace import poisson_trace

__all__ = [
    "GREEDY",
    "PageAllocator",
    "PagedServeLoop",
    "PrefixCache",
    "Request",
    "RequestQueue",
    "SamplerConfig",
    "ServeLoop",
    "ServeUnsupportedError",
    "SlotTable",
    "poisson_trace",
]
