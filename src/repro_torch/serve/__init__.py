"""Continuous-batching decode serving (port of ``repro/serve``).

Public surface:
  * ``Request`` / ``RequestQueue`` / ``SlotTable`` / ``PageAllocator`` /
    ``PrefixCache`` — host-side bookkeeping (copied from the JAX package);
  * ``ServeLoop`` — admission + decode + retirement over one contiguous
    cache; ``PagedServeLoop`` — the same over a shared KV page pool, with
    the front-end scheduler;
  * ``SerialLoop`` / ``serial_generate`` — one request at a time, the
    parity oracle of the batched loops;
  * ``SamplerConfig`` / ``GREEDY`` — greedy or sampled token selection;
  * ``poisson_trace`` — mixed-length synthetic request traces;
  * ``ServeUnsupportedError`` — raised for models with no decode path.

Run ``python -m repro_torch.serve --help`` for the command line.
"""
from repro_torch.serve.loop import (PagedServeLoop, SerialLoop, ServeLoop,
                                    ServeUnsupportedError, serial_generate)
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
    "SerialLoop",
    "ServeLoop",
    "ServeUnsupportedError",
    "SlotTable",
    "poisson_trace",
    "serial_generate",
]
