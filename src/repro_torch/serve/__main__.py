"""Serve a Poisson request trace, as the JAX package's
``examples/serve_decode.py`` does.

    python -m repro_torch.serve --arch starcoder2-3b --paged
    python -m repro_torch.serve --device cpu --reduced --paged --requests 4
    python -m repro_torch.serve --device cpu --reduced --arch xlstm-1.3b --check
    python -m repro_torch.serve --device cpu --reduced --arch qwen1.5-32b --paged \
        --prefix-cache --prefill-chunk 16 --preempt --temperature 0.7 --top-k 8

``--paged`` serves through ``PagedServeLoop`` (a shared KV page pool), no
``--paged`` through the contiguous ``ServeLoop``, ``--serial`` through
``SerialLoop`` (one request at a time), and ``--check`` runs the batched
loop and the serial one on the same trace and exits non-zero unless every
stream is equal. By default the full configuration runs on the card, in its
own dtype, with random weights from ``--seed``; ``--device cpu --reduced``
is the CPU-sized run. ``--prefix-cache``, ``--prefill-chunk`` and
``--preempt`` turn on the paged scheduler's options, ``--temperature`` /
``--top-k`` sampled decode, and ``--prefix-families`` / ``--prefix-len`` /
``--burst-mult`` give the trace shared prompt prefixes and bursts of
arrivals; VLM requests carry seeded patches. Prints one stats line per run
as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.models.model import build_model_by_name
from repro_torch.serve import (PagedServeLoop, SamplerConfig, SerialLoop, ServeLoop,
                               ServeUnsupportedError, poisson_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--paged", action="store_true",
                    help="serve through PagedServeLoop (a shared KV page pool); "
                    "default: the contiguous ServeLoop")
    ap.add_argument("--serial", action="store_true",
                    help="serve through SerialLoop, one request at a time")
    ap.add_argument("--check", action="store_true",
                    help="run the batched loop and SerialLoop and require equal streams")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized smoke variant of the config")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=2.0, help="arrivals/tick")
    ap.add_argument("--plens", default="128,256,512,1024")
    ap.add_argument("--max-new", default="32,64,128")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=2048,
                    help="KV rows per slot (full-attention models)")
    ap.add_argument("--cache-update", default="kernel", choices=("kernel", "scatter", "mask"))
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes read-only across requests")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill at most this many prompt tokens a tick")
    ap.add_argument("--preempt", action="store_true",
                    help="evict the youngest live request when the queue's head "
                    "has been blocked for --preempt-after ticks")
    ap.add_argument("--preempt-after", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0 = full vocabulary")
    ap.add_argument("--prefix-families", type=int, default=0,
                    help="prompts start with one of this many shared prefixes")
    ap.add_argument("--prefix-len", type=int, default=0, help="tokens of each shared prefix")
    ap.add_argument("--burst-mult", type=float, default=1.0,
                    help="arrival rate multiplier during bursts")
    ap.add_argument("--burst-period", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.paged and (args.prefix_cache or args.prefill_chunk or args.preempt
                           or args.pages):
        ap.error("--prefix-cache, --prefill-chunk, --preempt and --pages need --paged")
    if args.serial and args.check:
        ap.error("--check runs the serial loop itself; drop --serial")

    model = build_model_by_name(args.arch, reduced=args.reduced, device=args.device)
    cfg = model.config
    params = model.init(args.seed)
    plens = tuple(int(x) for x in args.plens.split(","))
    if args.reduced:  # keep prompts inside the reduced window / vocab
        plens = tuple(min(p, cfg.sliding_window or p) for p in plens)
    trace = poisson_trace(args.requests, rate=args.rate, plen_choices=plens,
                          max_new_choices=tuple(int(x) for x in args.max_new.split(",")),
                          vocab_size=cfg.vocab_size, seed=args.seed,
                          burst_mult=args.burst_mult, burst_period=args.burst_period,
                          prefix_families=args.prefix_families, prefix_len=args.prefix_len)
    if cfg.vision_dim:  # VLM requests carry their vision input
        pr = np.random.RandomState(args.seed + 1)
        for q in trace:
            q.patches = pr.randn(cfg.num_patches, cfg.vision_dim).astype(np.float32)
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k, seed=args.seed)
    common = dict(device=model.device, cache_update=args.cache_update, sampler=sampler)
    try:
        if args.paged:
            loop = PagedServeLoop(model, params, n_slots=args.slots, capacity=args.capacity,
                                  page_size=args.page_size, n_pages=args.pages,
                                  prefix_cache=args.prefix_cache,
                                  prefill_chunk=args.prefill_chunk, preempt=args.preempt,
                                  preempt_after=args.preempt_after, **common)
        else:
            loop = ServeLoop(model, params, n_slots=args.slots, capacity=args.capacity,
                             **common)
        serial = SerialLoop(model, params, **common)
    except ServeUnsupportedError as e:
        print(f"repro_torch.serve: {e}", file=sys.stderr)
        return 2
    name = "paged" if args.paged else "loop"
    runs = [("serial", serial)] if args.serial else [(name, loop)]
    if args.check:
        runs.append(("serial", serial))
    streams = []
    for mode, lp in runs:
        reqs = [r.clone() for r in trace]
        stats = lp.run(reqs)
        streams.append([r.out for r in reqs])
        stats.update(arch=cfg.name, device=str(model.device), mode=mode)
        print(json.dumps(stats))
    if args.check:
        bad = [r.rid for r, a, b in zip(trace, *streams) if a != b]
        print(json.dumps({"check": "streams equal" if not bad else "streams differ",
                          "requests": len(trace), "differing_rids": bad}))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
