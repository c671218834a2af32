"""Serve a Poisson request trace through ``PagedServeLoop``.

    python -m repro_torch.serve --arch starcoder2-3b --paged
    python -m repro_torch.serve --device cpu --reduced --requests 4
    python -m repro_torch.serve --device cpu --reduced --arch qwen1.5-32b \
        --prefix-cache --prefill-chunk 16 --preempt --temperature 0.7 --top-k 8

By default the full configuration runs on the card, in its own dtype, with
random weights from ``--seed``; ``--device cpu --reduced`` is the CPU-sized
run. ``--prefix-cache``, ``--prefill-chunk`` and ``--preempt`` turn on the
scheduler options, ``--temperature`` / ``--top-k`` sampled decode, and
``--prefix-families`` / ``--prefix-len`` / ``--burst-mult`` give the trace
shared prompt prefixes and bursts of arrivals. Prints one stats line per
run as JSON.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.models.model import build_model_by_name
from repro_torch.serve import PagedServeLoop, SamplerConfig, poisson_trace


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--paged", action="store_true",
                    help="no effect: accepted so the JAX example's command line "
                    "runs unchanged; the paged loop is the only one ported")
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
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k, seed=args.seed)
    loop = PagedServeLoop(model, params, device=model.device, n_slots=args.slots,
                          capacity=args.capacity, page_size=args.page_size,
                          n_pages=args.pages, cache_update=args.cache_update,
                          sampler=sampler, prefix_cache=args.prefix_cache,
                          prefill_chunk=args.prefill_chunk, preempt=args.preempt,
                          preempt_after=args.preempt_after)
    stats = loop.run(trace)
    stats.update(arch=cfg.name, device=str(model.device))
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
