"""The optimisation driver (port of ``repro/launch/perf.py``): the dry
run's records (``launch/dryrun.py``) re-measured under candidate options,
config overrides (``num_experts_pad``) and the step bundles' keywords
(``fed_batch_rules``, ``stat_dtype``, ``remat``, ``cache_update``,
``kv_seq_shard``), each beside its baseline in ``experiments/dryrun_torch/``
with the difference (``delta``) and the hypothesis it tests.

Each hypothesis is a prediction in the port's terms, written before the
numbers: FLOPs, collectives and bytes a rank on the (data 16, model 16)
mesh. Where ROADMAP.md P12 says a keyword is moot in the port
(``fed_batch_rules``: activations are laid out by construction;
``kv_seq_shard``: no length-sharded cache is built), and where a keyword
names the bundle's default, the record must equal the one without it
(``equals``, checked: ``matches_reference``).

    python -m repro_torch.launch.perf [--pair qwen2-moe-a2.7b__train_4k]

One JSON a (pair, variant) under ``--out`` (default
``experiments/dryrun_opt_torch/``); a baseline the ``--baseline-dir``
lacks is run first and written there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun as dr

# pair -> [(variant, config overrides, bundle keywords, the record it must
# equal (None: none), hypothesis)]
VARIANTS = {
    "qwen2-moe-a2.7b__train_4k": [
        ("expert_pad64", dict(num_experts_pad=4), {}, None,
         "60 experts do not divide the 16-way model axis, so the port's layout "
         "cuts each expert on its hidden dim (moe_d_ff 1408 / 16); 4 never-routed "
         "pad experts make 64 and the layout puts 4 whole experts on a rank. Both "
         "layouts spread the expert products evenly and complete them with one "
         "all-reduce a layer, so expect the collectives' count and bytes "
         "unchanged, FLOPs a rank within a few percent (the capacity slots a "
         "rank computes are T k cf / 16 either way), and parameter bytes a rank "
         "up by the pad experts' share."),
        ("expert_pad64+fedrules", dict(num_experts_pad=4),
         dict(fed_batch_rules="client_exclusive"), "expert_pad64",
         "fed_batch_rules is moot in the port (P12: activations are laid out by "
         "construction) and client_exclusive is the round bundle's default: "
         "expect the expert_pad64 record exactly."),
        ("expert_pad64+fedrules+bf16stats", dict(num_experts_pad=4),
         dict(fed_batch_rules="client_exclusive", stat_dtype=torch.bfloat16), None,
         "The g0/cum_g accumulators in bf16: the vecavg reduce then writes a bf16 "
         "delta, so the model-sized all-reduce over the client group moves half "
         "its float32 bytes; FLOPs and the collectives' count unchanged."),
    ],
    "granite-moe-1b-a400m__train_4k": [
        ("fedrules", {}, dict(fed_batch_rules="client_exclusive"), "baseline",
         "fed_batch_rules is moot in the port (P12) and client_exclusive is the "
         "round bundle's default: expect the baseline record exactly."),
    ],
    "qwen1.5-32b__decode_32k": [
        ("mask_cache_update", {}, dict(cache_update="mask"), "baseline",
         "The port's decode bundle already writes the cache with the mask "
         "update (its default), and each rank holds whole kv heads of its rows: "
         "expect the baseline record exactly."),
        ("kv_seq_shard", {}, dict(kv_seq_shard=True), "baseline",
         "kv_seq_shard is moot in the port (P12: the cache length is never "
         "sharded; Qwen1.5-32B's 40 heads do not divide 16, so attention and "
         "its cache stay whole on every model rank): expect the baseline record "
         "exactly."),
        ("kv_seq_shard+mask", {}, dict(kv_seq_shard=True, cache_update="mask"), "baseline",
         "Both keywords are the port's defaults or moot: expect the baseline "
         "record exactly."),
    ],
    "starcoder2-3b__train_4k": [
        ("fedrules", {}, dict(fed_batch_rules="client_exclusive"), "baseline",
         "fed_batch_rules is moot in the port (P12) and client_exclusive is the "
         "round bundle's default: expect the baseline record exactly."),
        ("bf16stats", {}, dict(stat_dtype=torch.bfloat16), None,
         "bf16 g0/cum_g accumulators: the vecavg reduce writes a bf16 delta, so "
         "the model-sized all-reduce over the client group halves its bytes; "
         "FLOPs and counts unchanged."),
        ("fedrules+bf16stats", {}, dict(fed_batch_rules="client_exclusive",
                                        stat_dtype=torch.bfloat16), "bf16stats",
         "fed_batch_rules is moot: expect the bf16stats record exactly."),
        ("fedrules+remat_dots", {}, dict(fed_batch_rules="client_exclusive", remat="dots"),
         None,
         "remat='dots' keeps each block's weight products, so the backward "
         "recomputes no matrix product: expect FLOPs a rank down by about a "
         "quarter (one forward's products of the four a gradient call costs "
         "under full recompute), and the row-parallel all-reduces that the "
         "recompute repeats gone from the count."),
    ],
}

# the fields a moot variant must reproduce
MEASURED = ("flops_per_rank", "flops_per_rank_raw", "collectives_per_rank",
            "param_bytes_per_rank", "input_bytes_per_rank", "kernel_launches_per_rank")


def _delta(rec: dict, base: dict) -> dict:
    def diff(a, b):
        return dict(change=a - b, ratio=(a / b) if b else None)

    rc, bc = rec["collectives_per_rank"]["total"], base["collectives_per_rank"]["total"]
    out = dict(flops_per_rank=diff(rec["flops_per_rank"], base["flops_per_rank"]),
               collective_count=diff(rc["count"], bc["count"]),
               collective_bytes=diff(rc["bytes"], bc["bytes"]),
               param_bytes_per_rank=diff(rec["param_bytes_per_rank"]["total"],
                                         base["param_bytes_per_rank"]["total"]),
               input_bytes_per_rank=diff(rec["input_bytes_per_rank"],
                                         base["input_bytes_per_rank"]))
    for k in ("compute_s", "memory_s", "collective_s"):
        out[k] = diff(rec["roofline"][k], base["roofline"][k])
    return out


def same_measurement(a: dict, b: dict) -> bool:
    return all(a.get(k) == b.get(k) for k in MEASURED)


def baseline(pair: str, base_dir: str, tau_max: int = 2) -> dict:
    """The pair's dry-run record on (data 16, model 16), run and written to
    ``base_dir`` when it is not there."""
    arch, shape_name = pair.split("__")
    return dr.run_one(arch, shape_name, out_dir=base_dir, tau_max=tau_max)


def run_variant(pair: str, name: str, cfg_over: dict, bkw: dict, hypothesis: str,
                out_dir: str, base: dict, equals: str | None = None,
                reference: dict | None = None, *, tau_max: int = 2,
                force: bool = False) -> dict:
    """One variant's record: the dry run's under the variant, its ``delta``
    against ``base`` and, where the variant must equal the record named
    ``equals`` (``reference``), whether it does."""
    arch, shape_name = pair.split("__")
    path = os.path.join(out_dir, f"{pair}__{name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_arch(arch)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    shape = get_shape(shape_name)
    rec = dict(arch=arch, shape=shape_name, mesh="pod16x16", variant=name,
               hypothesis=hypothesis, config_overrides=cfg_over,
               bundle_kwargs={k: str(v) for k, v in bkw.items()})
    t0 = time.perf_counter()
    try:
        rec.update(status="OK", **dr.measure_record(cfg, shape, "pod16x16", tau_max=tau_max,
                                                    extra=bkw))
        rec["delta"] = _delta(rec, base) if base.get("status") == "OK" else None
        if equals is not None:
            rec["equals"] = equals
            rec["matches_reference"] = reference is not None and \
                same_measurement(rec, reference)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec.update(status="FAIL", **dr._failure(e))
    rec.setdefault("seconds", time.perf_counter() - t0)
    dr._write(path, rec)
    return rec


def run_pair(pair: str, out_dir: str, base_dir: str, *, force: bool = False) -> list:
    base = baseline(pair, base_dir)
    done, out = {"baseline": base}, []
    for name, cfg_over, bkw, equals, hyp in VARIANTS[pair]:
        rec = run_variant(pair, name, cfg_over, bkw, hyp, out_dir, base, equals,
                          done.get(equals), force=force)
        done[name] = rec
        out.append(rec)
    return out


def _line(pair: str, rec: dict) -> str:
    if rec["status"] != "OK":
        return f"{pair} {rec.get('variant', 'BASELINE')}: {rec['status']} {rec.get('error', '')}"
    r, c = rec["roofline"], rec["collectives_per_rank"]["total"]
    tail = ""
    if "matches_reference" in rec:
        tail = f" equals {rec.get('equals')}: {rec['matches_reference']}"
    return (f"{pair} {rec.get('variant', 'BASELINE')}: flops={rec['flops_per_rank']:.4e} "
            f"coll={c['count']}x/{c['bytes']:.4e}B compute={r['compute_s']:.3e}s "
            f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
            f"bottleneck={rec['bottleneck']} ({rec['seconds']:.1f}s){tail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--pair", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--out", default="experiments/dryrun_opt_torch")
    ap.add_argument("--baseline-dir", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    bad = 0
    for pair in ([args.pair] if args.pair else list(VARIANTS)):
        print(_line(pair, baseline(pair, args.baseline_dir)), flush=True)
        for rec in run_pair(pair, args.out, args.baseline_dir, force=args.force):
            print(_line(pair, rec), flush=True)
            bad += rec["status"] != "OK" or rec.get("matches_reference") is False
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
