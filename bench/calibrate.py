"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size on the card; the benchmark's runs never run this.

    python3 bench/calibrate.py --workload qwen05-fedveca --seeds 11 12 13 \
        --controls 11 12 13

For each of ``--seeds``: the program's checked rounds (the harness's
``drive`` without a window, on one simulator built for the seed) against the plain
reference's. For each of ``--controls``: the reference in TF32 (the
control) and with each planted fault (half of the batch left out, one
target token altered) in the program's place, against the reference in
float32. One JSON line a reading on standard output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from bench import compare, data, harness, manifest, reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = manifest.cell(args.workload)
    cfg, t = cell.config, cell.traffic
    model = harness.build_model(cell, dev)

    def ref(seed, clients, test, **kw):
        return reference.run_rounds(cfg, t, seed, data.make_weights(cfg, seed, dev), clients,
                                    test, rounds=t["check_rounds"], device=dev, **kw)

    def emit(kind, seed, numbers, seconds):
        print(json.dumps(dict(cell=cell.name, kind=kind, seed=seed, seconds=seconds, **numbers)),
              flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        clients, test = data.make_tokens(cfg, t, seed)
        sim = harness.make_sim(model, cell, seed, clients, test)
        d = harness.drive(sim, data.make_weights(cfg, seed, dev), t["check_rounds"], 0, 0, dev)
        prog = harness.record(d.rows, d.caps, sim.C, d.test_last)
        del sim, d
        gc.collect()
        torch.cuda.empty_cache()
        numbers = compare.numbers(prog, ref(seed, clients, test))
        emit("program", seed, dict(numbers, taus=[r["tau_next"] for r in prog["rounds"]]),
             time.perf_counter() - t0)
    for seed in args.controls:
        clients, test = data.make_tokens(cfg, t, seed)
        base = ref(seed, clients, test)
        for kind, kw in (("control_tf32", dict(precision="tf32")),
                         ("fault_half_batch", dict(fault="half_batch")),
                         ("fault_token", dict(fault="token"))):
            t0 = time.perf_counter()
            emit(kind, seed, compare.numbers(ref(seed, clients, test, **kw), base),
                 time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
