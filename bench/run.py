"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload qwen05-fedveca --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cell's cards. The
result is the last line of standard output (one JSON object); the numbers
the correctness check compared, each beside its limit, are the last lines
of standard error. Exits non-zero without a result when no card (or too
few) is present, or when the process holds JAX, flax or the JAX package
(``repro``) or ``benchmarks`` once the window has closed.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                   ("TRITON_CACHE_DIR", "build/triton"), ("CUDA_CACHE_PATH", "build/cuda_cache")):
    os.environ[_var] = str(ROOT / _sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "1")  # one dispatching thread, no idle spinners
sys.path[0] = str(ROOT)  # the package ``bench``, not this script's folder
sys.path.insert(1, str(ROOT / "src"))

BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _card_lines(torch) -> list:
    lines = [f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
             f"python {sys.version.split()[0]}"]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        lines.append(f"[card] {smi.stdout.strip() or smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        lines.append(f"[card] nvidia-smi unavailable: {e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    lines = _card_lines(torch)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      _T0)
    held = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if held:
        print(f"bench: the process holds {held} after the window", file=sys.stderr)
        return 4
    result = out["result"]
    for line in lines + out["lines"]:
        print(line, file=sys.stderr)
    for k, v in result["checks"].items():
        limit = "not compared" if v["limit"] is None else f"limit {v['limit']!r}"
        print(f"[check] {k} {out['numbers'][k]!r} {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
