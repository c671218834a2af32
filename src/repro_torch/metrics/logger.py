"""Run metrics: in-memory history + JSONL/CSV emission (a copy of
``repro/metrics/logger.py``)."""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _scalarize(v):
    if isinstance(v, (np.ndarray, list, tuple)):
        return np.asarray(v).tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v


def percentile(values, q: float) -> float:
    """Seedless linear-interpolation percentile (q in [0, 100]); NaN on
    an empty sample so SLO reports never crash on a zero-request bucket."""
    arr = np.asarray(list(values), np.float64).reshape(-1)
    if arr.size == 0:
        return float("nan")
    return float(np.percentile(arr, q))


def format_bytes(n) -> str:
    """Human-readable byte count for wire-cost reporting (``wire_bytes``
    rows from TrainDriver / BufferedRoundEngine / FedVecaServer):
    1536 -> '1.5KiB'. Exact integer below 1KiB."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{int(n)}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TiB"  # unreachable; keeps the return type obvious


def latency_summary(values, prefix: str = "") -> Dict[str, float]:
    """p50/p95/p99/mean/n over a latency sample, keys prefixed — the
    shape benchmarks/serve_slo.py emits per variant (ttft_p99, itl_p50,
    ...). Deterministic: pure order statistics, no sampling."""
    arr = np.asarray(list(values), np.float64).reshape(-1)
    n = int(arr.size)
    return {
        f"{prefix}p50": percentile(arr, 50),
        f"{prefix}p95": percentile(arr, 95),
        f"{prefix}p99": percentile(arr, 99),
        f"{prefix}mean": float(arr.mean()) if n else float("nan"),
        f"{prefix}n": n,
    }


class RunLogger:
    def __init__(self, path: Optional[str] = None, name: str = "run"):
        self.rows: List[Dict[str, Any]] = []
        self.path = path
        self.name = name
        if path:
            os.makedirs(path, exist_ok=True)
            self._f = open(os.path.join(path, f"{name}.jsonl"), "w")
        else:
            self._f = None

    def log(self, **row):
        row = {k: _scalarize(v) for k, v in row.items()}
        self.rows.append(row)
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def column(self, key, default=np.nan):
        return np.array([r.get(key, default) for r in self.rows])

    def to_csv(self, path: str, keys: Optional[List[str]] = None):
        if not self.rows:
            return
        keys = keys or sorted({k for r in self.rows for k in r})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            for r in self.rows:
                w.writerow({k: r.get(k) for k in keys})

    def close(self):
        if self._f:
            self._f.close()
