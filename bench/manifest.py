"""``BENCHMARK.json`` and the files a cell names, found by name.

A cell of ``workloads`` names a configuration (``configs/<config>.json``,
its ``file`` in ``configs``), a traffic mix (``workloads/<traffic>.json``)
and its limits (``limits/<cell>.json``); a per-layer metric is the reader
``metrics/<metric>.py`` (a ``read(ctx)`` returning a number, or None where
the run gave it nothing to read). Adding a cell, a configuration or a
metric is adding files and entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1
    readers: Dict[str, Callable]


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, workload: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; or, with ``workload`` (an
    entry in the form of ``workloads``), a cell of the benchmark's files
    that ``BENCHMARK.json`` does not hold, its configuration found as
    ``configs/<config>.json``."""
    m = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if workload is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = workload or cells[name]
    files = {c["name"]: c["file"] for c in m["configs"]}
    per_layer = [x for x in m["per_layer"] if _reports(x, name)]
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(root / files.get(w["config"], f"bench/configs/{w['config']}.json")),
        traffic=load_json(BENCH / "workloads" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[x for x in m["end_to_end"] if _reports(x, name)],
        per_layer=per_layer,
        readers={x["name"]: reader(x["name"]) for x in per_layer})
