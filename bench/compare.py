"""The comparison that decides ``correct``: the program's record of the
checked rounds against the plain reference's (``reference.run_rounds``),
each number held to its limit (``limits/<cell>.json``).

The numbers, each a worst case over the checked rounds:

* ``loss_gap``: |train loss - reference| / |reference| a round (the
  cohort-weighted step-0 loss); ``loss0_gap`` the same of the first round
  alone, where both sides start from the same weights;
* ``test_loss_gap``: the same for the evaluation's test loss;
* ``stats_gap``: the Assumption-3/4 statistics beta and delta of every
  cohort member, relative to the reference's;
* ``tau_mismatch``: the controller's next taus (and the cohorts) that
  differ from the reference's, counted; exact;
* ``update1_gap``: after the first round, by the worst leaf,
  | ||w_1 - w_0|| - reference's | over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_gap``: the same for ||w_R - w_0|| after the last checked round,
  leaving out the leaves whose first update the reference puts under a
  thousandth of the median leaf's (a key bias under softmax moves by
  rounding alone.

A cell's limits file names the numbers it holds to a limit; the others
are reported beside them, not compared.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

NUMBERS = ("loss_gap", "loss0_gap", "test_loss_gap", "stats_gap", "tau_mismatch", "update1_gap",
           "change_gap")
NOUGHT = 1e-3  # a leaf whose first update is under this share of the median leaf's


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The worst leaf of ``keys``: | ||prog leaf|| - ||ref leaf|| | over the
    larger of the reference's norm of the leaf and of the median leaf."""
    floor = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) if math.isfinite(prog[k])
               else math.inf for k in keys)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two records (``reference.run_rounds``'s
    form)."""
    loss = test = stats = 0.0
    taus = 0
    for p, r in zip(prog["rounds"], ref["rounds"], strict=True):
        loss = max(loss, _rel(p["train_loss"], r["train_loss"]))
        if "test_loss" in r:
            test = max(test, _rel(p.get("test_loss", math.nan), r["test_loss"]))
        for name in ("beta", "delta"):
            for a, b in zip(p[name], r[name], strict=True):
                stats = max(stats, _rel(a, b))
        taus += int(p["cohort"] != r["cohort"])
        taus += sum(int(a != b) for a, b in zip(p["tau_next"], r["tau_next"], strict=True))
    floor = float(np.median(list(ref["d1"].values())))
    moved = [k for k, v in ref["d1"].items() if v >= NOUGHT * floor]
    loss0 = _rel(prog["rounds"][0]["train_loss"], ref["rounds"][0]["train_loss"])
    return dict(loss_gap=loss, loss0_gap=loss0, test_loss_gap=test, stats_gap=stats,
                tau_mismatch=float(taus), update1_gap=leaf_gap(prog["d1"], ref["d1"], ref["d1"]),
                change_gap=leaf_gap(prog["dR"], ref["dR"], moved))


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limit for k, limit in limits.items())
