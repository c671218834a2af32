"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), then the comparison with the plain reference.

Set-up builds ONE federated simulator (``repro_torch.fed.simulator``) from
the benchmark's own weights and data and warms it up with two rounds of
``FederatedSimulator.run``, the window's own call, the second of them
timed. Then ONE ``sim.run`` from the same weights drives, in order, the
cell's checked rounds (their record, read through the driver's row hook
and around the round engine, is what the reference is compared with), the
measured window, a whole number of rounds about ``--seconds`` long, and,
with ``--trace 1``, a profiled stretch of whole rounds. The window
continues the training of the checked rounds: the controller's state, the
cohort RNG and the evaluation schedule carry on into it. Only after that,
with the program's state freed, the reference redoes the checked rounds
from the same inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bench import compare, data, devtrace, flops, reference
from bench.manifest import ROOT, Cell

OUT = ROOT / ".bench_out"  # chrome traces of --trace 1 runs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_model(cell: Cell, device):
    """The port's model of the cell's configuration, its parameter layout
    checked against the benchmark's own."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model as port_build, params_struct

    port = cell.config["port"]
    arch = dataclasses.replace(get_arch(port["registry"]), **port["fields"])
    model = port_build(arch, device=device)
    theirs = {k: tuple(v.shape) for k, v in params_struct(model).items()}
    ours = {k: shape for k, (shape, _) in data.weight_layout(cell.config).items()}
    if theirs != ours:
        raise RuntimeError(f"the port lays out {cell.config['port']['registry']}'s parameters as "
                           f"{theirs}, the benchmark as {ours}")
    return model


def make_sim(model, cell: Cell, seed: int, clients, test):
    """The federated simulator of the cell's traffic on the benchmark's
    client and test sequences."""
    from repro_torch.data.synthetic import Dataset
    from repro_torch.fed.simulator import FederatedSimulator, FedSimConfig

    t = cell.traffic
    C = len(clients)
    cfg = FedSimConfig(
        mode=t["mode"], eta=t["eta"], alpha=t["alpha"], tau_max=t["tau_max"],
        tau_init=t["tau_init"], batch_size=t["batch"], rounds=t["check_rounds"], seed=seed,
        fixed_tau=None if t["mode"] == "fedveca" else np.full(C, t["tau_max"], np.int32),
        eval_every=t["eval_every"], cohort_size=t["cohort"], stats_decay=t["stats_decay"],
        overlap=t["overlap"], data_path="device", aggregator="auto")
    sets = [Dataset(x=c, y=np.full(len(c), i, np.int32)) for i, c in enumerate(clients)]
    return FederatedSimulator(model, sets, cfg, Dataset(x=test, y=np.full(len(test), -1, np.int32)))


@contextlib.contextmanager
def _around_rounds(engine, wrap: Callable):
    """The round engine's ``run_fused`` replaced by ``wrap(run_fused)``
    while the block runs."""
    own = "run_fused" in vars(engine)  # patched on the instance (a test's fault)
    fused = engine.run_fused
    engine.run_fused = wrap(fused)
    try:
        yield
    finally:
        if own:
            engine.run_fused = fused
        else:
            del engine.run_fused


def warm_up(sim, w0, device) -> float:
    """Two rounds from ``w0`` through the window's own call: the first
    builds and warms every kernel and shape (the evaluation's too: the
    last round of a run evaluates), the second is timed alone, from a sync
    before its dispatch to a sync after it -> seconds of one round."""
    seconds = []

    def wrap(fused):
        def run_fused(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            res = fused(*a, **kw)
            _sync(device)
            seconds.append(time.perf_counter() - t0)
            return res
        return run_fused

    with _around_rounds(sim.engine, wrap):
        sim.run(params=w0, rounds=2)
        _sync(device)
    return seconds[1]


def profile_start(first: int, n: int, every: int) -> int:
    """The first round from ``first`` on that starts ``n`` rounds none of
    which evaluates."""
    k = first
    while any(j % every == 0 for j in range(k, k + n)):
        k += 1
    return k


def drive(sim, w0, check: int, window: int, profile: int, device, prof=None) -> SimpleNamespace:
    """ONE ``sim.run`` from ``w0``: ``check`` checked rounds, then
    ``window`` measured rounds, then (with ``profile``) ``profile`` rounds
    none of which evaluates under the profiler ``prof``, then one last
    round, so that no stretch holds the run's closing evaluation.

    The driver calls ``on_row`` with row k after it has dispatched round
    k + 1, so a stretch of rounds [a, b) is marked at rows a - 2 and b - 2,
    each mark after a sync: it holds the dispatch and all the device work
    of those rounds, and the readbacks of rows a - 1 .. b - 2. The window's
    marks reset and read the peak of device memory, the kernels' launch
    counters and the driver's host counters. The round engine is wrapped to
    read ||w - w0|| a leaf after the first and the last checked round, and
    the test loss after the last where the schedule does not evaluate it.

    -> ``rows`` (all the run's), ``caps`` and ``test_last`` (for
    ``record``), ``window`` (its marks' readings), ``bounds`` (the rounds
    where each stretch starts and ends)."""
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.vecavg import ops as va_ops

    if check < 2:
        raise ValueError(f"the window is marked at row check - 2: check_rounds {check} < 2")
    cuda = torch.device(device).type == "cuda"
    driver, engine = sim.driver, sim.engine
    every = driver.eval_every
    W0, W1 = check, check + window
    P0 = profile_start(W1, profile, every) if profile else W1
    total = P0 + profile + 1 if profile else (W1 + 1 if window else W1)
    out = SimpleNamespace(caps=[], test_last=None, window={}, profiling=False,
                          bounds=dict(W0=W0, W1=W1, P0=P0, P1=P0 + profile, total=total))

    def counters():
        return dict(t=time.perf_counter(), host_blocked_s=driver.host_blocked_s,
                    dispatch_s=driver.dispatch_s)

    def window_start():
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        va_ops.reset_launches()
        rn_ops.reset_launches()
        out.window["start"] = counters()

    def window_end():
        out.window.update(end=counters(), launches=dict(va_ops.launches, **rn_ops.launches),
                          peak=torch.cuda.max_memory_allocated(device) if cuda else 0)

    def prof_start():
        prof.start()
        out.profiling = True

    def prof_stop():
        prof.stop()
        out.profiling = False

    marks: Dict[int, list] = {}
    if window:
        marks.setdefault(W0 - 2, []).append(window_start)
        marks.setdefault(W1 - 2, []).append(window_end)
    if profile:
        marks.setdefault(P0 - 2, []).append(prof_start)
        marks.setdefault(P0 + profile - 2, []).append(prof_stop)

    def on_row(row):
        hooks = marks.get(row["round"], ())
        if hooks:
            _sync(device)
        for hook in hooks:
            hook()

    held = {"w0": w0}
    calls = [0]

    def wrap(fused):
        def run_fused(params, *a, **kw):
            res = fused(params, *a, **kw)
            k = calls[0]
            calls[0] += 1
            if k in (0, W0 - 1):
                out.caps.append(reference.leaf_norms(res[0], held["w0"]))
            if k == W0 - 1:
                held["w0"] = None
                if k % every and k != total - 1:
                    out.test_last = float(driver.eval_fn(res[0])["test_loss"])
            return res
        return run_fused

    driver.on_row = on_row
    try:
        with _around_rounds(engine, wrap):
            log = sim.run(params=w0, rounds=total)
            _sync(device)
    finally:
        driver.on_row = None
        if out.profiling:
            prof.stop()
    out.rows = log.rows
    return out


def record(rows, caps, C: int, test_last: Optional[float] = None) -> dict:
    """The program's record of the checked rounds, in the reference's form."""
    out = []
    for r in rows:
        members = list(range(C)) if r["cohort"] is None else [int(i) for i in r["cohort"]]
        row = dict(train_loss=float(r["train_loss"]), cohort=members,
                   tau_next=[int(x) for x in r["tau"]],
                   beta=[float(r["beta"][i]) for i in members],
                   delta=[float(r["delta"][i]) for i in members])
        if "test_loss" in r:
            row["test_loss"] = float(r["test_loss"])
        out.append(row)
    if test_last is not None:
        out[-1]["test_loss"] = test_last
    return dict(rounds=out, d1=caps[0], dR=caps[-1])


def executed_taus(rows, taus0, C: int):
    """(round, cohort, the taus its members ran) a row: a round runs the
    taus that the row before it predicted."""
    taus = np.asarray(taus0)
    for r in rows:
        members = list(range(C)) if r["cohort"] is None else [int(i) for i in r["cohort"]]
        yield r["round"], members, [int(taus[i]) for i in members]
        taus = np.asarray(r["tau"])


def _finite(v: float) -> Optional[float]:
    return v if math.isfinite(v) else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        patch: Optional[Callable] = None) -> dict:
    """One run of ``cell`` -> dict(result (the line's keys), lines (for
    standard error), numbers (compared), program and reference (their
    records)). ``patch(sim)``, for tests, breaks the program underneath
    after it is built."""
    from torch.profiler import ProfilerActivity, profile

    cfg, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    model = build_model(cell, device)
    w0 = data.make_weights(cfg, seed, device)
    clients, test = data.make_tokens(cfg, t, seed)
    sim = make_sim(model, cell, seed, clients, test)
    if patch is not None:
        patch(sim)
    round_s = warm_up(sim, w0, device)
    window = max(2, int(round(seconds / max(round_s, 1e-6))))
    n_prof = t["profile_rounds"] if trace else 0
    # the device's activity and the CUDA runtime calls that issued it; aten
    # ops are not recorded (their recording slows the dispatch). On the CPU
    # (tests) the host's ops, and no device activity.
    prof = (profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            if trace else None)
    gc.collect()
    d = drive(sim, w0, t["check_rounds"], window, n_prof, device, prof)
    del w0
    rows, b, win = d.rows, d.bounds, d.window
    rec = record(rows[:b["W0"]], d.caps, sim.C, d.test_last)

    # ---- the measured window: rounds [W0, W1) ----------------------------
    window_s = win["end"]["t"] - win["start"]["t"]
    setup_s = win["start"]["t"] - t_start
    peak = win["peak"]
    in_window = rows[b["W0"]:b["W1"]]
    steps = int(rows[b["W1"] - 1]["tau_all"] - rows[b["W0"] - 1]["tau_all"])
    ctx = SimpleNamespace(
        window_s=window_s, rounds=window,
        host_blocked_s=win["end"]["host_blocked_s"] - win["start"]["host_blocked_s"],
        dispatch_s=win["end"]["dispatch_s"] - win["start"]["dispatch_s"],
        active_steps=steps, config=cfg, traffic=t, params=flops.param_count(cfg), trace=None,
        peaks=flops.peaks(torch.cuda.get_device_name(device)) if cuda else None)
    evals = sum("test_loss" in r for r in in_window)
    useful = flops.window_flops(cfg, t["seq"], steps * t["batch"], evals * t["test_seqs"])
    e2e = dict(train_samples_per_s=steps * t["batch"] / window_s, setup_s=setup_s,
               peak_mem_gb=peak / 1e9)
    if ctx.peaks is not None:
        e2e["mfu"] = 100.0 * useful / window_s / ctx.peaks["fp32_flops_per_s"]
    lines = [f"[window] rounds {b['W0']}..{b['W1'] - 1} ({window}) in {window_s:.3f} s "
             f"({round_s:.3f} s a round at warm-up), {steps} client steps, {evals} evaluations, "
             f"launches {win['launches']}"]
    mixed = 0  # checked rounds whose cohort ran unequal taus
    for k, members, taus in executed_taus(rows, sim.init_taus(), sim.C):
        mixed += k < b["W0"] and len(set(taus)) > 1
        where = ("checked" if k < b["W0"] else "window" if k < b["W1"]
                 else "profiled" if b["P0"] <= k < b["P1"] else "outside")
        lines.append(f"[taus] round {k} ({where}): cohort {members} taus {taus}")

    # ---- the traced stretch: rounds [P0, P1) ------------------------------
    device_info = {}
    breakdown = None
    if trace:
        path = OUT / f"{cell.name}-{seed}.trace.json"
        n_steps = int(rows[b["P1"] - 1]["tau_all"] - rows[b["P0"] - 1]["tau_all"])
        tr = devtrace.collect(prof, n_prof, n_steps, path if cuda else None)
        ctx.trace = tr
        device_info = dict(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
        lines.append(f"[trace] rounds {b['P0']}..{b['P1'] - 1}, {len(tr.device)} device "
                     f"activities, {len(tr.host)} host calls, busy {tr.busy_s:.4f} of "
                     f"{tr.window_s:.4f} s, chrome trace {path if cuda else None} "
                     f"({tr.export_s:.1f} s to write)")
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=float(e2e[m["name"]]), unit=m["unit"])
    failed = sum(not math.isfinite(r["train_loss"]) for r in in_window)

    # ---- the comparison, with the program's state freed ------------------
    del sim, d, rows, in_window, model, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = reference.run_rounds(cfg, t, seed, data.make_weights(cfg, seed, device), clients, test,
                               rounds=t["check_rounds"], device=device)
    numbers = compare.numbers(rec, ref)
    lines.append(f"[reference] {t['check_rounds']} rounds in {time.perf_counter() - t1:.1f} s, "
                 f"{mixed} of them with unequal taus in the cohort; next taus program "
                 f"{[r['tau_next'] for r in rec['rounds']]} reference "
                 f"{[r['tau_next'] for r in ref['rounds']]}")
    correct = compare.judge(numbers, cell.limits)
    result = dict(correct=correct, attempted=window, failed=failed, metrics=metrics,
                  device=dict(platform="gpu" if cuda else "cpu",
                              kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                              count=1, memory_peak_bytes=int(peak), **device_info))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: dict(value=_finite(numbers[k]), limit=cell.limits.get(k))
                        for k in compare.NUMBERS}
    return dict(result=result, lines=lines, numbers=numbers, program=rec, reference=ref)
