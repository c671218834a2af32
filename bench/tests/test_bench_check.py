"""The correctness check at tiny widths on the CPU: the program (the
port's simulator through the harness) agrees with the plain reference
within each cell's limits in both modes and on the MoE, and each fault a
training cell can have, and the control (the reference in TF32), come out
not correct."""
import re
import time

import numpy as np
import pytest
import torch

from bench import compare, data, harness, reference
from bench.tests import tiny

SEED = 2**31 + 977  # past 32 signed bits, as a run's --seed may be
CELLS = ["qwen05-fedveca", "qwen05-fedavg", "granite-moe-fedveca"]


def run(name, patch=None, seed=SEED):
    return harness.run(tiny.cell(name), seed, 0.5, False, "cpu", time.perf_counter(), patch=patch)


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    out = run(name)
    assert out["result"]["correct"], out["numbers"]
    assert out["result"]["attempted"] >= 2 and out["result"]["failed"] == 0
    assert set(out["result"]["metrics"]) == {"train_samples_per_s", "setup_s", "peak_mem_gb"}
    assert list(out["result"])[-1] == "checks"


@pytest.mark.parametrize("name", ["qwen05-fedveca", "granite-moe-fedveca"])
def test_unequal_taus_in_one_cohort_agree(name):
    # the masked fixed-trip loop with a cohort's clients on different taus
    # in one vmapped step: the first two rounds' members start at 1 and 3
    # trips of tau_max 3 (the controller adapts from the second row on),
    # every other client at 2
    cell = tiny.cell(name)
    C = len(cell.traffic["client_sizes"])
    taus = np.full(C, 2)
    first, second = reference.cohorts(SEED, C, cell.traffic["cohort"], 2)
    taus[second] = [3, 1]
    taus[first] = [1, 3]
    cell.traffic = dict(cell.traffic, tau_init=taus.tolist())
    out = harness.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["result"]["correct"], out["numbers"]
    ran = [json_list(line) for line in out["lines"] if "(checked)" in line]
    assert ran[0] == [1, 3] and sum(len(set(t)) > 1 for t in ran) >= 2, ran


def json_list(line: str) -> list:
    return [int(x) for x in re.search(r"taus \[([0-9, ]*)\]", line).group(1).split(",")]


def _frozen(sim):
    engine = sim.engine
    fused = engine.run_fused

    def unchanged(params, *a, **kw):
        _, cstate, scaffold, diag = fused(params, *a, **kw)
        return params, cstate, scaffold, diag

    engine.run_fused = unchanged


def _half_batch(sim):
    model = sim.model
    half = lambda p, batch, **kw: model.loss(  # noqa: E731
        p, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, **kw)
    sim.engine.__init__(half, sim.engine.cfg, shards=sim.engine.shards,
                        num_clients=sim.engine.num_clients, controller=sim.engine.controller)


def _token(sim):
    shards = sim.engine.shards
    sample = shards.sample

    def altered(*a, **kw):
        b = sample(*a, **kw)
        t = b["targets"].clone()
        t[..., 0, 0, -1] = (t[..., 0, 0, -1] + 1) % 256
        return dict(b, targets=t)

    shards.sample = altered


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _token], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(name, fault):
    out = run(name, patch=fault)
    assert not out["result"]["correct"], out["numbers"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_is_not_correct(name):
    cell = tiny.cell(name)
    clients, test = data.make_tokens(cell.config, cell.traffic, SEED)
    recs = {p: reference.run_rounds(cell.config, cell.traffic, SEED,
                                    data.make_weights(cell.config, SEED, "cpu"), clients, test,
                                    rounds=cell.traffic["check_rounds"], device="cpu",
                                    precision=p) for p in ("fp32", "tf32")}
    numbers = compare.numbers(recs["tf32"], recs["fp32"])
    assert not compare.judge(numbers, cell.limits), numbers


def test_tf32_emulation_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.0], dtype=torch.float32)
    assert reference._tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]


def test_reference_draws_what_the_simulator_draws():
    from repro_torch.data.device import DeviceShards, round_key
    from repro_torch.data.synthetic import Dataset

    sets = [Dataset(x=torch.arange(n * 3).reshape(n, 3).numpy(), y=torch.zeros(n).numpy())
            for n in (5, 9, 7)]
    shards = DeviceShards.from_datasets(sets, device="cpu")
    got = shards.sample(round_key(SEED, 4), 2, 3, [1, 2])["tokens"]
    for j, i in enumerate((1, 2)):
        rows = reference.minibatch_rows(SEED, 4, i, len(sets[i]), 2, 3, "cpu")
        assert torch.equal(got[j], torch.as_tensor(sets[i].x)[rows][..., :-1].int())
