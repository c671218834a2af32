"""The port's client-axis sharded round on 8 gloo ranks (CPU), against the
JAX package's sharded round and against the port's own unsharded round.

Setting: tests/test_sharded_round.py's (``tests/_sharded_setup.py``):
svm-mnist, C 16, tau_max 4, batch 16, tau [4, 2, 3, 1] x 4, eta 0.05, 8
client-axis shards of 2 clients; both packages start from the params
``_sharded_setup.init_params()`` makes with numpy.

How it runs: the JAX package runs in ONE subprocess for the module
(``tests/_jax_sharded_ref.py`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its Pallas reduce
in interpret mode, host batches), writing an npz; the port's ranks run in
ONE spawned gloo world for the module (``tests/_torch_sharded_ranks.py``,
a ``file://`` rendezvous), and the same scenarios run unsharded in this
process. The JAX run and the port's world overlap in time.

Bars:
  * port sharded against port unsharded: tests/test_sharded_round.py's
    (params atol 1e-6 a round, atol 2e-5 / rtol 1e-4 over 6 rounds;
    loss0, beta, delta, g0_sqnorm rtol 1e-5 / atol 1e-6; tau_k rtol 1e-6;
    tau traces exact); minibatches of the device data path bitwise;
    every rank's model-sized outputs bitwise equal (the all-reduce gives
    each rank the same bits);
  * port sharded against JAX sharded: params atol 1e-6 a round and 2e-5 /
    1e-4 over 6 rounds, tau traces exact, tau_k rtol 1e-6, the Eq. 8
    global gradient atol 1e-6; the statistics at the cross-framework bars
    of tests/test_torch_fed_round.py (loss0 rtol 1e-5, g0_sqnorm rtol
    1e-4, beta/delta rtol 1e-3 atol 1e-5; SCAFFOLD's c and c_i atol 1e-5
    rtol 1e-4), which the unsharded port holds against the unsharded JAX
    round: the frameworks' float32 gradients differ in their last bits.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import _sharded_setup as S
import _torch_sharded_ranks as R
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.launch.mesh import CLIENT_AXES, FederatedMesh, spawn
from repro_torch.launch.train import main as train_main

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ONE = dict(atol=1e-6, rtol=0)  # params, one round
SIX = dict(atol=2e-5, rtol=1e-4)  # params, six rounds
STAT = dict(rtol=1e-5, atol=1e-6)  # per-client statistics, port sharded vs unsharded
X_STAT = {"loss0": dict(rtol=1e-5, atol=1e-6), "g0_sqnorm": dict(rtol=1e-4, atol=0),
          "beta": dict(rtol=1e-3, atol=1e-5), "delta": dict(rtol=1e-3, atol=1e-5)}
X_SCAF = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    npz = tmp / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    jax_run = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_sharded_ref.py"),
                                str(npz)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        init = S.init_params()
        ranks = spawn(R.rank_main, S.K, "gloo", init, timeout_s=400)
        ref = R.unsharded(init)
        out, _ = jax_run.communicate(timeout=400)
        assert jax_run.returncode == 0, out
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    with np.load(npz) as z:
        jax = dict(z)
    return dict(ranks=ranks, ref=ref, jax=jax)


def _cat(ranks, get):
    return np.concatenate([get(o) for o in ranks])


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for o in ranks[1:]:
        for k, v in get(o).items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"rank {o['rank']} {k}")


def _close_tree(a, b, **tol):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), err_msg=k, **tol)


def _jtree(jax, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in jax.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("agg", S.AGGS)
@pytest.mark.parametrize("mode", S.MODES)
def test_sharded_round_matches_jax_and_unsharded(runs, mode, agg):
    """One round (host batches) of every mode with both aggregators."""
    key, ranks, jax = f"{mode}/{agg}", runs["ranks"], runs["jax"]
    mine, ref = ranks[0]["one"][key], runs["ref"]["one"][key]
    _same_on_every_rank(ranks, lambda o: o["one"][key]["params"])
    _same_on_every_rank(ranks, lambda o: o["one"][key]["global_grad"])
    j = f"round/{key}"
    _close_tree(mine["params"], _jtree(jax, f"{j}/params"), **ONE)
    _close_tree(mine["params"], ref["params"], **ONE)
    _close_tree(mine["global_grad"], _jtree(jax, f"{j}/global_grad"), **ONE)
    np.testing.assert_allclose(mine["tau_k"], jax[f"{j}/tau_k"], rtol=1e-6)
    np.testing.assert_allclose(mine["tau_k"], ref["tau_k"], rtol=1e-6)
    for name in R.STATS:
        got = _cat(ranks, lambda o: o["one"][key][name])
        np.testing.assert_allclose(got, jax[f"{j}/{name}"], err_msg=name, **X_STAT[name])
        np.testing.assert_allclose(got, ref[name], err_msg=name, **STAT)
    if mode == "scaffold":
        _close_tree(mine["c"], _jtree(jax, f"{j}/c"), **X_SCAF)
        c_i = {k: _cat(ranks, lambda o: o["one"][key]["c_i"][k]) for k in mine["c_i"]}
        assert all(o["one"][key]["c_i"][k].shape[0] == 2 for o in ranks for k in c_i)
        _close_tree(c_i, _jtree(jax, f"{j}/c_i"), **X_SCAF)
        _close_tree(c_i, ref["c_i"], **ONE)


@pytest.mark.parametrize("name", ["balanced", "imbalanced"])
def test_sharded_cohort_round_matches_jax(runs, name):
    """A cohort of one client a shard, and the imbalanced cohort 0..7 (two
    on each of shards 0-3, none on 4-7: sentinel pads). The stats come
    back in the JAX package's padded (shard, slot) layout; the real rows
    equal the unsharded cohort round's."""
    ranks, jax, ref = runs["ranks"], runs["jax"], runs["ref"]["one"][name]
    mine = ranks[0]["one"][name]
    j = f"cohort/{name}"
    _same_on_every_rank(ranks, lambda o: o["one"][name]["params"])
    _close_tree(mine["params"], _jtree(jax, f"{j}/params"), **ONE)
    _close_tree(mine["params"], ref["params"], **ONE)
    np.testing.assert_allclose(mine["tau_k"], jax[f"{j}/tau_k"], rtol=1e-6)
    per = 1 if name == "balanced" else 2
    real = S.BALANCED if name == "balanced" else S.IMBALANCED
    for n in R.STATS:
        got = _cat(ranks, lambda o: o["one"][name][n])
        assert got.shape == (S.K * per,)
        np.testing.assert_allclose(got, jax[f"{j}/{n}"], err_msg=n, **X_STAT[n])
        np.testing.assert_allclose(got[: len(real)], ref[n], err_msg=n, **STAT)


@pytest.mark.parametrize("key", ["device", "device_pod2"])
def test_sharded_device_data_path_draws_identical_minibatches(runs, key):
    """Client i's generator is seeded from (key, i) on whichever rank holds
    it: the ranks' minibatches, in rank order, are the unsharded draw bit
    for bit, at pod 1 and pod 2; so are the rounds drawn from them (all
    clients, and the imbalanced cohort)."""
    ranks, ref = runs["ranks"], runs["ref"][key]
    for s, o in enumerate(ranks):
        np.testing.assert_array_equal(o[key]["rows"], [2 * s, 2 * s + 1])
    for k, v in ref["sample"].items():
        np.testing.assert_array_equal(_cat(ranks, lambda o: o[key]["sample"][k]), v)
    for which in ("round", "imbalanced"):
        _close_tree(ranks[0][key][which]["params"], ref[which]["params"], **ONE)
    np.testing.assert_allclose(_cat(ranks, lambda o: o[key]["round"]["loss0"]),
                               ref["round"]["loss0"], **STAT)
    pads = _cat(ranks, lambda o: o[key]["imbalanced"]["loss0"])
    np.testing.assert_allclose(pads[:8], ref["imbalanced"]["loss0"], **STAT)


def _hand_engine(cohort):
    """A sharded engine over a client-axis mesh of 8 made by hand (no
    process group): enough for the host-side cohort draw and checks."""
    mesh = FederatedMesh(CLIENT_AXES, (1, 8), rank=0, device=torch.device("cpu"), group=None)
    return RoundEngine(lambda p, b: (None, {}), EngineConfig(cohort_size=cohort),
                       num_clients=S.C, mesh=mesh)


def test_stratified_cohorts_warnings_and_rejection(runs):
    """sample_cohort draws one client a shard for m = 8 (the trajectory's
    draws are these); m = 6 and m = 3 degrade to imbalanced splits with a
    RuntimeWarning; out-of-range or repeated ids are refused."""
    eng = _hand_engine(8)
    rng = np.random.default_rng(0)
    draws = [eng.sample_cohort(rng) for _ in range(S.ROUNDS)]
    for c in draws:
        np.testing.assert_array_equal(c // 2, np.arange(8))
        np.testing.assert_array_equal(c, np.sort(c))
    np.testing.assert_array_equal(np.stack(draws), np.stack(S.trajectory_cohorts()))
    np.testing.assert_array_equal(runs["ranks"][0]["traj"]["eight"]["cohorts"],
                                  np.stack(draws))
    for m in (6, 3):
        with pytest.warns(RuntimeWarning, match="imbalanced"):
            c = _hand_engine(m).sample_cohort(np.random.default_rng(0))
        assert c.shape == (m,) and len(np.unique(c)) == m and c.min() >= 0 and c.max() < S.C
        np.testing.assert_array_equal(c, np.sort(c))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _hand_engine(None).sample_cohort(np.random.default_rng(0)) is None
    for bad in ([0, 1, 2, 3, 4, 5, 6, S.C], [0, 0, 2]):
        with pytest.raises(ValueError, match="cohort must hold distinct client ids"):
            eng._prep_cohort(np.array(bad), S.C, torch.device("cpu"))


@pytest.mark.parametrize("name", ["all", "eight"])
def test_sharded_fused_trajectory_matches_jax(runs, name):
    """6 fused rounds on a (pod 2, data 4) mesh, every client and the
    stratified cohorts of 8: the tau trace EXACTLY the JAX package's and
    the unsharded port's, params within the 6-round bar; the controller's
    full-C state is the same on every rank (P10: replicated, not
    sharded)."""
    ranks, jax, ref = runs["ranks"], runs["jax"], runs["ref"]["traj"][name]
    mine = ranks[0]["traj"][name]
    np.testing.assert_array_equal(mine["taus"], jax[f"traj/{name}/taus"])
    np.testing.assert_array_equal(mine["taus"], ref["taus"])
    _close_tree(mine["params"], _jtree(jax, f"traj/{name}/params"), **SIX)
    _close_tree(mine["params"], ref["params"], **SIX)
    _same_on_every_rank(ranks, lambda o: o["traj"][name]["params"])
    _same_on_every_rank(ranks, lambda o: o["traj"][name]["vals"])
    assert all(v.shape == (S.C,) for v in mine["vals"].values())
    assert ranks[5]["shape2"] == {"pod": 2, "data": 4}
    assert ranks[5]["coords2"] == {"pod": 1, "data": 1}


def test_sharded_driver_end_to_end(runs):
    """TrainDriver on the sharded engine: sync and overlapped runs bitwise
    equal; rank 0 alone holds the rows; every round's cohort is 8
    stratified clients; with every client the run follows the unsharded
    driver (tau trace exact, params within the 6-round bar)."""
    ranks, ref = runs["ranks"], runs["ref"]["driver"]
    d = ranks[0]["driver"]
    assert all(o["driver"]["overlap0"]["rows"] == [] for o in ranks[1:])
    for k in d["overlap0"]["params"]:
        np.testing.assert_array_equal(d["overlap0"]["params"][k], d["overlap2"]["params"][k])
    for a, b in zip(d["overlap0"]["rows"], d["overlap2"]["rows"], strict=True):
        np.testing.assert_array_equal(a["tau"], b["tau"])
        assert np.isfinite(a["train_loss"]) and a["train_loss"] == b["train_loss"]
        np.testing.assert_array_equal(np.asarray(a["cohort"]) // 2, np.arange(8))
    assert len(d["full"]["rows"]) == 5
    for a, b in zip(d["full"]["rows"], ref["full"]["rows"], strict=True):
        np.testing.assert_array_equal(a["tau"], b["tau"])
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5)
    _close_tree(d["full"]["params"], ref["full"]["params"], **SIX)
    _same_on_every_rank(ranks, lambda o: o["driver"]["full"]["params"])


def test_sharded_buffered_matches_sync_sharded(runs):
    """The buffered engine on the mesh in its parity mode (one wave,
    instant arrivals, no decay) IS the sharded sync driver: tau trace and
    params bitwise, cohorts equal, ages 0. A real buffered run (2 waves,
    exp latency, decay 0.5) holds one slot a rank and ages its arrivals.
    A buffer of 6 over 8 shards is refused."""
    ranks = runs["ranks"]
    d = ranks[0]["driver"]
    par, sync = d["buffered_parity"], d["overlap2"]
    for k in sync["params"]:
        np.testing.assert_array_equal(par["params"][k], sync["params"][k])
    for rs, rb in zip(sync["rows"], par["rows"], strict=True):
        np.testing.assert_array_equal(rs["tau"], rb["tau"])
        np.testing.assert_array_equal(np.sort(np.asarray(rs["cohort"])), rb["cohort"])
        assert rb["mean_age"] == 0.0 and rs["train_loss"] == rb["train_loss"]
    asy = d["buffered_async"]
    assert asy["slots"] == 1 and len(asy["rows"]) == 5
    assert all(np.isfinite(r["train_loss"]) for r in asy["rows"])
    assert max(r["max_age"] for r in asy["rows"]) > 0
    _same_on_every_rank(ranks, lambda o: o["driver"]["buffered_async"]["params"])
    assert "must divide the 8 client-axis shards" in d["indivisible_buffer"]
    assert runs["ref"]["driver"]["indivisible_buffer"] is None  # one device: any m


def test_sharded_simulator(runs):
    """FedSimConfig(mesh=) end to end: rank 0's rows (with the test loss
    it evaluates) follow the unsharded simulator's."""
    ranks, ref = runs["ranks"], runs["ref"]["sim"]
    rows = ranks[0]["sim"]["rows"]
    assert len(rows) == 4 and all(o["sim"]["rows"] == [] for o in ranks[1:])
    for a, b in zip(rows, ref["rows"], strict=True):
        assert np.isfinite(a["train_loss"]) and 2 <= a["tau"].min() <= a["tau"].max() <= 4
        np.testing.assert_array_equal(a["tau"], b["tau"])
        np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-5)
        np.testing.assert_allclose(a["test_acc"], b["test_acc"], rtol=1e-5)
    _close_tree(ranks[0]["sim"]["params"], ref["params"], **SIX)


@pytest.mark.parametrize("wire", R.WIRES)
def test_sharded_wire_tau_trace_matches_unsharded(runs, wire):
    """Under int8 and top-k the sharded fused rounds emit EXACTLY the
    unsharded tau trace; each rank keeps only its 2 clients' residual
    rows ([2, ...], real error feedback, dropped by ``reset_wire``), and
    together they are the unsharded engine's rows."""
    ranks, ref = runs["ranks"], runs["ref"]["wire"][wire]
    mine = ranks[0]["wire"][wire]
    np.testing.assert_array_equal(mine["taus"], ref["taus"])
    _close_tree(mine["params"], ref["params"], **SIX)
    for o in ranks:
        res = o["wire"][wire]["residual"]
        assert all(v.shape[0] == 2 for v in res.values()) and o["wire"][wire]["reset"]
    full = {k: _cat(ranks, lambda o: o["wire"][wire]["residual"][k]) for k in ref["residual"]}
    assert any(np.abs(v).max() > 0 for v in full.values())
    _close_tree(full, ref["residual"], **ONE)


def test_launcher_sharded_rows_match_unsharded():
    """``python -m repro_torch.launch.train --mesh data=4 --device cpu``
    (4 gloo ranks it spawns itself) against the same 8 clients on one
    rank (``--mesh data=1 --clients-per-shard 8``), sync and buffered
    under int8: the same rows."""
    base = ["--arch", "starcoder2-3b", "--reduced", "--rounds", "3", "--seq", "32",
            "--batch-per-client", "2", "--device", "cpu"]
    for extra in ([], ["--buffered", "--wire", "int8"]):
        sharded = train_main(base + extra + ["--mesh", "data=4"])
        single = train_main(base + extra + ["--mesh", "data=1", "--clients-per-shard", "8"])
        assert len(sharded) == len(single) == 3
        for a, b in zip(sharded, single):
            np.testing.assert_array_equal(a["tau"], b["tau"])
            np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5)
            assert a["wire_bytes"] == b["wire_bytes"]
