"""Partial participation in the port against the JAX package: the
controller's staleness view, cohort rounds, cohort sampling, the device
data path's per-client draws and the simulator with a cohort.

Inputs are made with numpy from a seed; params are carried over with
``repro_torch.bridge``. Bars:
  * integers (cohort ids, tau traces, ``ever``) and the staleness view's
    scatters and float32 multiplies (``stale_w``, ``vals``): exactly equal;
  * the controller's L on identical inputs: rtol 1e-6
    (tests/test_torch_fed_round.py);
  * a cohort round: params atol 1e-6, beta/delta rtol 1e-3 atol 1e-5,
    tau_k rtol 1e-6 (tests/test_round_engine.py's bars), train loss rtol
    1e-5 (tests/test_torch_fed_run.py's gate 5);
  * m = C against no cohort: atol 1e-7 (tests/test_round_engine.py);
  * a free-running simulator: the tau trace equal up to the first round
    whose entry at the float32 A_min boundary takes its other value (such
    an entry may differ by 1, as in tests/test_torch_fed_run.py's gate 5),
    and the final test loss within 0.02 (its gate 6).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.controller import CohortStats as JaxCohortStats
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ControllerCore as JaxControllerCore
from repro.core.controller import FedVecaController as JaxFedVecaController
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.core.fedveca import RoundStats as JaxRoundStats
from repro.data import synthetic as jsyn
from repro.fed.simulator import FederatedSimulator as JaxSimulator
from repro.fed.simulator import FedSimConfig as JaxFedSimConfig
from repro.models.model import build_model_by_name as jax_build
from repro_torch.core.controller import (CohortStats, ControllerConfig, ControllerCore,
                                         FedVecaController)
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.fedveca import RoundStats
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import DeviceShards, round_key
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.fed import train_lm
from repro_torch.fed.__main__ import main as fed_main
from repro_torch.models.model import build_model_by_name
from test_torch_fed_run import _excused, _np, _state_to_torch, _t

torch.set_num_threads(2)

C, TAU_MAX, B = 3, 5, 8  # the engine rounds (tests/test_round_engine.py)
KEYS = ("loss0", "beta", "delta", "g0_sqnorm")


@pytest.fixture(scope="module")
def svm():
    jm = jax_build("svm-mnist")
    return jm, build_model_by_name("svm-mnist", device="cpu"), jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def round_inputs():
    r = np.random.RandomState(0)
    x = r.randn(C, TAU_MAX, B, 784).astype(np.float32)
    y = r.randint(0, 2, (C, TAU_MAX, B)).astype(np.int32)
    tau = np.array([5, 2, 3], np.int32)
    p = np.array([0.5, 0.2, 0.3], np.float32)
    return dict(x=x, y=y), tau, p


def _engines(svm, mode="fedveca", aggregator="fallback", controller=False, **kw):
    cc = dict(eta=0.01, tau_max=TAU_MAX)
    jeng = JaxRoundEngine(
        svm[0].loss, JaxEngineConfig(mode=mode, eta=0.01, tau_max=TAU_MAX, aggregator=aggregator,
                                     donate=False, **kw),
        num_clients=C,
        controller=JaxControllerCore(JaxControllerConfig(**cc), C) if controller else None)
    teng = RoundEngine(
        svm[1].loss, EngineConfig(mode=mode, eta=0.01, tau_max=TAU_MAX, aggregator=aggregator,
                                  **kw),
        num_clients=C, controller=ControllerCore(ControllerConfig(**cc), C) if controller else None)
    return jeng, teng


def _jb(batches):
    return {k: jnp.asarray(v) for k, v in batches.items()}


def _tb(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def _stats_pair(r, m, with_grad=True):
    """Random cohort RoundStats for m clients, as (JAX, port) twins."""
    v = dict(loss0=r.uniform(0.1, 2.0, m), beta=r.uniform(0.2, 3.0, m),
             delta=r.uniform(0.2, 2.0, m), g0_sqnorm=r.uniform(0.5, 2.0, m))
    v = {k: x.astype(np.float32) for k, x in v.items()}
    grad = ({"w": r.randn(6).astype(np.float32), "b": r.randn(2).astype(np.float32)}
            if with_grad else {})
    sc = {k: np.float32(r.uniform(0.1, 2.0)) for k in
          ("tau_k", "update_sqnorm", "params_sqnorm", "global_grad_sqnorm")}
    tau = np.full(m, 2, np.int32)
    js = JaxRoundStats(tau=jnp.asarray(tau), global_grad=jax.tree.map(jnp.asarray, grad),
                       **{k: jnp.asarray(x) for k, x in {**v, **sc}.items()})
    ts = RoundStats(tau=torch.from_numpy(tau),
                    global_grad={k: torch.from_numpy(x) for k, x in grad.items()},
                    **{k: torch.as_tensor(x) for k, x in {**v, **sc}.items()})
    return js, ts


# ---------------------------------------------------------------------------
# the staleness view
# ---------------------------------------------------------------------------


def _scatter_cases(case):
    """[(C, decay, [(members, (JAX stats, port stats)), ...])]"""
    if case == "jax-test-values":  # test_round_engine.py's never-observed fill
        def stats(beta):
            js = JaxRoundStats(
                loss0=jnp.array([1.0, 2.0]), beta=jnp.array(beta), delta=jnp.array([1.0, 3.0]),
                g0_sqnorm=jnp.array([1.0, 1.0]), tau=jnp.array([2, 2]),
                tau_k=jnp.float32(2.0), global_grad={}, update_sqnorm=jnp.float32(0.1),
                params_sqnorm=jnp.float32(1.0), global_grad_sqnorm=jnp.float32(1.0))
            ts = RoundStats(**{k: (torch.from_numpy(np.array(v)) if k != "global_grad" else {})
                               for k, v in js._asdict().items()})
            return js, ts
        return 4, 1.0, [(np.array([1, 3]), stats([2.0, 4.0])),
                        (np.array([0, 3]), stats([8.0, 4.0]))]
    r = np.random.RandomState(3)
    rounds = []
    for _ in range(20):
        m = int(r.randint(1, 5))
        rounds.append((np.sort(r.choice(7, m, replace=False)), _stats_pair(r, m, False)))
    return 7, 0.8, rounds


@pytest.mark.parametrize("case", ["jax-test-values", "random-cohorts"])
def test_cohort_stats_scatter_matches_jax(case):
    """The host-side view, bitwise, over a sequence of cohorts."""
    n, decay, rounds = _scatter_cases(case)
    jcs, tcs = JaxCohortStats(n, decay=decay), CohortStats(n, decay=decay)
    taus = np.full(n, 2, np.int32)
    for k, (members, (js, ts)) in enumerate(rounds):
        jfull = jcs.scatter(js, members, taus)
        tfull = tcs.scatter(ts, members, taus)
        for key in KEYS:
            np.testing.assert_array_equal(getattr(tfull, key), np.asarray(getattr(jfull, key)),
                                          err_msg=f"{k} {key}")
        np.testing.assert_array_equal(tcs.w, jcs.w)
        np.testing.assert_array_equal(tcs.ever, jcs.ever)
    if case == "jax-test-values":
        np.testing.assert_allclose(np.asarray(tfull.beta), [8.0, 2.0, 14.0 / 3, 4.0])
    with pytest.raises(ValueError, match="decay"):
        CohortStats(3, decay=0.0)


@pytest.mark.parametrize("decay", [0.8, 1.0])
def test_controller_core_with_members_matches_jax(decay):
    """32 rounds of cohort stats (8 clients, cohorts of 1-4), teacher-forced:
    every round the port's ControllerCore steps from the JAX package's
    state; taus, ever, stale_w and vals equal, L within 1e-6."""
    n, rounds = 8, 32
    cc = dict(eta=0.05, alpha=0.95, tau_max=20, decay=decay)
    jcore = JaxControllerCore(JaxControllerConfig(**cc), n)
    tcore = ControllerCore(ControllerConfig(**cc), n)
    r = np.random.RandomState(5)
    jstate = jcore.init_state({"w": np.zeros(6, np.float32), "b": np.zeros(2, np.float32)},
                              np.full(n, 2, np.int32))
    predicted = 0
    for k in range(rounds):
        m = int(r.randint(1, 5))
        members = np.sort(r.choice(n, m, replace=False)).astype(np.int32)
        js, ts = _stats_pair(r, m)
        taus = jnp.clip(jstate.taus, 1, 20)
        tstate, tdiag = tcore.step(_state_to_torch(jstate), ts, torch.from_numpy(members),
                                   torch.from_numpy(np.array(taus)))
        jstate, jdiag = jcore.step(jstate, js, jnp.asarray(members), taus)
        np.testing.assert_array_equal(_np(tstate.taus), np.asarray(jstate.taus),
                                      err_msg=f"round {k}")
        np.testing.assert_array_equal(_np(tstate.ever), np.asarray(jstate.ever))
        np.testing.assert_array_equal(_np(tstate.stale_w), np.asarray(jstate.stale_w))
        for key in KEYS:
            np.testing.assert_array_equal(_np(tstate.vals[key]), np.asarray(jstate.vals[key]))
        for key in ("beta", "delta", "A"):
            np.testing.assert_array_equal(_np(tdiag[key]), np.asarray(jdiag[key]))
        np.testing.assert_allclose(_np(tdiag["L"]), np.asarray(jdiag["L"]), rtol=1e-6)
        predicted += int(k >= 1 and np.any(np.asarray(jdiag["tau_next"]) != 2))
    assert predicted >= 10  # the controller predicted: the check saw real taus


# ---------------------------------------------------------------------------
# the numpy oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def svm_clients():
    orig = tsyn.make_classification(1000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    parts = tpart.partition_case3(orig.y, 5, seed=0)
    clients = [tsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    return clients, tpart.client_weights([c.y for c in clients])


@pytest.mark.parametrize("cohort_size", [None, 2])
def test_numpy_controller_matches_jax_and_the_core(svm, svm_clients, cohort_size):
    """10 recorded rounds (device data path): run_round + CohortStats +
    the port's FedVecaController give, trace for trace, the taus of
    run_fused + ControllerCore, and the JAX package's CohortStats +
    FedVecaController fed the same recorded stats give them too."""
    clients, p = svm_clients
    Cn, T, rounds = 5, 8, 10
    cfg = dict(eta=0.05, tau_max=T)

    def engine(controller=None):
        return RoundEngine(svm[1].loss, EngineConfig(eta=0.05, tau_max=T, batch_size=16,
                                                     cohort_size=cohort_size),
                           shards=DeviceShards.from_datasets(clients, device="cpu"), num_clients=Cn,
                           controller=controller)

    eng, ctl = engine(), FedVecaController(ControllerConfig(**cfg), Cn)
    cs = CohortStats(Cn, decay=0.9)
    jctl, jcs = JaxFedVecaController(JaxControllerConfig(**cfg), Cn), JaxCohortStats(Cn, 0.9)
    rng = np.random.default_rng(0)
    params = _t(svm[2])
    taus, state, jstate, gprev = ctl.init_taus(), ctl.init_state(), jctl.init_state(), 0.0
    oracle = []
    for k in range(rounds):
        cohort = eng.sample_cohort(rng)
        params, stats, _ = eng.run_round(params, taus, p, gprev, key=round_key(0, k),
                                         cohort=cohort)
        members = cohort if cohort is not None else np.arange(Cn)
        js = JaxRoundStats(**{f: (jax.tree.map(jnp.asarray, {n: _np(v) for n, v in x.items()})
                                  if isinstance(x, dict) else jnp.asarray(_np(x)))
                              for f, x in stats._asdict().items()})
        jstate, jtaus, _ = jctl.update(jstate, jcs.scatter(js, members, taus))
        state, taus, diag = ctl.update(state, cs.scatter(stats, members, taus))
        np.testing.assert_array_equal(taus, np.asarray(jtaus), err_msg=f"round {k}")
        gprev = float(stats.global_grad_sqnorm)
        oracle.append((taus.copy(), diag["L"], diag["premise"]))
    assert any(np.any(t != 2) for t, _, _ in oracle)

    eng2 = engine(ControllerCore(ControllerConfig(**cfg), Cn))
    rng = np.random.default_rng(0)
    params = _t(svm[2])
    cstate = eng2.init_controller_state(params, np.full(Cn, 2, np.int32))
    for k in range(rounds):
        cohort = eng2.sample_cohort(rng)
        params, cstate, _, diag = eng2.run_fused(params, cstate, p, key=round_key(0, k),
                                                 cohort=cohort)
        tau_np, L_np, prem_np = oracle[k]
        np.testing.assert_array_equal(_np(diag["tau_next"]), tau_np, err_msg=f"round {k}")
        np.testing.assert_allclose(float(diag["L"]), L_np, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(diag["premise"]), prem_np, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# cohort sampling and the cohort round
# ---------------------------------------------------------------------------


def test_sample_cohort_matches_jax(svm):
    for n, m, seed in ((7, 3, 0), (20, 5, 1), (5, 1, 2), (4, 4, 3), (4, None, 4)):
        jeng = JaxRoundEngine(svm[0].loss, JaxEngineConfig(cohort_size=m), num_clients=n)
        teng = RoundEngine(svm[1].loss, EngineConfig(cohort_size=m), num_clients=n)
        jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(5):
            a, b = jeng.sample_cohort(jrng), teng.sample_cohort(trng)
            if m is None or m >= n:
                assert a is None and b is None
            else:
                assert b.dtype == np.int32 and len(set(b.tolist())) == m
                np.testing.assert_array_equal(b, a)


def test_cohort_size_zero_raises(svm):
    with pytest.raises(ValueError, match="cohort_size"):
        RoundEngine(svm[1].loss, EngineConfig(cohort_size=0), num_clients=C)
    with pytest.raises(ValueError, match="cohort_size"):  # the JAX package's own check
        JaxRoundEngine(svm[0].loss, JaxEngineConfig(cohort_size=0), num_clients=C)
    teng = RoundEngine(svm[1].loss, EngineConfig(), num_clients=C)
    for bad in ([], [0, 0], [3], [-1]):
        with pytest.raises(ValueError, match="cohort"):
            teng.run_round(_t(svm[2]), np.full(C, 2, np.int32), np.full(C, 1 / C), 0.0,
                           batches={"x": torch.zeros(C, 2, 1, 784),
                                    "y": torch.zeros(C, 2, 1, dtype=torch.int32)},
                           cohort=np.array(bad, np.int32))


@pytest.mark.parametrize("aggregator", ["fallback", "auto"])
def test_full_cohort_equals_no_cohort(svm, round_inputs, aggregator):
    batches, tau, p = round_inputs
    _, teng = _engines(svm, aggregator=aggregator)
    full, _, _ = teng.run_round(_t(svm[2]), tau, p, 0.05, batches=_tb(batches))
    coh, _, _ = teng.run_round(_t(svm[2]), tau, p, 0.05, batches=_tb(batches),
                               cohort=np.arange(C, dtype=np.int32))
    for k in full:
        torch.testing.assert_close(coh[k], full[k], atol=1e-7, rtol=0)


@pytest.mark.parametrize("entry", ["run_round", "run_fused"])
def test_sub_cohort_round_matches_jax(svm, round_inputs, entry):
    """Cohort [0, 2] of 3 from the same params and host batches: the port's
    gathers, renormalised weights, controller members, tau_round_sum and
    train loss against the JAX engine's."""
    batches, tau, p = round_inputs
    cohort = np.array([0, 2], np.int32)
    jeng, teng = _engines(svm, controller=(entry == "run_fused"))
    if entry == "run_round":
        jp, js, _ = jeng.run_round(svm[2], tau, p, 0.05, batches=_jb(batches), cohort=cohort)
        tp, ts, _ = teng.run_round(_t(svm[2]), tau, p, 0.05, batches=_tb(batches),
                                   cohort=cohort)
        jbeta, tbeta = js.beta, ts.beta
        assert ts.beta.shape == (2,)
        np.testing.assert_allclose(_np(ts.tau_k), np.asarray(js.tau_k), rtol=1e-6)
    else:
        jst = jeng.init_controller_state(svm[2], tau)
        tst = teng.init_controller_state(_t(svm[2]), tau)
        jp, jst, _, jd = jeng.run_fused(svm[2], jst, p, batches=_jb(batches), cohort=cohort)
        tp, tst, _, td = teng.run_fused(_t(svm[2]), tst, p, batches=_tb(batches), cohort=cohort)
        jbeta, tbeta = jd["beta"], td["beta"]
        assert int(td["tau_round_sum"]) == int(jd["tau_round_sum"]) == int(tau[cohort].sum())
        np.testing.assert_allclose(_np(td["train_loss"]), np.asarray(jd["train_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(td["tau_k"]), np.asarray(jd["tau_k"]), rtol=1e-6)
        np.testing.assert_array_equal(_np(tst.ever), np.asarray(jst.ever))
        np.testing.assert_array_equal(_np(tst.ever), [True, False, True])
        np.testing.assert_array_equal(_np(td["tau_next"]), np.asarray(jd["tau_next"]))
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(tbeta), np.asarray(jbeta), rtol=1e-3, atol=1e-5)


def test_scaffold_cohort_rows_stay_keyed_by_client_id(svm, round_inputs):
    """A round over cohort [0, 2] leaves client 1's control variate zero; a
    second over [1, 2] leaves client 0's as it was; both against the JAX
    engine (SCAFFOLD's bar in tests/test_torch_fed_round.py: 1e-5 / 1e-4)."""
    batches, tau, p = round_inputs
    jeng, teng = _engines(svm, mode="scaffold")
    jparams, tparams = svm[2], _t(svm[2])
    jsc = tsc = None
    for cohort in ([0, 2], [1, 2]):
        cohort = np.array(cohort, np.int32)
        jparams, _, jsc = jeng.run_round(jparams, tau, p, 0.0, batches=_jb(batches),
                                         scaffold=jsc, cohort=cohort)
        before = None if tsc is None else {k: v.clone() for k, v in tsc.c_i.items()}
        tparams, _, tsc = teng.run_round(tparams, tau, p, 0.0, batches=_tb(batches),
                                         scaffold=tsc, cohort=cohort)
        for k, v in tsc.c_i.items():
            assert v.shape[0] == C
            if before is None:
                assert not v[1].any() and v[0].abs().sum() > 0
            else:
                assert torch.equal(v[0], before[k][0])
            np.testing.assert_allclose(_np(v), np.asarray(jsc.c_i[k]), atol=1e-5, rtol=1e-4)


def test_device_sample_draws_each_client_alike_in_any_cohort():
    r = np.random.RandomState(0)
    ds = [tsyn.Dataset(r.randn(n, 3).astype(np.float32), np.arange(n, dtype=np.int32))
          for n in (5, 9, 7, 4)]
    shards = DeviceShards.from_datasets(ds, device="cpu")
    full = shards.sample(11, 4, 6)
    for ids in ([1, 3], [3], [0, 2, 3]):
        sub = shards.sample(11, 4, 6, ids=np.array(ids, np.int32))
        assert sub["x"].shape == (len(ids), 4, 6, 3)
        for j, i in enumerate(ids):
            assert torch.equal(sub["y"][j], full["y"][i])
            assert torch.equal(sub["x"][j], full["x"][i])


# ---------------------------------------------------------------------------
# the simulator and the entry points
# ---------------------------------------------------------------------------


def test_simulator_cohort_host_path_matches_jax(svm):
    """SVM, Case 3 over 5 clients, cohorts of 2, stats_decay 0.8, host
    batches, 10 rounds: the cohort ids of every round equal the JAX
    simulator's (one RNG: cohort, then batches), the tau trace equal up to
    the first round where a boundary entry (tests/test_torch_fed_run.py's
    ``_excused``: the A_min client's float32 floor) takes the other of its
    two values, the final test loss within 0.02."""
    orig = tsyn.make_classification(2000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    test = tsyn.binarize_even_odd(tsyn.make_classification(500, (784,), 10, seed=1))
    parts = tpart.partition_case3(orig.y, 5, seed=0)
    common = dict(mode="fedveca", rounds=10, tau_max=20, batch_size=16, eta=0.05,
                  data_path="host", cohort_size=2, stats_decay=0.8)
    tlog = FederatedSimulator(svm[1], [tsyn.Dataset(train.x[s], train.y[s]) for s in parts],
                              FedSimConfig(**common), tsyn.Dataset(test.x, test.y)
                              ).run(params=_t(svm[2]))
    jlog = JaxSimulator(svm[0], [jsyn.Dataset(train.x[s], train.y[s]) for s in parts],
                        JaxFedSimConfig(**common), jsyn.Dataset(test.x, test.y)
                        ).run(params=jax.tree.map(jnp.copy, svm[2]))
    compared, diverged = 0, False
    for jr, tr in zip(jlog.rows, tlog.rows, strict=True):
        k = jr["round"]
        assert len(tr["cohort"]) == 2
        np.testing.assert_array_equal(tr["cohort"], jr["cohort"], err_msg=f"round {k}")
        if diverged:
            continue  # past a boundary entry the runs may take other taus
        t_next, j_next = np.asarray(tr["tau"]), np.asarray(jr["tau"])
        near = _excused(jr["A"], jr["alpha_k"]) if k >= 1 else np.zeros(5, bool)
        np.testing.assert_array_equal(t_next[~near], j_next[~near], err_msg=f"round {k}")
        assert np.all(np.abs(t_next[near] - j_next[near]) <= 1), f"round {k}"
        compared += 1
        diverged = bool(np.any(t_next != j_next))
    assert compared >= 2
    assert abs(tlog.rows[-1]["test_loss"] - jlog.rows[-1]["test_loss"]) <= 0.02
    assert tlog.rows[-1]["test_loss"] < tlog.rows[0]["test_loss"]


@pytest.mark.parametrize("entry", ["fed", "train_lm"])
def test_cohort_entry_points_run_on_the_cpu(entry):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if entry == "fed":
            fed_main(["--device", "cpu", "--rounds", "2", "--cohort", "2"])
        else:
            train_lm.main(["--device", "cpu", "--rounds", "2", "--clients", "3", "--seq", "16",
                           "--batch", "2", "--tau-max", "2", "--cohort", "2"])
    text = out.getvalue()
    assert ("fedveca" in text and "loss=" in text) if entry == "fed" else "done." in text
