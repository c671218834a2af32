"""Whole federated runs of the port against the JAX package, and the
port's own driver contract.

Setting (the paper's headline experiment at test scale, as
tests/test_simulator.py): squared-SVM on even/odd MNIST-shaped synthetic
data, Case-3 Non-IID split over 5 clients, tau_max 20, eta 0.05, batch
16, 10 rounds. Params are carried over from the JAX package; batches are
drawn by both packages' ``host_stacked_batches`` from the same
``np.random.default_rng`` seed (the device data path draws with
``jax.random`` there and ``torch.Generator`` here, which cannot agree).

Why tau traces are not held exactly over a free run: tau_i =
floor(A_i / (A_i - alpha_k * A_min)). For the client that holds A_min the
ratio is 1/(1 - alpha) = 20 exactly in real arithmetic at alpha = 0.95, so
its float32 floor is 19 or 20 depending on the last bits of A_min, and the
two frameworks sum gradients in different orders. So:

  * teacher-forced (every round starts from the JAX package's params and
    controller state): tau_next equals the reference's for every client
    whose reference ratio lies at least 1e-3 (relative) from an integer;
    for the rest ("excused": the A_min client always is) it may differ by
    at most 1. Round outputs are held at the round-step bars of
    test_torch_fed_round.py.
  * free-running: the fedveca tau trace equals the reference's up to and
    including the first round with an excused entry (after that the runs
    may take different taus), and the final test loss is within 0.02 of
    the reference's, the slack of the JAX package's own headline test
    (tests/test_simulator.py). FedAvg and FedNova with the same fixed taus
    follow the reference round for round: train loss, test loss and test
    accuracy within rtol 1e-4 (float32 rounding differences of ~1e-7 per
    round, compounded over 10 rounds of a convex model, stay orders of
    magnitude below it).
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ControllerCore as JaxControllerCore
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import synthetic as jsyn
from repro.data.device import host_stacked_batches as jax_host_batches
from repro.fed.simulator import FederatedSimulator as JaxSimulator
from repro.fed.simulator import FedSimConfig as JaxFedSimConfig
from repro.fed.simulator import centralized_sgd as jax_centralized_sgd
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.core.controller import ControllerConfig, ControllerCore, CoreState
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import host_stacked_batches
from repro_torch.fed import FederatedSimulator, FedSimConfig, centralized_sgd, fair_fixed_tau
from repro_torch.fed.__main__ import main as fed_main
from repro_torch.models.model import build_model_by_name

torch.set_num_threads(2)

C, TAU_MAX, ETA, BATCH, ROUNDS = 5, 20, 0.05, 16, 10
NEAR_INT = 1e-3  # relative distance of an excused ratio from an integer


def _np(t):
    return t.detach().cpu().numpy()


def _t(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def setup():
    orig = tsyn.make_classification(2000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    test = tsyn.binarize_even_odd(tsyn.make_classification(500, (784,), 10, seed=1))
    parts = tpart.partition_case3(orig.y, C, seed=0)
    tclients = [tsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    jclients = [jsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    jm = jax_build("svm-mnist")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model_by_name("svm-mnist", device="cpu")
    return dict(jm=jm, jp=jp, tm=tm, tclients=tclients, jclients=jclients,
                ttest=tsyn.Dataset(test.x, test.y), jtest=jsyn.Dataset(test.x, test.y))


def _excused(A, alpha_k, eps=1e-12):
    """Clients whose reference ratio A_i / (A_i - alpha_k * A_min) lies
    within NEAR_INT (relative) of an integer."""
    A = np.maximum(np.asarray(A, np.float64), eps)
    ratio = A / (A - float(alpha_k) * A.min())
    return np.abs(ratio - np.round(ratio)) <= NEAR_INT * np.abs(ratio)


def _state_to_torch(js) -> CoreState:
    def t(x):
        return torch.from_numpy(np.array(x))

    return CoreState(round=t(js.round), L=t(js.L),
                     prev_global_grad=_t(js.prev_global_grad),
                     prev2_global_grad=_t(js.prev2_global_grad),
                     prev_grad_sqnorm=t(js.prev_grad_sqnorm),
                     params0_sqnorm=t(js.params0_sqnorm),
                     prev_update_sqnorm=t(js.prev_update_sqnorm),
                     prev2_update_sqnorm=t(js.prev2_update_sqnorm), taus=t(js.taus),
                     ever=t(js.ever), stale_w=t(js.stale_w),
                     vals={k: t(v) for k, v in js.vals.items()})


# ---------------------------------------------------------------------------
# gate 5: teacher-forced whole run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_aggregator", ["pallas", "fallback"])
def test_teacher_forced_fedveca_run_matches_jax(setup, jax_aggregator):
    jm, tm, tclients, jclients = setup["jm"], setup["tm"], setup["tclients"], setup["jclients"]
    p = tpart.client_weights([c.y for c in tclients])
    cc = dict(eta=ETA, alpha=0.95, tau_max=TAU_MAX)
    jeng = JaxRoundEngine(
        jm.loss, JaxEngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH,
                                 aggregator=jax_aggregator, donate=False),
        num_clients=C, controller=JaxControllerCore(JaxControllerConfig(**cc), C))
    teng = RoundEngine(tm.loss, EngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH),
                       controller=ControllerCore(ControllerConfig(**cc), C))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    jparams = setup["jp"]
    jstate = jeng.init_controller_state(jparams, np.full(C, 2, np.int32))
    excused = adapted = 0
    for k in range(ROUNDS):
        jb = jax_host_batches(jclients, jrng, TAU_MAX, BATCH)
        tb = host_stacked_batches(tclients, trng, TAU_MAX, BATCH, device="cpu")
        np.testing.assert_array_equal(_np(tb["x"]), np.asarray(jb["x"]))
        tp, tstate, _, tdiag = teng.run_fused(_t(jparams), _state_to_torch(jstate), p,
                                              batches=tb)
        jparams, jstate, _, jdiag = jeng.run_fused(jparams, jstate, p, batches=jb)
        for key in jparams:
            np.testing.assert_allclose(_np(tp[key]), np.asarray(jparams[key]), atol=1e-6,
                                       rtol=0, err_msg=f"round {k} {key}")
        for key in ("beta", "delta"):
            np.testing.assert_allclose(_np(tdiag[key]), np.asarray(jdiag[key]), rtol=1e-3,
                                       atol=1e-5, err_msg=f"round {k} {key}")
        np.testing.assert_allclose(_np(tdiag["tau_k"]), np.asarray(jdiag["tau_k"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tdiag["train_loss"]), np.asarray(jdiag["train_loss"]),
                                   rtol=1e-5)
        t_next, j_next = _np(tdiag["tau_next"]), np.asarray(jdiag["tau_next"])
        near = (_excused(jdiag["A"], jdiag["alpha_k"]) if k >= 1
                else np.zeros(C, bool))  # round 0 passes tau_init through
        np.testing.assert_array_equal(t_next[~near], j_next[~near], err_msg=f"round {k}")
        assert np.all(np.abs(t_next[near] - j_next[near]) <= 1), f"round {k}"
        excused += int(near.sum())
        adapted += int(np.any(j_next != 2))
    print(f"teacher-forced fedveca ({jax_aggregator}): {excused} of {C * (ROUNDS - 1)} "
          "tau_next entries excused (reference ratio within 1e-3 of an integer)")
    assert adapted >= 1  # the controller left tau_init: the check saw real taus


# ---------------------------------------------------------------------------
# gate 6: free-running whole runs
# ---------------------------------------------------------------------------


def _runs(setup, mode, **kw):
    common = dict(mode=mode, rounds=ROUNDS, tau_max=TAU_MAX, batch_size=BATCH, eta=ETA,
                  data_path="host", **kw)
    tlog = FederatedSimulator(setup["tm"], setup["tclients"], FedSimConfig(**common),
                              setup["ttest"]).run(params=_t(setup["jp"]))
    # the JAX simulator donates the params it is given: hand it a copy
    jlog = JaxSimulator(setup["jm"], setup["jclients"], JaxFedSimConfig(**common),
                        setup["jtest"]).run(params=jax.tree.map(jnp.copy, setup["jp"]))
    return jlog, tlog


@pytest.fixture(scope="module")
def fedveca_runs(setup):
    return _runs(setup, "fedveca")


def test_free_running_fedveca_matches_jax(fedveca_runs):
    jlog, tlog = fedveca_runs
    compared = 0
    for jr, tr in zip(jlog.rows, tlog.rows):
        np.testing.assert_array_equal(tr["tau"], jr["tau"], err_msg=f"round {jr['round']}")
        compared += 1
        if jr["round"] >= 1 and _excused(jr["A"], jr["alpha_k"]).any():
            break  # past this boundary the two runs may take different taus
    print(f"free-running fedveca: tau trace equal over {compared} of {ROUNDS} rounds")
    assert compared >= 2
    assert abs(tlog.rows[-1]["test_loss"] - jlog.rows[-1]["test_loss"]) <= 0.02
    assert tlog.rows[-1]["test_loss"] < tlog.rows[0]["test_loss"]


@pytest.mark.parametrize("mode", ["fedavg", "fednova"])
def test_free_running_baselines_match_jax(setup, fedveca_runs, mode):
    jveca = fedveca_runs[0]
    sizes = np.array([len(c) for c in setup["tclients"]], float)
    ft = np.minimum(fair_fixed_tau(jveca.tau_all, ROUNDS, BATCH, sizes), TAU_MAX)
    jlog, tlog = _runs(setup, mode, fixed_tau=ft)
    for key in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(tlog.column(key), jlog.column(key), rtol=1e-4, err_msg=key)
    for jr, tr in zip(jlog.rows, tlog.rows):
        np.testing.assert_array_equal(tr["tau"], jr["tau"])
    assert tlog.tau_all == jlog.tau_all


def test_centralized_sgd_matches_jax(setup):
    """Same RandomState draws, same bridged init: the baseline's params and
    test metrics agree (atol 1e-6 / rtol 1e-5, float32 SGD steps)."""
    pooled = np.concatenate([c.x for c in setup["tclients"]])
    labels = np.concatenate([c.y for c in setup["tclients"]])
    jpar, jev = jax_centralized_sgd(setup["jm"], jsyn.Dataset(pooled, labels), 30, BATCH,
                                    ETA, setup["jtest"], seed=3)
    tpar, tev = centralized_sgd(setup["tm"], tsyn.Dataset(pooled, labels), 30, BATCH, ETA,
                                setup["ttest"], seed=3, params=_t(setup["jm"].init(
                                    jax.random.PRNGKey(3))))
    for key in jpar:
        np.testing.assert_allclose(_np(tpar[key]), np.asarray(jpar[key]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tev["test_loss"], jev["test_loss"], rtol=1e-5)
    assert tev["test_acc"] == jev["test_acc"]


# ---------------------------------------------------------------------------
# gate 7: the driver's overlap does not change a bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fedveca", "scaffold"])
def test_overlap_is_bit_identical(setup, mode):
    """Device data path (the port's own per-client generators), 6 rounds;
    rows and final params equal bit for bit for overlap 0, 1 and 2."""
    outs = []
    for overlap in (0, 1, 2):
        cfg = FedSimConfig(mode=mode, rounds=6, tau_max=8, batch_size=BATCH, eta=ETA,
                           overlap=overlap, seed=5)
        log = FederatedSimulator(setup["tm"], setup["tclients"], cfg, setup["ttest"]).run()
        outs.append(log)
    for log in outs[1:]:
        assert len(log.rows) == len(outs[0].rows) == 6
        for a, b in zip(outs[0].rows, log.rows):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                              err_msg=key)
        for key in log.params:
            assert torch.equal(log.params[key], outs[0].params[key])
    taus = np.stack(outs[0].column("tau"))
    assert taus.min() >= 2 and taus.max() <= 8


@pytest.mark.parametrize("max_batch", [3, 7, 2048])
def test_dataset_evaluator_matches_jax(setup, max_batch):
    """Whole-set eval in equal chunks plus a remainder (7 samples: 2 x 3 +
    1, one chunk of 7, one short chunk), weighted by size as the JAX
    package's evaluator weights them (float32: rtol 1e-6)."""
    from repro.core.driver import make_dataset_evaluator as jax_evaluator
    from repro_torch.core.driver import make_dataset_evaluator

    x, y = setup["ttest"].x[:7], setup["ttest"].y[:7]
    params = setup["jp"]
    want = jax_evaluator(setup["jm"].loss, jsyn.Dataset(x, y), max_batch)(params)
    got = make_dataset_evaluator(setup["tm"].loss, tsyn.Dataset(x, y), max_batch, device="cpu")(_t(params))
    assert sorted(got) == sorted(want) == ["test_acc", "test_loss"]
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)


def test_device_data_path_draws_per_client():
    """Client i's draws depend only on (key, i, its size): adding a client
    changes nobody else's minibatches, and a new key draws anew."""
    from repro_torch.data.device import DeviceShards

    r = np.random.RandomState(0)
    ds = [tsyn.Dataset(r.randn(n, 3).astype(np.float32), np.arange(n, dtype=np.int32))
          for n in (5, 9, 7)]
    a = DeviceShards.from_datasets(ds, device="cpu").sample(11, 4, 6)
    b = DeviceShards.from_datasets(ds + ds[:1], device="cpu").sample(11, 4, 6)
    c = DeviceShards.from_datasets(ds, device="cpu").sample(12, 4, 6)
    assert a["x"].shape == (3, 4, 6, 3) and a["y"].dtype == torch.int32
    for i, n in enumerate((5, 9, 7)):
        assert torch.equal(a["y"][i], b["y"][i])
        assert int(a["y"][i].max()) < n  # padding rows are never drawn
        np.testing.assert_array_equal(_np(a["x"][i]), ds[i].x[_np(a["y"][i])])
    assert not torch.equal(a["y"], c["y"])


# ---------------------------------------------------------------------------
# entry points and the options the port does not run yet
# ---------------------------------------------------------------------------


def test_strict_fp32_sets_and_restores_the_flags():
    """The round runs with TF32 off for cuDNN and float32 matmuls at
    'highest'; the caller's settings come back afterwards."""
    from repro_torch import strict_fp32

    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.enabled, cudnn.deterministic,
              torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("high")
    try:
        with strict_fp32():
            assert not cudnn.allow_tf32 and cudnn.enabled == before[1]
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        assert (cudnn.allow_tf32, cudnn.enabled, cudnn.deterministic) == before[:3]
    finally:
        torch.set_float32_matmul_precision(before[3])


def test_fed_cli_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fed_main(["--device", "cpu", "--rounds", "2"])
    text = out.getvalue()
    assert "FedVeca (cpu)" in text
    for name in ("fedveca", "fedavg", "fednova", "centralized"):
        assert f"{name}" in text and "loss=" in text


def test_fed_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model_by_name("cnn-cifar10")
    with pytest.raises(RuntimeError, match="cuda"):
        fed_main(["--rounds", "1"])


def _two_shard_mesh():
    """A client-axis mesh of 2 shards, made by hand (no process group)."""
    from repro_torch.launch.mesh import CLIENT_AXES, FederatedMesh

    return FederatedMesh(CLIENT_AXES, (1, 2), rank=0, device=torch.device("cpu"), group=None)


@pytest.mark.parametrize("kw,exc,item", [(dict(mesh=_two_shard_mesh()), ValueError,
                                          "divide evenly")])
def test_options_not_ported_raise(setup, kw, exc, item):
    """The mesh is ported (the sharded round): 5 clients over 2 shards
    do not divide evenly and raise."""
    with pytest.raises(exc, match=item):
        FederatedSimulator(setup["tm"], setup["tclients"], FedSimConfig(**kw))


def test_engine_halves_not_ported_raise(setup):
    """The driver's sanitizer lane (once A19, ported): two sanitized rounds
    on host batches are bit for bit the plain driver's, with no library
    build and no new allocator segment after round 0."""
    from repro_torch.core.driver import TrainDriver

    def run(sanitize):
        drv = TrainDriver(
            RoundEngine(setup["tm"].loss, EngineConfig(eta=ETA, tau_max=4, batch_size=BATCH),
                        controller=ControllerCore(ControllerConfig(eta=ETA, tau_max=4), C)),
            np.full(C, 0.2), sanitize=sanitize,
            batches_fn=lambda rng: host_stacked_batches(setup["tclients"], rng, 4, BATCH,
                                                        device="cpu"))
        return drv, drv.run(_t(setup["jp"]), 2, np.full(C, 2, np.int32))

    (_, plain), (drv, lane) = run(None), run(True)
    assert drv.sanitizer.steady_builds == 0 and not drv.sanitizer.active
    for a, b in zip(plain.rows, lane.rows):
        np.testing.assert_array_equal(a["tau"], b["tau"])
        assert a["train_loss"] == b["train_loss"]
    for k in plain.params:
        assert torch.equal(plain.params[k], lane.params[k])
