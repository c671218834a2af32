"""Buffered asynchronous rounds (``core/buffered.py``) in the port: the
parity mode against the port's synchronous driver, a real buffered run
against the JAX package's ``BufferedRoundEngine``, and the scheduler's
contracts (tests/test_buffered_round.py).

Bars:
  * parity mode (one wave, instant arrivals, ``grad_decay=1.0``) against
    the port's ``TrainDriver``: tau traces, train losses, ``wire_bytes``
    and params bit for bit (one wave w samples with ``round_key(seed, w)``
    and the cohorts come from one ``np.random.default_rng(seed)``, the
    driver's discipline);
  * against the JAX package with two waves, ``exp`` latency and
    ``grad_decay=0.9``: every client's shard holds one example repeated,
    so any index draw gives both packages the same minibatches, and the
    JAX ``LatencyModel``'s draws are fed to the port's inside the test
    (``jax.random`` cannot be reproduced, ROADMAP.md P9). The commits'
    cohorts, ages, simulated times and tau traces are exact and the
    params allclose at tests/test_torch_cohort.py's bar (atol 1e-6).
Params are carried over from the JAX package with ``repro_torch.bridge``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.buffered import BufferedConfig as JaxBufferedConfig
from repro.core.buffered import BufferedRoundEngine as JaxBufferedRoundEngine
from repro.core.buffered import LatencyModel as JaxLatencyModel
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ControllerCore as JaxControllerCore
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import synthetic as jsyn
from repro.data.device import DeviceShards as JaxDeviceShards
from repro.models.model import build_model_by_name as jax_build
from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel
from repro_torch.core.controller import ControllerConfig, ControllerCore
from repro_torch.core.driver import TrainDriver
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import DeviceShards
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.models.model import build_model_by_name
from test_torch_fed_run import _np, _t

torch.set_num_threads(2)

C, TAU_MAX, ROUNDS = 5, 8, 6  # tests/test_buffered_round.py's setting


@pytest.fixture(scope="module")
def setup():
    orig = tsyn.make_classification(1000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    parts = tpart.partition_case3(orig.y, C, seed=0)
    clients = [tsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    jm = jax_build("svm-mnist")
    p = np.array([len(c) for c in clients], np.float64)
    return dict(tm=build_model_by_name("svm-mnist", device="cpu"), jm=jm,
                jp=jm.init(jax.random.PRNGKey(0)), clients=clients,
                p=(p / p.sum()).astype(np.float32))


def _engine(setup, cohort=None, mode="fedveca", wire="none", clients=None):
    return RoundEngine(
        setup["tm"].loss,
        EngineConfig(mode=mode, eta=0.05, tau_max=TAU_MAX, batch_size=16, cohort_size=cohort,
                     wire=wire),
        shards=DeviceShards.from_datasets(clients or setup["clients"], device="cpu"), num_clients=C,
        controller=ControllerCore(ControllerConfig(eta=0.05, tau_max=TAU_MAX, tau_init=2), C,
                                  adapt=(mode == "fedveca")))


def _same_params(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the parity mode: one wave + instant arrivals + no decay == the sync driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("cohort", [3, None])
def test_parity_mode_bitwise_equal_to_sync_driver(setup, cohort, wire):
    taus0 = np.full(C, 2, np.int32)
    log_s = TrainDriver(_engine(setup, cohort, wire=wire), setup["p"], overlap=1,
                        seed=0).run(_t(setup["jp"]), ROUNDS, taus0.copy())
    buf = BufferedRoundEngine(_engine(setup, cohort, wire=wire), setup["p"],
                              BufferedConfig(waves=1, grad_decay=1.0,
                                             latency=LatencyModel("instant"), seed=0))
    log_b = buf.run(_t(setup["jp"]), ROUNDS, taus0.copy())
    assert len(log_b.rows) == ROUNDS
    for rs, rb in zip(log_s.rows, log_b.rows, strict=True):
        np.testing.assert_array_equal(rs["tau"], rb["tau"])
        assert rs["train_loss"] == rb["train_loss"] and rs["tau_all"] == rb["tau_all"]
        assert rs["wire"] == rb["wire"] and rs["wire_bytes"] == rb["wire_bytes"]
        assert rb["mean_age"] == 0.0 and rb["sim_time"] == 0.0
        if cohort is not None:
            np.testing.assert_array_equal(np.sort(rs["cohort"]), rb["cohort"])
    assert _same_params(log_s.params, log_b.params)
    assert log_s.tau_all == log_b.tau_all
    assert buf.wave_dispatches == buf.fold_dispatches == ROUNDS


@pytest.mark.parametrize("mode", ["fednova", "fedavg", "fedprox"])
def test_parity_mode_other_modes(setup, mode):
    taus = np.full(C, 3, np.int32)
    log_s = TrainDriver(_engine(setup, 3, mode), setup["p"], overlap=1, seed=0,
                        mode=mode).run(_t(setup["jp"]), 3, taus.copy())
    log_b = BufferedRoundEngine(_engine(setup, 3, mode), setup["p"],
                                BufferedConfig(waves=1, latency=LatencyModel("instant"), seed=0),
                                mode=mode).run(_t(setup["jp"]), 3, taus.copy())
    assert _same_params(log_s.params, log_b.params)
    for rs, rb in zip(log_s.rows, log_b.rows, strict=True):
        assert rs["train_loss"] == rb["train_loss"]


def test_simulator_buffered_parity_with_int8(setup):
    """``FedSimConfig(buffered=True)`` in the parity mode against the sync
    simulator, with a cohort and a lossy codec: bit for bit."""
    base = dict(mode="fedveca", rounds=3, tau_max=4, batch_size=16, eta=0.05,
                cohort_size=3, wire="int8")
    sync = FederatedSimulator(setup["tm"], setup["clients"], FedSimConfig(**base))
    assert sync.buffered_engine is None
    sync = sync.run(params=_t(setup["jp"]))
    par = FederatedSimulator(setup["tm"], setup["clients"], FedSimConfig(**base, buffered=True))
    assert par.buffered_engine is not None
    par = par.run(params=_t(setup["jp"]))
    for rs, rb in zip(sync.rows, par.rows, strict=True):
        np.testing.assert_array_equal(rs["tau"], rb["tau"])
        assert rs["train_loss"] == rb["train_loss"] and rs["wire_bytes"] == rb["wire_bytes"]
    assert _same_params(sync.params, par.params)


# ---------------------------------------------------------------------------
# a real buffered run against the JAX package
# ---------------------------------------------------------------------------


def _one_example_shards(setup):
    """Client i holds its first example ``len_i`` times: any index draw is
    the same minibatch in both packages."""
    out = []
    for c in setup["clients"]:
        n = len(c)
        out.append((np.repeat(c.x[:1], n, 0), np.repeat(c.y[:1], n, 0)))
    return out


@pytest.mark.parametrize("cohort", [3, None])
def test_buffered_run_matches_jax(setup, cohort):
    rows = _one_example_shards(setup)
    steps, taus0 = 8, np.full(C, 2, np.int32)
    jlat = JaxLatencyModel("exp", scale=1.0, seed=3)
    jeng = JaxRoundEngine(
        setup["jm"].loss,
        JaxEngineConfig(mode="fedveca", eta=0.05, tau_max=TAU_MAX, batch_size=16,
                        cohort_size=cohort, aggregator="fallback", donate=False),
        shards=JaxDeviceShards.from_datasets([jsyn.Dataset(x, y) for x, y in rows]),
        num_clients=C,
        controller=JaxControllerCore(JaxControllerConfig(eta=0.05, tau_max=TAU_MAX,
                                                         tau_init=2), C))
    jbuf = JaxBufferedRoundEngine(jeng, setup["p"], JaxBufferedConfig(
        waves=2, grad_decay=0.9, latency=jlat, seed=0))
    jlog = jbuf.run(jax.tree.map(jnp.copy, setup["jp"]), steps, taus0.copy())

    tlat = LatencyModel("exp", scale=1.0, seed=3)
    tlat.draw = jlat.draw  # the JAX package's draws, fed to the port
    teng = _engine(setup, cohort, clients=[tsyn.Dataset(x, y) for x, y in rows])
    tbuf = BufferedRoundEngine(teng, setup["p"], BufferedConfig(
        waves=2, grad_decay=0.9, latency=tlat, seed=0))
    tlog = tbuf.run(_t(setup["jp"]), steps, taus0.copy())

    assert len(tlog.rows) == len(jlog.rows) == steps
    for tr, jr in zip(tlog.rows, jlog.rows, strict=True):
        k = tr["round"]
        np.testing.assert_array_equal(tr["cohort"], np.asarray(jr["cohort"]), err_msg=str(k))
        # ages are whole steps: their sum exact (the float32 means may
        # round differently: XLA multiplies by 1/m), their maximum exact
        m = len(tr["cohort"])
        assert round(tr["mean_age"] * m) == round(float(jr["mean_age"]) * m), k
        assert tr["max_age"] == jr["max_age"], k
        assert tr["sim_time"] == jr["sim_time"], k
        np.testing.assert_array_equal(tr["tau"], np.asarray(jr["tau"]), err_msg=str(k))
        assert tr["tau_all"] == jr["tau_all"]
        np.testing.assert_allclose(tr["train_loss"], jr["train_loss"], rtol=1e-5)
    assert max(r["max_age"] for r in tlog.rows) > 0  # stale rows were mixed in
    assert tbuf.wave_dispatches == jbuf.wave_dispatches
    assert tbuf.fold_dispatches == jbuf.fold_dispatches
    for k, v in _t(jlog.params).items():
        np.testing.assert_allclose(_np(tlog.params[k]), np.asarray(v), atol=1e-6, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the scheduler: staleness, backpressure, decay
# ---------------------------------------------------------------------------


def test_staleness_and_liveness(setup):
    buf = BufferedRoundEngine(_engine(setup, 3), setup["p"], BufferedConfig(
        waves=3, grad_decay=0.5, latency=LatencyModel("exp", scale=1.0, seed=3), seed=0))
    steps = 12
    log = buf.run(_t(setup["jp"]), steps, np.full(C, 2, np.int32))
    assert len(log.rows) == steps
    assert all(np.isfinite(r["train_loss"]) for r in log.rows)
    assert max(r["max_age"] for r in log.rows) > 0
    assert buf.wave_dispatches == steps
    times = [r["sim_time"] for r in log.rows]
    assert all(b >= a for a, b in zip(times, times[1:]))
    assert buf.sim_time == times[-1]


def test_fifo_backpressure(setup):
    """Heavy-tailed latency queues several rows of one slot; the per-slot
    FIFO holds them: every commit folds a full buffer and nothing is lost."""
    buf = BufferedRoundEngine(_engine(setup, 3), setup["p"], BufferedConfig(
        waves=4, grad_decay=0.9,
        latency=LatencyModel("hetero", scale=1.0, spread=2.0, seed=5), seed=0))
    steps = 10
    log = buf.run(_t(setup["jp"]), steps, np.full(C, 2, np.int32))
    assert len(log.rows) == steps
    assert buf.fold_dispatches >= steps
    assert any(len(q) for q in buf._fifo) or buf.fold_dispatches > steps
    assert all(np.isfinite(r["train_loss"]) for r in log.rows)


def test_decay_downweights_stale_rows(setup):
    def run(decay):
        return BufferedRoundEngine(_engine(setup, 3), setup["p"], BufferedConfig(
            waves=3, grad_decay=decay, latency=LatencyModel("exp", scale=1.0, seed=3), seed=0)
        ).run(_t(setup["jp"]), 8, np.full(C, 2, np.int32))

    la, lb = run(1.0), run(0.2)
    np.testing.assert_array_equal([r["mean_age"] for r in la.rows],
                                  [r["mean_age"] for r in lb.rows])
    assert not _same_params(la.params, lb.params)


# ---------------------------------------------------------------------------
# the port's latency stream
# ---------------------------------------------------------------------------


def test_latency_stream_invariant_to_cohort_composition():
    for kind in ("uniform", "exp", "hetero"):
        lm = LatencyModel(kind, scale=2.0, spread=0.7, seed=11)
        ids = np.array([3, 17, 42], np.int64)
        counts = np.array([0, 5, 2], np.int64)
        together = lm.draw(ids, counts)
        alone = np.array([lm.draw(np.array([i]), np.array([c]))[0] for i, c in zip(ids, counts)])
        np.testing.assert_array_equal(together, alone)
        perm = np.array([2, 0, 1])
        np.testing.assert_array_equal(lm.draw(ids[perm], counts[perm]), together[perm])
        np.testing.assert_array_equal(
            LatencyModel(kind, scale=2.0, spread=0.7, seed=11).draw(ids, counts), together)
        assert not np.array_equal(lm.draw(ids, counts + 1), together)
        assert not np.array_equal(LatencyModel(kind, scale=2.0, spread=0.7, seed=12)
                                  .draw(ids, counts), together)


def test_latency_kinds_and_validation():
    np.testing.assert_array_equal(LatencyModel("instant").draw(np.arange(4), np.zeros(4)),
                                  np.zeros(4))
    for kind in ("uniform", "exp", "hetero"):
        d = LatencyModel(kind, scale=1.5, seed=0).draw(np.arange(4096), np.zeros(4096, np.int64))
        assert d.dtype == np.float64 and (d >= 0).all() and np.isfinite(d).all()
        if kind == "uniform":
            assert d.max() < 3.0 and abs(d.mean() - 1.5) < 0.05
        if kind == "exp":
            assert abs(d.mean() - 1.5) < 0.1
    lm = LatencyModel("hetero", scale=1.0, spread=1.5, seed=2)
    ids = np.arange(64)
    d0, d1 = lm.draw(ids, np.zeros(64, np.int64)), lm.draw(ids, np.ones(64, np.int64))
    assert np.corrcoef(np.log(d0), np.log(d1))[0, 1] > 0.3  # persistent speed factor
    with pytest.raises(ValueError, match="unknown latency kind"):
        LatencyModel("warp")


def test_buffered_validation(setup):
    eng = _engine(setup, 3)
    with pytest.raises(ValueError, match="waves"):
        BufferedRoundEngine(eng, setup["p"], BufferedConfig(waves=0))
    with pytest.raises(ValueError, match="grad_decay"):
        BufferedRoundEngine(eng, setup["p"], BufferedConfig(grad_decay=0.0))
    with pytest.raises(ValueError, match="controller"):
        BufferedRoundEngine(RoundEngine(setup["tm"].loss, EngineConfig(),
                                        shards=DeviceShards.from_datasets(setup["clients"], device="cpu")),
                            setup["p"])
    with pytest.raises(ValueError, match="device data"):
        BufferedRoundEngine(RoundEngine(setup["tm"].loss, EngineConfig(), num_clients=C,
                                        controller=ControllerCore(ControllerConfig(eta=0.05), C)),
                            setup["p"])
    with pytest.raises(ValueError, match="scaffold"):
        BufferedRoundEngine(_engine(setup, 3, mode="scaffold"), setup["p"])
    # the sanitizer lane is ported (tests/test_torch_sanitize.py runs it)
    lane = BufferedRoundEngine(eng, setup["p"], sanitize=True).sanitizer
    assert lane.label == "buffered-rounds" and not lane.active
    with pytest.raises(ValueError, match="data_path"):
        FederatedSimulator(setup["tm"], setup["clients"],
                           FedSimConfig(buffered=True, data_path="host"))


def test_wave_update_is_the_fused_rounds_client_half(setup):
    """One wave over every client committed at once against the engine's
    own ``run_fused``: the same params and diagnostics, bit for bit."""
    eng = _engine(setup)
    params = _t(setup["jp"])
    cstate = eng.init_controller_state(params, np.full(C, 2, np.int32))
    outs = eng.wave_update(params, cstate.taus, cstate.prev_grad_sqnorm,
                           np.arange(C, dtype=np.int32), key=1234)
    assert sorted(outs) == ["beta", "cum_g", "delta", "g0", "loss0", "tau"]
    assert outs["tau"].tolist() == [2] * C and outs["cum_g"]["w"].shape[0] == C
    fused, _, _, diag = eng.run_fused(params, cstate, setup["p"], key=1234)
    buf = BufferedRoundEngine(eng, setup["p"])
    buf._dev, buf._p = torch.device("cpu"), torch.from_numpy(setup["p"])
    full = dict(outs, ids=torch.arange(C, dtype=torch.int32), age=torch.zeros(C))
    stepped, _, bdiag = buf._step(params, cstate, full)
    assert _same_params(fused, stepped)
    assert torch.equal(diag["train_loss"], bdiag["train_loss"])
    assert torch.equal(diag["tau_next"], bdiag["tau_next"])
