"""The engine's wire stage in the port against the JAX package: the
error-feedback residual rows (engine state, keyed by client id under a
cohort), the identity bypass, the lossless limit, SCAFFOLD's refusal and
the byte accounting of the driver's rows (tests/test_wire.py's engine and
simulator contracts).

Inputs are made with numpy from a seed and passed to both engines through
``batches=``; params are carried over with ``repro_torch.bridge``. Bars:
  * identity against none, and lossless top-k against none: bitwise, in
    the port alone (the bypass contract);
  * int8 and top-k rounds against the JAX engine's, teacher-forced: the
    residual rows equal up to float32 rounding but for at most two entries
    a round whose operand sat on a codec boundary (the two frameworks'
    operands differ in the last bits, so an int8 code or a top-k pick may
    take its neighbour), and the params equal to what the residual
    differences imply, within 1e-6 (tests/test_round_engine.py's bar);
  * ``wire_bytes_per_client`` and the rows' ``wire``/``wire_bytes``:
    exactly the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import synthetic as jsyn
from repro.fed.simulator import FederatedSimulator as JaxSimulator
from repro.fed.simulator import FedSimConfig as JaxFedSimConfig
from repro.models.model import build_model_by_name as jax_build
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.models.model import build_model_by_name
from test_torch_fed_run import _np, _t

torch.set_num_threads(2)

C, TAU_MAX, B = 3, 5, 8  # tests/test_wire.py's engine rounds
MODES = ["fedveca", "fednova", "fedavg", "fedprox", "scaffold"]


@pytest.fixture(scope="module")
def svm():
    jm = jax_build("svm-mnist")
    return jm, build_model_by_name("svm-mnist", device="cpu"), jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def round_inputs():
    r = np.random.RandomState(0)
    x = r.randn(C, TAU_MAX, B, 784).astype(np.float32)
    y = r.randint(0, 2, (C, TAU_MAX, B)).astype(np.int32)
    return dict(x=x, y=y), np.array([5, 2, 3], np.int32), np.array([0.5, 0.2, 0.3], np.float32)


def _teng(svm, mode="fedveca", aggregator="fallback", wire="none"):
    return RoundEngine(svm[1].loss, EngineConfig(mode=mode, eta=0.01, tau_max=TAU_MAX,
                                                 aggregator=aggregator, wire=wire),
                       num_clients=C)


def _jeng(svm, wire):
    return JaxRoundEngine(svm[0].loss, JaxEngineConfig(mode="fedveca", eta=0.01, tau_max=TAU_MAX,
                                                       aggregator="fallback", donate=False,
                                                       wire=wire),
                          num_clients=C)


def _tb(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def _run_rounds(eng, params, batches, tau, p, rounds=2):
    scaffold = None
    for _ in range(rounds):
        params, _, scaffold = eng.run_round(params, tau, p, 0.05, batches=_tb(batches),
                                            scaffold=scaffold)
    return params


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("aggregator", ["fallback", "auto"])
def test_identity_wire_bitwise_equal_to_none_every_mode(svm, round_inputs, mode, aggregator):
    batches, tau, p = round_inputs
    base = _run_rounds(_teng(svm, mode, aggregator, "none"), _t(svm[2]), batches, tau, p)
    ident_eng = _teng(svm, mode, aggregator, "identity")
    ident = _run_rounds(ident_eng, _t(svm[2]), batches, tau, p)
    assert not ident_eng.wire_active and ident_eng._wire_res is None
    for k in base:
        assert torch.equal(base[k], ident[k]), k


def test_lossless_topk_equal_to_none(svm, round_inputs):
    """k >= every leaf's size: the fold runs and its residuals stay exactly
    zero, so three rounds equal the rounds without the stage."""
    batches, tau, p = round_inputs
    base = _run_rounds(_teng(svm), _t(svm[2]), batches, tau, p, rounds=3)
    eng = _teng(svm, wire="topk:999999")
    big = _run_rounds(eng, _t(svm[2]), batches, tau, p, rounds=3)
    for k in base:
        assert torch.equal(base[k], big[k]), k
    assert eng.wire_active and all(not v.any() for v in eng._wire_res.values())


def test_scaffold_rejects_lossy_wire(svm):
    for wire in ("int8", "topk:10"):
        with pytest.raises(ValueError, match="wire"):
            _teng(svm, "scaffold", "fallback", wire)


@pytest.mark.parametrize("cohorts", [None, ([0, 2], [1, 2], [0, 1])], ids=["all", "cohorts"])
@pytest.mark.parametrize("wire", ["int8", "topk:50"])
def test_lossy_rounds_and_residual_rows_match_jax(svm, round_inputs, wire, cohorts):
    """Three rounds, each started from the JAX engine's params and residual
    rows (teacher-forced), with the same batches. A client outside the
    round keeps its row bit for bit in both packages, so rows stay keyed
    by client id. A member's row equals the JAX package's up to float32
    rounding except where its operand sat on a codec boundary (an int8
    half step, a top-k magnitude at the cut): there the two decoded rows
    differ by one step, which the residual takes up (decoded + residual is
    the same sum on both sides). Such an entry is one that differs by more
    than 1e-6 plus 1e-3 of its row's largest residual (an int8 step is
    about twice that largest residual, float32 rounding some 1e-5 of it;
    a one-element leaf's int8 residual is rounding alone); at most two a
    round are allowed. The params must differ by exactly what the
    residual differences imply through the FedVeca step, delta(w) = eta *
    tau_k * sum_c pw_c * delta(r_c) / tau_c, within 1e-6, flips or not."""
    batches, tau, p = round_inputs
    jeng, teng = _jeng(svm, wire), _teng(svm, wire=wire)
    assert teng.wire_active and teng._wire_res is None
    jparams, jrows = svm[2], None
    for r in range(3):
        cohort = None if cohorts is None else np.array(cohorts[r], np.int32)
        if jrows is not None:
            teng._wire_res = {k: torch.from_numpy(v.copy()) for k, v in jrows.items()}
        tparams, _, _ = teng.run_round(_t(jparams), tau, p, 0.05, batches=_tb(batches),
                                       cohort=cohort)
        start = {k: np.asarray(v) for k, v in _t(jparams).items()}
        jparams, _, _ = jeng.run_round(jparams, tau, p, 0.05,
                                       batches={k: jnp.asarray(v) for k, v in batches.items()},
                                       cohort=cohort)
        jnew = {k: np.asarray(v) for k, v in _t(jeng._wire_res).items()}
        tnew = {k: _np(v) for k, v in teng._wire_res.items()}
        members = np.arange(C) if cohort is None else cohort
        pw = p[members] / p[members].sum()
        tau_m = tau[members].astype(np.float64)
        tau_k = float((pw * tau_m).sum())
        flips = 0
        for k, want in jnew.items():
            assert tnew[k].shape == want.shape and want.shape[0] == C
            for c in range(C):
                if c not in members:  # untouched, keyed by client id
                    old = np.zeros_like(want[c]) if jrows is None else jrows[k][c]
                    np.testing.assert_array_equal(tnew[k][c], old)
                    np.testing.assert_array_equal(want[c], old)
            scale = np.abs(want).reshape(C, -1).max(1).reshape((C,) + (1,) * (want.ndim - 1))
            flips += int((np.abs(tnew[k] - want) > 1e-6 + 1e-3 * scale).sum())
            implied = sum(0.01 * tau_k * pw[i] * (tnew[k][c] - want[c]).astype(np.float64)
                          / tau_m[i] for i, c in enumerate(members))
            got = _np(tparams[k]).astype(np.float64) - np.asarray(_t(jparams)[k], np.float64)
            np.testing.assert_allclose(got, implied, atol=1e-6, rtol=0, err_msg=f"{r} {k}")
            assert not np.array_equal(start[k], _np(tparams[k]))
        assert flips <= 2, (r, flips)
        jrows = jnew


def test_wire_state_lifecycle_and_byte_accounting(svm, round_inputs):
    batches, tau, p = round_inputs
    params = _t(svm[2])
    for wire in ("int8", "topk:40", "none"):
        teng, jeng = _teng(svm, wire=wire), _jeng(svm, wire)
        assert teng.wire_active == jeng.wire_active == (wire != "none")
        assert teng.wire_codec.name == jeng.wire_codec.name
        assert teng.wire_bytes_per_client(params) == jeng.wire_bytes_per_client(svm[2])
    assert teng.wire_bytes_per_client(params) == sum(v.numel() * 4 for v in params.values())
    eng = _teng(svm, wire="int8")
    assert eng.wire_bytes_per_client(params) == sum(v.numel() + 4 for v in params.values())
    assert eng._wire_res is None  # built at the first round
    eng.run_round(params, tau, p, 0.05, batches=_tb(batches))
    res = eng._wire_res
    for k, v in params.items():
        assert res[k].shape == (C,) + v.shape and res[k].dtype == torch.float32
    assert any(float(v.abs().max()) > 0 for v in res.values())
    eng.reset_wire()
    assert eng._wire_res is None


@pytest.fixture(scope="module")
def clients():
    orig = tsyn.make_classification(1000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    parts = tpart.partition_case3(orig.y, 5, seed=0)
    return ([tsyn.Dataset(train.x[s], train.y[s]) for s in parts],
            [jsyn.Dataset(train.x[s], train.y[s]) for s in parts])


@pytest.mark.parametrize("wire", ["none", "int8", "topk:100"])
@pytest.mark.parametrize("cohort_size", [None, 3])
def test_driver_rows_carry_wire_bytes_as_jax(svm, clients, wire, cohort_size):
    """The simulator's rows: ``wire`` names the codec and ``wire_bytes`` is
    the payload of one client's update times the round's clients, equal
    to the JAX simulator's; int8 rows cost about a quarter of the dense
    ones."""
    base = dict(mode="fedveca", rounds=2, tau_max=4, batch_size=16, eta=0.05,
                data_path="host", wire=wire, cohort_size=cohort_size)
    tlog = FederatedSimulator(svm[1], clients[0], FedSimConfig(**base)).run(params=_t(svm[2]))
    jlog = JaxSimulator(svm[0], clients[1], JaxFedSimConfig(**base)).run(
        params=jax.tree.map(jnp.copy, svm[2]))
    m = 5 if cohort_size is None else cohort_size
    for tr, jr in zip(tlog.rows, jlog.rows, strict=True):
        assert tr["wire"] == jr["wire"] == ("identity" if wire == "none" else wire)
        assert tr["wire_bytes"] == jr["wire_bytes"] > 0
        assert tr["wire_bytes"] % m == 0
    dense = 4 * sum(v.numel() for v in _t(svm[2]).values()) * m
    if wire == "int8":
        assert 3.5 < dense / tlog.rows[0]["wire_bytes"] < 4.05
    if wire == "none":
        assert tlog.rows[0]["wire_bytes"] == dense


def test_simulator_wire_run_matches_jax_rows(svm, clients):
    """A free-running int8 simulator on the host data path: the tau trace of
    the first round and the cohorts equal the JAX package's, and the final
    train loss is within 0.02 (tests/test_torch_fed_run.py's gate 6)."""
    base = dict(mode="fedveca", rounds=3, tau_max=4, batch_size=16, eta=0.05,
                data_path="host", wire="int8", cohort_size=3)
    tlog = FederatedSimulator(svm[1], clients[0], FedSimConfig(**base)).run(params=_t(svm[2]))
    jlog = JaxSimulator(svm[0], clients[1], JaxFedSimConfig(**base)).run(
        params=jax.tree.map(jnp.copy, svm[2]))
    np.testing.assert_array_equal(tlog.rows[0]["tau"], jlog.rows[0]["tau"])
    for tr, jr in zip(tlog.rows, jlog.rows, strict=True):
        np.testing.assert_array_equal(tr["cohort"], jr["cohort"])
        assert np.isfinite(tr["train_loss"])
    assert abs(tlog.rows[-1]["train_loss"] - jlog.rows[-1]["train_loss"]) <= 0.02
