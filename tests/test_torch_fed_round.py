"""The port's federated round, piece by piece, against the JAX package.

Inputs are made with numpy from a seed; params are carried over from the
JAX package with ``repro_torch.bridge``; batches are passed explicitly.
On the CPU the port's kernel reduce takes vecavg's plain version; the JAX
round runs once with ``aggregator="pallas"`` (its Pallas kernel in
interpret mode) and once with ``"fallback"``.

Tolerances and why:
  * copies of numpy-only modules (data, partitions, logger): exactly equal;
  * tree ops: 1e-6 (float32 reductions summed in another order);
  * toy models, loss and grads: atol 1e-5, rtol 1e-4 (the prefill bar of
    test_torch_model.py: float32, different conv/matmul kernels);
  * the round step: new params atol 1e-6 and beta/delta rtol 1e-3, atol
    1e-5, the bars the JAX package holds its own round to against its
    oracle (tests/test_round_engine.py); tau exact; tau_k rtol 1e-6;
    the Eq. 8 global gradient atol 1e-6; SCAFFOLD's control variates
    atol 1e-5, rtol 1e-4 (c_i divides the parameter drift by tau*eta,
    which scales the 1e-6 params bar by up to 1/eta);
  * the controller on identical inputs: tau_next exact, L and alpha_k
    rtol 1e-6 (tests/test_controller_driver.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import tree as jtree
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ControllerCore as JaxControllerCore
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.core.fedveca import RoundStats as JaxRoundStats
from repro.core.fedveca import ScaffoldState as JaxScaffoldState
from repro.core.fedveca import make_round_step as jax_make_round_step
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.data.device import host_stacked_batches as jax_host_batches
from repro.metrics import logger as jlogger
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import tree as ttree
from repro_torch.core.controller import ControllerConfig, ControllerCore, CoreState
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.fedveca import MODES, RoundStats, ScaffoldState, make_round_step
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import host_stacked_batches
from repro_torch.metrics import logger as tlogger
from repro_torch.models.model import build_model_by_name

torch.set_num_threads(2)

TOY = ["svm-mnist", "cnn-mnist", "cnn-cifar10"]


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _t(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree))


def _pair(name):
    jm = jax_build(name)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model_by_name(name, device="cpu"), _t(jp)


def _close_tree(t, j, **tol):
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# copies of the numpy-only modules
# ---------------------------------------------------------------------------


def test_data_and_partition_copies_match_jax():
    for kw in (dict(n=300, input_shape=(784,)), dict(n=200, input_shape=(32, 32, 3),
                                                    sep=0.8, noise=0.5, seed=3)):
        a, b = tsyn.make_classification(**kw), jsyn.make_classification(**kw)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(tsyn.binarize_even_odd(a).y, jsyn.binarize_even_odd(b).y)
    y = jsyn.make_classification(500, (4,), 10, seed=1).y
    for fn, args in (("partition_iid", (500, 7)), ("partition_by_label", (y, 5)),
                     ("partition_by_label", (y, 23)), ("partition_case3", (y, 5)),
                     ("partition_dirichlet", (y, 6, 0.3))):
        got, want = getattr(tpart, fn)(*args, seed=2), getattr(jpart, fn)(*args, seed=2)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tpart.client_weights(got), jpart.client_weights(want))


def test_logger_copy_matches_jax(tmp_path):
    vals = [3.0, 1.5, 9.25, 4.0]
    assert tlogger.latency_summary(vals, "x_") == jlogger.latency_summary(vals, "x_")
    assert tlogger.format_bytes(1536) == jlogger.format_bytes(1536) == "1.5KiB"
    logs = []
    for mod in (tlogger, jlogger):
        log = mod.RunLogger(str(tmp_path / mod.__name__), name="run")
        log.log(round=0, tau=np.array([2, 3], np.int32), loss=np.float32(0.5))
        log.close()
        logs.append((log.rows, (tmp_path / mod.__name__ / "run.jsonl").read_text()))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("name", TOY)
def test_toy_configs_match_jax(name):
    assert get_arch(name).__dict__ == jax_get_arch(name).__dict__


# ---------------------------------------------------------------------------
# tree ops (A2)
# ---------------------------------------------------------------------------


def test_tree_ops_match_jax():
    r = np.random.RandomState(0)
    a = {"w": r.randn(3, 4).astype(np.float32), "b": r.randn(3).astype(np.float32)}
    b = {"w": r.randn(3, 4).astype(np.float32), "b": r.randn(3).astype(np.float32)}
    w = np.float32([0.2, 0.5, 0.3])
    ta, tb = bridge.params_from_numpy(a), bridge.params_from_numpy(b)
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    tol = dict(atol=1e-6, rtol=1e-6)
    _close_tree(ttree.tree_add(ta, tb), jtree.tree_add(ja, jb), **tol)
    _close_tree(ttree.tree_sub(ta, tb), jtree.tree_sub(ja, jb), **tol)
    _close_tree(ttree.tree_scale(ta, 0.3), jtree.tree_scale(ja, 0.3), **tol)
    _close_tree(ttree.tree_axpy(-0.7, ta, tb), jtree.tree_axpy(-0.7, ja, jb), **tol)
    _close_tree(ttree.tree_weighted_sum(ta, torch.from_numpy(w)),
                jtree.tree_weighted_sum(ja, jnp.asarray(w)), **tol)
    _close_tree(ttree.tree_select(torch.tensor(False), ta, tb),
                jtree.tree_select(False, ja, jb), **tol)
    _close_tree(ttree.tree_cast(ta, torch.bfloat16),
                jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jtree.tree_cast(ja, jnp.bfloat16)), **tol)
    _close_tree(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja), **tol)
    for tf, jf in ((ttree.tree_sqnorm, jtree.tree_sqnorm), (ttree.tree_norm, jtree.tree_norm)):
        np.testing.assert_allclose(_np(tf(ta)), np.asarray(jf(ja)), **tol)
    np.testing.assert_allclose(_np(ttree.tree_dot(ta, tb)), np.asarray(jtree.tree_dot(ja, jb)),
                               **tol)
    np.testing.assert_allclose(_np(ttree.tree_sqnorm_per_client(ta)),
                               np.asarray(jax.vmap(jtree.tree_sqnorm)(ja)), **tol)


# ---------------------------------------------------------------------------
# toy models (A3): loss and grads on bridged params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TOY)
def test_toy_model_loss_and_grads_match_jax(name):
    jm, jp, tm, tp = _pair(name)
    assert sorted(tp) == sorted(jp)
    cfg = jm.config
    r = np.random.RandomState(1)
    x = r.randn(4, *cfg.input_shape).astype(np.float32)
    y = r.randint(0, cfg.num_classes, 4).astype(np.int32)
    (jl, jmets), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, dict(x=jnp.asarray(x), y=jnp.asarray(y)))
    g, (tl, tmets) = torch.func.grad_and_value(tm.loss, has_aux=True)(
        tp, dict(x=torch.from_numpy(x), y=torch.from_numpy(y)))
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    assert float(tmets["acc"]) == float(jmets["acc"])
    _close_tree(g, jg, **tol)
    np.testing.assert_allclose(_np(tm.forward(tp, dict(x=torch.from_numpy(x)))),
                               np.asarray(jm.forward(jp, dict(x=jnp.asarray(x)))), **tol)


# ---------------------------------------------------------------------------
# the round step (A4, A5): all five modes on explicit batches
# ---------------------------------------------------------------------------

ROUND_TOL = dict(atol=1e-6, rtol=0)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


def _round_inputs(cfg, C, T, B, seed):
    r = np.random.RandomState(seed)
    batches = dict(x=r.randn(C, T, B, *cfg.input_shape).astype(np.float32),
                   y=r.randint(0, cfg.num_classes, (C, T, B)).astype(np.int32))
    tau = np.array([T, 2, 3][:C], np.int32)
    p = np.array([0.5, 0.2, 0.3][:C], np.float32)
    return batches, tau, p


def _check_round(jout, tout, mode):
    (jp, js, jsc), (tp, ts, tsc) = jout, tout
    _close_tree(tp, jp, **ROUND_TOL)
    np.testing.assert_allclose(_np(ts.beta), np.asarray(js.beta), **STAT_TOL)
    np.testing.assert_allclose(_np(ts.delta), np.asarray(js.delta), **STAT_TOL)
    np.testing.assert_array_equal(_np(ts.tau), np.asarray(js.tau))
    np.testing.assert_allclose(_np(ts.tau_k), np.asarray(js.tau_k), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.loss0), np.asarray(js.loss0), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(ts.g0_sqnorm), np.asarray(js.g0_sqnorm), rtol=1e-4)
    _close_tree(ts.global_grad, js.global_grad, **ROUND_TOL)
    for f in ("update_sqnorm", "params_sqnorm", "global_grad_sqnorm"):
        np.testing.assert_allclose(_np(getattr(ts, f)), np.asarray(getattr(js, f)),
                                   rtol=1e-4, atol=1e-9, err_msg=f)
    if mode == "scaffold":
        _close_tree(tsc.c, jsc.c, atol=1e-5, rtol=1e-4)
        _close_tree(tsc.c_i, jsc.c_i, atol=1e-5, rtol=1e-4)


def _run_both(name, mode, aggregator, C, T, B, seed=0):
    jm, jp, tm, tp = _pair(name)
    batches, tau, p = _round_inputs(jm.config, C, T, B, seed)
    kw = dict(eta=0.01, mode=mode, mu=0.1)
    jscaf = tscaf = None
    if mode == "scaffold":
        r = np.random.RandomState(seed + 1)
        c = {k: 0.01 * r.randn(*np.shape(v)).astype(np.float32) for k, v in jp.items()}
        ci = {k: 0.01 * r.randn(C, *np.shape(v)).astype(np.float32) for k, v in jp.items()}
        jscaf = JaxScaffoldState(c=jax.tree.map(jnp.asarray, c),
                                 c_i=jax.tree.map(jnp.asarray, ci))
        tscaf = ScaffoldState(c=bridge.params_from_numpy(c), c_i=bridge.params_from_numpy(ci))
    jstep = jax.jit(jax_make_round_step(jm.loss, tau_max=T, aggregator=aggregator, **kw))
    jout = jstep(jp, jax.tree.map(jnp.asarray, batches), jnp.asarray(tau), jnp.asarray(p),
                 jnp.float32(0.05), jscaf)
    tstep = make_round_step(tm.loss, aggregator=aggregator, **kw)
    tout = tstep(tp, bridge.params_from_numpy(batches), torch.from_numpy(tau),
                 torch.from_numpy(p), torch.tensor(0.05), tscaf)
    return jout, tout


@pytest.mark.parametrize("aggregator", ["pallas", "fallback"])
@pytest.mark.parametrize("mode", MODES)
def test_svm_round_step_matches_jax(mode, aggregator):
    jout, tout = _run_both("svm-mnist", mode, aggregator, C=3, T=5, B=8)
    _check_round(jout, tout, mode)


@pytest.mark.parametrize("mode,aggregator", [("fedveca", "pallas"), ("fedveca", "fallback"),
                                            ("fedavg", "fallback"), ("fednova", "fallback")])
def test_cnn_round_step_matches_jax(mode, aggregator):
    """The paper's CNN at CIFAR-10 widths: batch 4, tau_max 3, 3 clients."""
    jout, tout = _run_both("cnn-cifar10", mode, aggregator, C=3, T=3, B=4)
    _check_round(jout, tout, mode)


def test_kernel_and_fallback_reduce_agree_in_the_port():
    _, (tk, sk, _) = _run_both("svm-mnist", "fedveca", "auto", C=3, T=5, B=8)
    _, (tf, sf, _) = _run_both("svm-mnist", "fedveca", "fallback", C=3, T=5, B=8)
    for k in tk:
        torch.testing.assert_close(tk[k], tf[k], atol=1e-7, rtol=0)
    assert torch.equal(sk.beta, sf.beta) and torch.equal(sk.delta, sf.delta)


# ---------------------------------------------------------------------------
# the controller (A6) on identical inputs
# ---------------------------------------------------------------------------


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


def _stats_to_torch(js) -> RoundStats:
    f = {k: torch.from_numpy(np.array(v)) for k, v in js._asdict().items()
         if k != "global_grad"}
    return RoundStats(global_grad=_t(js.global_grad), **f)


@pytest.mark.parametrize("alpha", [0.95, 0.8])
def test_controller_matches_jax_on_recorded_stats(alpha):
    """The reference records 10 rounds of its own fused run (SVM, Case 3,
    5 clients, host batches); at every round the port's ControllerCore is
    fed the reference's RoundStats and state, bit for bit."""
    jm = jax_build("svm-mnist")
    orig = jsyn.make_classification(1000, (784,), 10, seed=0)
    train = jsyn.binarize_even_odd(orig)
    clients = [jsyn.Dataset(train.x[s], train.y[s])
               for s in jpart.partition_case3(orig.y, 5, seed=0)]
    C, tau_max = 5, 20
    p = jpart.client_weights([c.y for c in clients])
    cc = dict(eta=0.05, alpha=alpha, tau_max=tau_max)
    jcore = JaxControllerCore(JaxControllerConfig(**cc), C)
    tcore = ControllerCore(ControllerConfig(**cc), C)
    eng = JaxRoundEngine(jm.loss, JaxEngineConfig(eta=0.05, tau_max=tau_max, batch_size=16,
                                                  aggregator="fallback", donate=False),
                         num_clients=C)
    rng = np.random.default_rng(0)
    params = jm.init(jax.random.PRNGKey(0))
    jstate = jcore.init_state(params, np.full(C, 2, np.int32))
    members = jnp.arange(C, dtype=jnp.int32)
    predicted = 0
    for k in range(10):
        taus = jnp.clip(jstate.taus, 1, tau_max)
        params, stats, _ = eng.run_round(params, taus, p, jstate.prev_grad_sqnorm,
                                         batches=jax_host_batches(clients, rng, tau_max, 16))
        tstate, tdiag = tcore.step(_state_to_torch(jstate), _stats_to_torch(stats),
                                   torch.arange(C, dtype=torch.int32),
                                   torch.from_numpy(np.array(taus)))
        jstate, jdiag = jcore.step(jstate, stats, members, taus)
        np.testing.assert_array_equal(_np(tdiag["tau_next"]), np.asarray(jdiag["tau_next"]))
        np.testing.assert_array_equal(_np(tstate.taus), np.asarray(jstate.taus))
        np.testing.assert_allclose(_np(tdiag["L"]), np.asarray(jdiag["L"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tdiag["alpha_k"]), np.asarray(jdiag["alpha_k"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(_np(tdiag["A"]), np.asarray(jdiag["A"]))
        assert int(tstate.round) == int(jstate.round) == k + 1
        predicted += int(k >= 1 and np.any(np.asarray(jdiag["tau_next"]) != 2))
    assert predicted >= 1  # the run left the tau_init passthrough


def test_amin_client_floor_is_19_or_20_and_both_controllers_agree():
    """Why whole-run tau traces are not held exactly across frameworks
    (test_torch_fed_run.py): at alpha = 0.95 the A_min client's ratio
    A_min / (A_min - 0.95 * A_min) is 20 in real arithmetic, and its float32
    floor is 19 or 20 by the last bits of A_min. Both controllers, fed the
    same bits, take the same floor every time."""
    C, eta = 3, 0.05
    cfg = dict(eta=eta, alpha=0.95, tau_max=50)
    tcore = ControllerCore(ControllerConfig(**cfg), C)
    jcore = JaxControllerCore(JaxControllerConfig(**cfg), C)
    zeros = {"w": np.zeros(4, np.float32)}
    jstate = jcore.init_state(zeros, np.full(C, 2, np.int32))._replace(
        round=jnp.int32(1), prev_grad_sqnorm=jnp.float32(1e6), params0_sqnorm=jnp.float32(1.0))
    r = np.random.RandomState(0)
    floors = []
    for _ in range(48):
        beta = np.float32([1.0, 2.0, 3.0]) * np.float32(r.uniform(0.5, 2.0))
        ones = jnp.ones(C, jnp.float32)
        stats = JaxRoundStats(
            loss0=ones, beta=jnp.asarray(beta), delta=ones, g0_sqnorm=ones,
            tau=jnp.full(C, 2, jnp.int32), tau_k=jnp.float32(2.0),
            global_grad=jax.tree.map(jnp.asarray, zeros), update_sqnorm=jnp.float32(1.0),
            params_sqnorm=jnp.float32(1.0), global_grad_sqnorm=jnp.float32(0.0))
        _, jdiag = jcore.step(jstate, stats, jnp.arange(C, dtype=jnp.int32), stats.tau)
        _, tdiag = tcore.step(_state_to_torch(jstate), _stats_to_torch(stats),
                              torch.arange(C, dtype=torch.int32),
                              torch.full((C,), 2, dtype=torch.int32))
        np.testing.assert_array_equal(_np(tdiag["tau_next"]), np.asarray(jdiag["tau_next"]))
        assert float(jdiag["alpha_k"]) == float(np.float32(0.95))  # no Theorem-2 clamp
        floors.append(int(np.asarray(jdiag["tau_next"])[0]))  # client 0 holds A_min
    assert set(floors) == {19, 20}, floors


# ---------------------------------------------------------------------------
# the engine (A8): host batches, run_round == make_round_step
# ---------------------------------------------------------------------------


def test_engine_run_round_matches_jax_engine():
    jm, jp, tm, tp = _pair("svm-mnist")
    orig = tsyn.make_classification(300, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    clients = [tsyn.Dataset(train.x[s], train.y[s])
               for s in tpart.partition_case3(orig.y, 3, seed=0)]
    tb = host_stacked_batches(clients, np.random.default_rng(4), 4, 8, device="cpu")
    jb = jax_host_batches(clients, np.random.default_rng(4), 4, 8)
    np.testing.assert_array_equal(_np(tb["x"]), np.asarray(jb["x"]))
    np.testing.assert_array_equal(_np(tb["y"]), np.asarray(jb["y"]))
    tau, p = np.array([4, 2, 3], np.int32), np.float32([0.4, 0.4, 0.2])
    jeng = JaxRoundEngine(jm.loss, JaxEngineConfig(eta=0.05, tau_max=4, aggregator="pallas",
                                                   donate=False), num_clients=3)
    teng = RoundEngine(tm.loss, EngineConfig(eta=0.05, tau_max=4))
    jout = jeng.run_round(jp, tau, p, 0.1, batches=jb)
    tout = teng.run_round(tp, tau, p, 0.1, batches=tb)
    _check_round(jout, tout, "fedveca")
    for k in tp:  # the caller's params are never modified
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
