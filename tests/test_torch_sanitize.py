"""The port's sanitizer lane (``repro_torch/analysis/sanitize.py``) and the
drivers' ``sanitize=`` lanes.

  * the contract: kernel library builds and loads counted through
    ``kernels.build.load``, allocator segments through
    ``torch.cuda.memory_stats`` (stubbed here: the CPU has none),
    ``mark_steady``/``assert_steady_state``, not reentrant, everything it
    armed restored on exit, ``coerce``/``maybe``; NaN trapped at the aten
    op that makes it and at a kernel wrapper's outputs, ``-inf`` let
    through;
  * a NaN seeded into a round's params raises ``FloatingPointError``;
  * sanitized ``TrainDriver``, ``ServeLoop``, ``PagedServeLoop`` (its
    refcount audit run once a tick), ``BufferedRoundEngine`` and
    ``launch.train --sanitize`` runs are bit for bit the unsanitized ones;
    the sanitized port driver is held against the JAX package's sanitized
    driver at tests/test_torch_fed_run.py's round bars.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro.analysis.sanitize import Sanitizer as JaxSanitizer
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.controller import ControllerCore as JaxControllerCore
from repro.core.driver import TrainDriver as JaxTrainDriver
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import RoundEngine as JaxRoundEngine
from repro.data import synthetic as jsyn
from repro.data.device import host_stacked_batches as jax_host_batches
from repro.models.model import build_model_by_name as jax_build
from repro_torch.analysis import sanitize as san
from repro_torch.analysis.sanitize import Sanitizer, SteadyStateError
from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel
from repro_torch.core.controller import ControllerConfig, ControllerCore
from repro_torch.core.driver import TrainDriver
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import DeviceShards, host_stacked_batches
from repro_torch.kernels import build
from repro_torch.launch.train import main as train_main
from repro_torch.models.model import build_model_by_name
from repro_torch.serve import PagedServeLoop, ServeLoop, poisson_trace
from test_torch_fed_run import _np, _t

torch.set_num_threads(2)

C, TAU_MAX, ETA, BATCH = 5, 8, 0.05, 16


@pytest.fixture(scope="module")
def setup():
    orig = tsyn.make_classification(1000, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    parts = tpart.partition_case3(orig.y, C, seed=0)
    tclients = [tsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    jclients = [jsyn.Dataset(train.x[s], train.y[s]) for s in parts]
    jm = jax_build("svm-mnist")
    p = tpart.client_weights([c.y for c in tclients])
    return dict(tm=build_model_by_name("svm-mnist", device="cpu"), jm=jm,
                jp=jm.init(jax.random.PRNGKey(0)), tclients=tclients, jclients=jclients, p=p)


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _fake_library(monkeypatch, name="fake_kernel"):
    """``build.load`` of a library that needs no nvcc: its build is a stub
    that counts as a build, its load a stub CDLL."""
    monkeypatch.setitem(build.SOURCES, name, "none.cu")
    monkeypatch.setattr(build, "build_all",
                        lambda names: build.events.__setitem__("builds",
                                                               build.events["builds"] + 1))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_target", lambda n: n)
    monkeypatch.delitem(build._loaded, name, raising=False)
    return name


def test_build_counting_mark_and_assert(monkeypatch):
    name = _fake_library(monkeypatch)
    s = Sanitizer(label="t")
    with s:
        build.load(name, {})  # the warm-up builds and loads it: counted, allowed
        assert s.builds == 2 and s.steady_builds == 0
        s.mark_steady()
        build.load(name, {})  # loaded already: nothing happens
        s.assert_steady_state()
        build._loaded.pop(name)
        build.load(name, {})  # a build and a load after warm-up
        assert s.steady_builds == 2
        with pytest.raises(SteadyStateError, match="2 kernel libraries built or loaded"):
            s.assert_steady_state()
    assert (s.builds, s.steady_builds) == (4, 2)  # readable after exit
    with pytest.raises(SteadyStateError, match="without mark_steady"):
        with Sanitizer() as s2:
            s2.assert_steady_state()


def test_new_allocator_segments_after_warmup_fail(monkeypatch):
    stats = {"segment.all.allocated": 7}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: dict(stats))
    with Sanitizer(nan_checks=False) as s:
        stats["segment.all.allocated"] = 9  # the warm-up fills the pool
        s.mark_steady()
        s.assert_steady_state()
        stats["segment.all.allocated"] = 10
        assert (s.segments, s.steady_segments) == (3, 1)
        with pytest.raises(SteadyStateError, match="1 new allocator segment"):
            s.assert_steady_state()


def test_not_reentrant_and_restores_what_it_armed():
    s = Sanitizer(label="x")
    assert _get_current_dispatch_mode() is None and build.output_checks == []
    with s:
        assert s.active and _get_current_dispatch_mode() is not None
        assert len(build.output_checks) == 1
        with pytest.raises(RuntimeError, match="not reentrant"):
            s.__enter__()
        with pytest.raises(FloatingPointError, match=r"aten\.log"):
            torch.log(-torch.ones(3))
    assert not s.active and _get_current_dispatch_mode() is None and build.output_checks == []
    assert torch.isnan(torch.log(-torch.ones(3))).all()  # nothing armed after exit
    with pytest.raises(FloatingPointError):
        with s:  # the instance is reusable once exited; an error still restores
            torch.zeros(2) / torch.zeros(2)
    assert not s.active and _get_current_dispatch_mode() is None and build.output_checks == []


def test_nan_trap_names_the_op_and_the_kernel_and_lets_inf_through():
    nan = torch.tensor([float("nan")])  # made outside: a NaN constant is an op's output too
    with Sanitizer(label="trap"):
        x = torch.tensor([0.0, float("-inf"), 1.0])
        w = torch.softmax(torch.where(x > 0, x, torch.tensor(float("-inf"))), 0)
        assert torch.isinf(torch.log(w)).any()  # -inf is legal
        torch.empty(4)  # uninitialized memory is not looked at
        with pytest.raises(FloatingPointError, match=r"\[trap\] NaN in the output of aten\.sub"):
            x - x
        with pytest.raises(FloatingPointError, match="the vecavg kernel"):
            build.check_outputs("vecavg", torch.ones(2), nan)
        build.check_outputs("vecavg", torch.ones(2), torch.arange(3))  # ints pass
    with Sanitizer(nan_checks=False):
        assert torch.isnan(x - x).any()


def test_card_flags_wait_for_a_flush_and_views_are_not_checked():
    """A CUDA output's flag stays on the card until a flush (every
    FLUSH_EVERY checks, at mark and assert, on exit), which names the first
    flagged op; a view makes no value and is not checked. The card's flags
    are stood in for by CPU ones here."""
    nan = torch.tensor([float("nan")])
    s = Sanitizer(label="defer")
    with s:
        trap = s._trap
        nan.view(1)  # a view: not checked, so no raise
        nan = float("nan")
        trap.flags["cuda:0", torch.float32] = (torch.tensor([0.0, 5.0, nan, nan]), None)
        trap.flags["cuda:0", torch.bfloat16] = (torch.tensor([1.0, nan, 1.0]), None)
        for i, dt in enumerate((torch.bfloat16, torch.float32, torch.bfloat16, torch.float32)):
            trap.pending.append((f"op{i}", dt, (2,), "cuda:0"))
        # the NaN in bf16 slot 1 and float32 slot 2 are old values of slots
        # that belong to the other buffer now: op3 is the first NaN
        with pytest.raises(FloatingPointError, match=r"op3 \(torch.float32 \(2,\) on cuda:0"):
            s.mark_steady()
        assert trap.pending == []
    with pytest.raises(FloatingPointError, match="late"):
        with s:  # exit flushes what is left
            s._trap.flags["cuda:0", torch.float32] = (torch.tensor([float("nan")]), None)
            s._trap.pending.append(("late", torch.float32, (1,), "cuda:0"))
    assert not s.active and _get_current_dispatch_mode() is None
    assert san._is_view(torch.ops.aten.expand.default)
    assert not san._is_view(torch.ops.aten.add_.Tensor)  # in place: a new value


def test_coerce_and_maybe():
    assert san.coerce(None) is None and san.coerce(False) is None
    s = san.coerce(True, label="lbl")
    assert isinstance(s, Sanitizer) and s.label == "lbl"
    assert san.coerce(s) is s
    with san.maybe(None):
        pass
    with san.maybe(s) as got:
        assert got is s and s.active
    assert "tracer_leaks" not in Sanitizer.__init__.__code__.co_varnames


# ---------------------------------------------------------------------------
# the drivers' lanes
# ---------------------------------------------------------------------------


def _engine(setup, cohort=None, shards=False):
    return RoundEngine(
        setup["tm"].loss,
        EngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH, cohort_size=cohort),
        shards=DeviceShards.from_datasets(setup["tclients"], device="cpu") if shards else None,
        num_clients=C, controller=ControllerCore(ControllerConfig(eta=ETA, tau_max=TAU_MAX), C))


def _drive(setup, sanitize, rounds=3, params=None):
    drv = TrainDriver(_engine(setup, shards=True), setup["p"], seed=3, sanitize=sanitize)
    log = drv.run(params if params is not None else _t(setup["jp"]), rounds,
                  np.full(C, 2, np.int32))
    return drv, log


def _same_rows(a, b):
    assert len(a.rows) == len(b.rows)
    for ra, rb in zip(a.rows, b.rows):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(np.asarray(ra[k]), np.asarray(rb[k]), err_msg=k)


def test_seeded_nan_round_raises(setup):
    params = _t(setup["jp"])
    params["w"][3] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        _drive(setup, True, rounds=2, params=params)
    _drive(setup, None, rounds=1, params=params)  # without the lane: nothing raises
    assert _get_current_dispatch_mode() is None


def test_sanitized_train_driver_is_bitwise_the_plain_one(setup):
    plain, lp = _drive(setup, None)
    drv, ls = _drive(setup, True)
    _same_rows(lp, ls)
    for k in lp.params:
        assert torch.equal(lp.params[k], ls.params[k])
    s = drv.sanitizer
    assert not s.active and s.steady_builds == 0 and s.steady_segments == 0


def test_sanitized_driver_matches_the_jax_sanitized_driver(setup):
    """Host batches from one seed in both packages, 2 rounds (round 0 passes
    tau_init through, so round 1 runs the same taus): each round's train
    loss at rtol 1e-5 and the params after it at atol 1e-6, the bars of
    tests/test_torch_fed_run.py's teacher-forced rounds."""
    cc = dict(eta=ETA, alpha=0.95, tau_max=TAU_MAX)
    jeng = JaxRoundEngine(setup["jm"].loss,
                          JaxEngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH,
                                          donate=False),
                          num_clients=C, controller=JaxControllerCore(JaxControllerConfig(**cc), C))
    jdrv = JaxTrainDriver(jeng, setup["p"], seed=3, sanitize=JaxSanitizer(label="jax"),
                          batches_fn=lambda rng: jax_host_batches(setup["jclients"], rng,
                                                                  TAU_MAX, BATCH))
    jlog = jdrv.run(setup["jp"], 2, np.full(C, 2, np.int32))
    tdrv = TrainDriver(
        RoundEngine(setup["tm"].loss, EngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH),
                    controller=ControllerCore(ControllerConfig(**cc), C)),
        setup["p"], seed=3, sanitize=True,
        batches_fn=lambda rng: host_stacked_batches(setup["tclients"], rng, TAU_MAX, BATCH,
                                                    device="cpu"))
    tlog = tdrv.run(_t(setup["jp"]), 2, np.full(C, 2, np.int32))
    assert jdrv.sanitizer.steady_compiles == 0 and tdrv.sanitizer.steady_builds == 0
    for jr, tr in zip(jlog.rows, tlog.rows):
        np.testing.assert_allclose(tr["train_loss"], jr["train_loss"], rtol=1e-5)
    np.testing.assert_array_equal(tlog.rows[0]["tau"], jlog.rows[0]["tau"])
    for k in jlog.params:
        np.testing.assert_allclose(_np(tlog.params[k]), np.asarray(jlog.params[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_sanitized_buffered_engine_is_bitwise_the_plain_one(setup):
    def run(sanitize):
        buf = BufferedRoundEngine(
            _engine(setup, cohort=3, shards=True), setup["p"],
            BufferedConfig(waves=2, grad_decay=0.9, latency=LatencyModel("exp", seed=1),
                           seed=4),
            sanitize=sanitize)
        return buf, buf.run(_t(setup["jp"]), 4, np.full(C, 2, np.int32))

    _, lp = run(None)
    buf, ls = run(True)
    _same_rows(lp, ls)
    for k in lp.params:
        assert torch.equal(lp.params[k], ls.params[k])
    assert buf.sanitizer.steady_builds == 0 and not buf.sanitizer.active


def _serve_trace():
    return poisson_trace(6, rate=2.0, plen_choices=(8, 12), max_new_choices=(3, 5),
                         vocab_size=512, seed=2)


@pytest.mark.parametrize("paged", [False, True])
def test_sanitized_serve_loops_are_bitwise_the_plain_ones(paged, monkeypatch):
    model = build_model_by_name("qwen1.5-32b", reduced=True, device="cpu")
    params = model.init(0)
    cls = PagedServeLoop if paged else ServeLoop
    kw = dict(device="cpu", n_slots=4, capacity=32)
    plain_reqs, san_reqs = _serve_trace(), _serve_trace()
    plain = cls(model, params, **kw).run(plain_reqs)
    audits = []
    if paged:
        orig = PagedServeLoop.check_invariants
        monkeypatch.setattr(PagedServeLoop, "check_invariants",
                            lambda self: (audits.append(self.t), orig(self))[1])
    loop = cls(model, params, sanitize=True, **kw)
    stats = loop.run(san_reqs)
    assert [r.out for r in san_reqs] == [r.out for r in plain_reqs]
    for k in ("ticks", "tokens", "decode_dispatches", "prefill_dispatches"):
        assert stats[k] == plain[k], k
    assert loop.sanitizer.steady_builds == 0 and not loop.sanitizer.active
    if paged:  # once a tick, in both passes (the warm-up's and the measured one's)
        assert len(audits) == 2 * stats["ticks"]


def test_launcher_sanitize_is_bitwise_the_plain_run():
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu", "--rounds", "3",
            "--seq", "16", "--batch-per-client", "2"]
    plain, sanitized = train_main(args), train_main(args + ["--sanitize"])
    assert len(plain) == len(sanitized) == 3
    for a, b in zip(plain, sanitized):
        for k in ("train_loss", "tau", "tau_k", "beta", "delta"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
