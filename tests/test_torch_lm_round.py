"""Federated LM training in the port against the JAX package, on the CPU.

The models are the JAX example's ``--preset tiny`` (examples/
train_lm_federated.py: StarCoder2 family, layernorm, 4 layers, d_model 256,
vocab 2048) and its Qwen1.5-family twin at the same widths (rmsnorm, so the
round differentiates through ``kernels/rmsnorm``'s op and its vmap rule).
Params are carried over with ``repro_torch.bridge``; batches are passed
explicitly or drawn by both packages' ``host_stacked_batches`` from one
numpy seed; token data comes from both packages' ``make_lm_tokens``.

Tolerances and why:
  * data copies (``make_lm_tokens``, ``lm_batch``, ``format_batch``):
    exactly equal;
  * the round step, teacher-forced on explicit batches: the round-step
    bars of test_torch_fed_round.py (new params atol 1e-6; beta and delta
    rtol 1e-3, atol 1e-5; tau exact; loss0 atol 1e-6, rtol 1e-5; g0 norms
    and the update/params/gradient norms rtol 1e-4; the Eq. 8 global
    gradient atol 1e-6);
  * the free-running simulator (gate 6 of test_torch_fed_run.py): the
    fedveca tau trace exact up to and including the first round with an
    excused entry, the final test loss within 0.02. An entry is excused
    when the reference ratio A_i / (A_i - alpha_k * A_min) lies within 1e-3
    (relative) of an integer that the tau_max clip does not settle: the two
    frameworks' float32 sums may floor it either way;
  * the evaluator and ``FederatedSimulator.evaluate``: rtol 1e-5 (float32
    means over other reduction orders).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.driver import make_dataset_evaluator as jax_evaluator
from repro.core.fedveca import make_round_step as jax_make_round_step
from repro.data import synthetic as jsyn
from repro.data.device import format_batch as jax_format_batch
from repro.data.device import host_stacked_batches as jax_host_batches
from repro.fed.simulator import FederatedSimulator as JaxSimulator
from repro.fed.simulator import FedSimConfig as JaxFedSimConfig
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.driver import make_dataset_evaluator
from repro_torch.core.fedveca import make_round_step
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import DeviceShards, format_batch, host_stacked_batches
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.fed import train_lm
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
NEAR_INT = 1e-3


def _example_lm_config(preset):
    spec = importlib.util.spec_from_file_location(
        "train_lm_federated_example", ROOT / "examples" / "train_lm_federated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lm_config(preset)


def _qwen_twin(get):
    """The tiny preset's widths on the Qwen1.5 family (rmsnorm, tied)."""
    return dataclasses.replace(
        get("qwen1.5-32b"), name="qwen1.5-tiny", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32")


def _configs(which):
    if which == "tiny":
        return _example_lm_config("tiny"), train_lm.lm_config("tiny")
    return _qwen_twin(jax_get_arch), _qwen_twin(get_arch)


def _pair(which):
    jcfg, tcfg = _configs(which)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().cpu().numpy()


def _close_tree(t, j, **tol):
    assert sorted(t) == sorted(bridge.flatten(j))
    for k, v in bridge.flatten(j).items():
        np.testing.assert_allclose(_np(t[k]), np.asarray(v), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# copies and the data path (C4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "100m"])
def test_lm_presets_are_the_examples(preset):
    assert train_lm.lm_config(preset).__dict__ == _example_lm_config(preset).__dict__


def test_make_lm_tokens_and_lm_batch_match_jax():
    for kw in (dict(topic=2, seed=0), dict(topic=None, seed=99), dict(topic=11, seed=3,
                                                                    n_topics=4)):
        a = tsyn.make_lm_tokens(9, 12, 300, **kw)
        b = jsyn.make_lm_tokens(9, 12, 300, **kw)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        idx = np.array([3, 0, 8])
        for k, v in tsyn.lm_batch(a, idx).items():
            np.testing.assert_array_equal(v, jsyn.lm_batch(b, idx)[k])


def test_format_batch_matches_jax_for_tokens_and_vision():
    r = np.random.RandomState(0)
    toks = r.randint(0, 50, (3, 2, 9)).astype(np.int32)
    x, y = r.randn(3, 2, 5).astype(np.float32), r.randint(0, 4, (3, 2)).astype(np.int32)
    for args in ((toks,), (toks.astype(np.int64),), (x, y)):
        got, want = format_batch(*args, device="cpu"), jax_format_batch(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == (torch.int32 if want[k].dtype == jnp.int32 else torch.float32)
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    t = format_batch(torch.from_numpy(toks), device="cpu")
    np.testing.assert_array_equal(_np(t["targets"]), toks[..., 1:])


def test_token_shards_and_host_batches_carry_lm_data():
    clients = [tsyn.make_lm_tokens(n, 10, 64, topic=i) for i, n in enumerate((7, 4))]
    shards = DeviceShards.from_datasets(clients, device="cpu")
    assert shards.y is None and shards.sizes == [7, 4]
    b = shards.sample(key=5, tau_max=3, batch=6)
    assert sorted(b) == ["targets", "tokens"] and b["tokens"].shape == (2, 3, 6, 10)
    assert b["tokens"].dtype == torch.int32
    for c, d in enumerate(clients):  # every drawn row is a row of its own client
        rows = {tuple(s) for s in d.x}
        for seq_in, seq_out in zip(_np(b["tokens"][c]).reshape(-1, 10),
                                   _np(b["targets"][c]).reshape(-1, 10)):
            assert tuple(np.concatenate([seq_in, seq_out[-1:]])) in rows
    jclients = [jsyn.Dataset(c.x, c.y) for c in clients]
    th = host_stacked_batches(clients, np.random.default_rng(1), 3, 2, device="cpu")
    jh = jax_host_batches(jclients, np.random.default_rng(1), 3, 2)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(_np(th[k]), np.asarray(jh[k]))


# ---------------------------------------------------------------------------
# the round step, teacher-forced
# ---------------------------------------------------------------------------


def _round_inputs(vocab, C, T, B, S, seed):
    r = np.random.RandomState(seed)
    seqs = r.randint(0, vocab, (C, T, B, S + 1)).astype(np.int32)
    tau = np.array([T, 2, 1][:C], np.int32)
    p = np.array([0.5, 0.2, 0.3][:C], np.float32)
    return seqs, tau, p


@pytest.mark.parametrize("which", ["tiny", "qwen-twin"])
def test_lm_round_step_matches_jax(which):
    jm, jp, tm, tp = _pair(which)
    C, T, B, S = 3, 3, 2, 16
    seqs, tau, p = _round_inputs(jm.config.vocab_size, C, T, B, S, seed=1)
    jstep = jax.jit(jax_make_round_step(jm.loss, tau_max=T, eta=0.05, aggregator="fallback"))
    js = jstep(jp, jax_format_batch(jnp.asarray(seqs)), jnp.asarray(tau), jnp.asarray(p),
               jnp.float32(0.3), None)
    tstep = make_round_step(tm.loss, eta=0.05)
    ts = tstep(tp, format_batch(seqs, device="cpu"), torch.from_numpy(tau), torch.from_numpy(p),
               torch.tensor(0.3), None)
    (jparams, jst, _), (tparams, tst, _) = js, ts
    _close_tree(tparams, jparams, atol=1e-6, rtol=0)
    for f in ("beta", "delta"):
        np.testing.assert_allclose(_np(getattr(tst, f)), np.asarray(getattr(jst, f)),
                                   rtol=1e-3, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(_np(tst.tau), np.asarray(jst.tau))
    np.testing.assert_allclose(_np(tst.tau_k), np.asarray(jst.tau_k), rtol=1e-6)
    np.testing.assert_allclose(_np(tst.loss0), np.asarray(jst.loss0), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(tst.g0_sqnorm), np.asarray(jst.g0_sqnorm), rtol=1e-4)
    _close_tree(tst.global_grad, jst.global_grad, atol=1e-6, rtol=0)
    for f in ("update_sqnorm", "params_sqnorm", "global_grad_sqnorm"):
        np.testing.assert_allclose(_np(getattr(tst, f)), np.asarray(getattr(jst, f)),
                                   rtol=1e-4, atol=1e-9, err_msg=f)


def test_rmsnorm_forward_runs_once_a_norm_call_in_the_round(monkeypatch):
    """The launch count the card is held to: tau_max trips of one vmapped
    gradient call each, 4L + 1 norm calls a gradient call under the default
    remat (each layer's two norms run again in its recompute; the final
    norm is not recomputed) and 2L + 1 with ``remat=False``, one forward
    each for all clients (the op's vmap rule). Counted here on the plain
    version, which the op runs exactly where the card launches the kernel;
    the evaluation, under ``no_grad``, stays at 2L + 1 a chunk."""
    _, _, tm, tp = _pair("qwen-twin")
    L = tm.config.num_layers
    calls = []
    real = rn_ops.ref.rmsnorm
    monkeypatch.setattr(rn_ops.ref, "rmsnorm", lambda *a, **k: calls.append(1) or real(*a, **k))
    C, T, B, S = 3, 3, 2, 8
    seqs, tau, p = _round_inputs(tm.config.vocab_size, C, T, B, S, seed=2)
    for loss, per_call in ((tm.loss, 4 * L + 1),
                           (functools.partial(tm.loss, remat=False), 2 * L + 1)):
        calls.clear()
        make_round_step(loss, eta=0.05)(tp, format_batch(seqs, device="cpu"), torch.from_numpy(tau),
                                        torch.from_numpy(p), torch.tensor(0.0))
        assert len(calls) == T * per_call
    calls.clear()
    test = tsyn.make_lm_tokens(5, S, tm.config.vocab_size)
    make_dataset_evaluator(tm.loss, test, max_batch=2, device="cpu")(tp)  # chunks of 2, 2, then 1
    assert len(calls) == 3 * (2 * L + 1)


# ---------------------------------------------------------------------------
# the evaluator and the simulator
# ---------------------------------------------------------------------------


def test_lm_evaluators_match_jax():
    jm, jp, tm, tp = _pair("tiny")
    test = tsyn.make_lm_tokens(7, 12, jm.config.vocab_size, topic=None, seed=99)
    jtest = jsyn.Dataset(test.x, test.y)
    jv = float(jax_evaluator(jm.loss, jtest, max_batch=3)(jp)["test_loss"])
    tv = make_dataset_evaluator(tm.loss, test, max_batch=3, device="cpu")(tp)
    assert sorted(tv) == ["test_loss"]
    np.testing.assert_allclose(float(tv["test_loss"]), jv, rtol=1e-5)
    sim = FederatedSimulator(tm, [test, test], FedSimConfig(tau_max=2, batch_size=2), test)
    jsim = JaxSimulator(jm, [jtest, jtest], JaxFedSimConfig(tau_max=2, batch_size=2), jtest)
    got, want = sim.evaluate(tp, max_batch=3), jsim.evaluate(jp, max_batch=3)
    assert sorted(got) == sorted(want) == ["test_loss"]
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-5)


def _excused(A, alpha_k, tau_max, eps=1e-12):
    A = np.maximum(np.asarray(A, np.float64), eps)
    ratio = A / (A - float(alpha_k) * A.min())
    near = np.abs(ratio - np.round(ratio)) <= NEAR_INT * np.abs(ratio)
    return near & (np.round(ratio) - 1 < tau_max)


def test_free_running_lm_fedveca_matches_jax():
    """Gate 6 on the tiny preset: 3 clients of one topic each, host batches
    from one numpy seed, 5 rounds with evaluation every round."""
    jm, jp, tm, tp = _pair("tiny")
    V, S = jm.config.vocab_size, 16
    clients = [tsyn.make_lm_tokens(24, S, V, topic=i) for i in range(3)]
    test = tsyn.make_lm_tokens(8, S, V, topic=None, seed=99)
    kw = dict(mode="fedveca", rounds=5, tau_max=3, batch_size=2, eta=0.05, data_path="host")
    tlog = FederatedSimulator(tm, clients, FedSimConfig(**kw), test).run(params=tp)
    jlog = JaxSimulator(jm, [jsyn.Dataset(c.x, c.y) for c in clients], JaxFedSimConfig(**kw),
                        jsyn.Dataset(test.x, test.y)).run(params=jax.tree.map(jnp.copy, jp))
    compared = 0
    for jr, tr in zip(jlog.rows, tlog.rows):
        assert "test_acc" not in tr
        np.testing.assert_array_equal(tr["tau"], jr["tau"], err_msg=f"round {jr['round']}")
        compared += 1
        if jr["round"] >= 1 and _excused(jr["A"], jr["alpha_k"], kw["tau_max"]).any():
            break
    print(f"free-running LM fedveca: tau trace equal over {compared} of 5 rounds")
    assert compared >= 2
    np.testing.assert_allclose(tlog.rows[0]["train_loss"], jlog.rows[0]["train_loss"], rtol=1e-5)
    assert abs(tlog.rows[-1]["test_loss"] - jlog.rows[-1]["test_loss"]) <= 0.02
    assert tlog.rows[-1]["train_loss"] < tlog.rows[0]["train_loss"]


def test_train_lm_entry_point_runs_resumes_and_refuses_cohorts(tmp_path, capsys, monkeypatch):
    argv = ["--device", "cpu", "--preset", "tiny", "--clients", "2", "--seq", "16",
            "--batch", "2", "--tau-max", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_lm.main(argv + ["--rounds", "1"])
    out = capsys.readouterr().out
    assert out.startswith("model=starcoder2-10m params~") and "[round    1] train_ce=" in out
    assert out.rstrip().endswith("done.")
    assert (tmp_path / "last" / "manifest.json").exists()
    train_lm.main(argv + ["--rounds", "2"])
    out = capsys.readouterr().out
    assert "resumed from round 1" in out and "[round    2]" in out
    # one client a round
    train_lm.main(argv + ["--rounds", "3", "--cohort", "1"])
    out = capsys.readouterr().out
    assert "resumed from round 2" in out and "[round    3]" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):  # the card by default, never the CPU
        train_lm.main(["--rounds", "1"])
