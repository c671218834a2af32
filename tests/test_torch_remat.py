"""Rematerialization (``remat=``) in the port's ``forward`` and ``loss_fn``
against itself and against the JAX package.

``remat=True`` (the default, as in the JAX package) runs each decoder
layer, xLSTM super-block and whisper decoder layer through
``transformer._Remat``, whose backward recomputes the block through
``torch.func.vjp``. Bars:
  * ``remat=True`` against ``remat=False`` under the round's
    ``vmap(grad_and_value)``: gradients and values bitwise equal (the
    recompute runs the same ops on the same inputs);
  * against ``jax.grad`` of the JAX ``loss_fn`` with ``remat=True``:
    tests/test_torch_families.py's bars (loss 2e-4; gradients 1e-5 of each
    leaf's largest entry);
  * the rmsnorm op's forward, counted on its plain version (which the op
    runs exactly where the card launches the kernel): 4L + 1 a gradient
    call under remat, 2L + 1 without it and under ``no_grad``.
Params are carried over from the JAX package with ``repro_torch.bridge``;
inputs are made with numpy from a seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.fedveca import make_round_step
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import format_batch
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models.model import build_model

torch.set_num_threads(2)

# the reduced configs; xLSTM at two super-blocks, so a remat boundary lies
# between blocks of the stack
ARCHS = ["qwen1.5-32b", "granite-moe-1b-a400m", "hymba-1.5b", "xlstm-1.3b", "whisper-medium"]
C, B, S = 3, 2, 12


def _configs(arch):
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if arch == "xlstm-1.3b":
        n = 2 * len(tcfg.xlstm_pattern)
        jcfg, tcfg = dataclasses.replace(jcfg, num_layers=n), dataclasses.replace(tcfg, num_layers=n)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = _configs(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, lead, seed):
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, lead + (S,)).astype(np.int32),
         "targets": r.randint(0, cfg.vocab_size, lead + (S,)).astype(np.int32),
         "loss_mask": (r.rand(*lead, S) < 0.7).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = r.randn(*lead, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32)
    return b


def _np(t):
    return t.detach().float().numpy()


def _vmapped_grads(tm, tp, batch, remat):
    """The round's gradient call: every client's gradient at once."""
    pc = {k: v.expand((C,) + v.shape) for k, v in tp.items()}
    vg = vmap(grad_and_value(lambda p, b: tm.loss(p, b, remat=remat), has_aux=True))
    return vg(pc, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise_equal_to_none_under_vmap(arch):
    _, _, tm, tp = _pair(arch)
    batch = _batch(tm.config, (C, B), seed=31)
    g1, (l1, m1) = _vmapped_grads(tm, tp, batch, True)
    g0, (l0, m0) = _vmapped_grads(tm, tp, batch, False)
    assert sorted(g1) == sorted(g0) == sorted(tp)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    assert torch.equal(l1, l0) and torch.equal(m1["ce"], m0["ce"])
    assert torch.equal(m1["aux"], m0["aux"])
    assert all(bool(g.abs().sum() > 0) for k, g in g1.items() if "b_k" not in k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_jax_grad(arch):
    """Each client's gradient under remat against ``jax.grad`` of the JAX
    ``loss_fn`` with ``remat=True`` on the same client's batch."""
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.config, (C, B), seed=32)
    tg, (tl, _) = _vmapped_grads(tm, tp, batch, True)
    jgv = jax.vmap(jax.value_and_grad(lambda p, b: jm.loss(p, b, remat=True)[0]),
                   in_axes=(None, 0))
    jl, jg = jgv(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = bridge.flatten(jax.tree.map(np.asarray, jg))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for k, v in jg.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        if "b_k" in k:  # 0 in exact arithmetic; float32 noise on both sides
            scale = max(float(np.abs(x).max()) for x in jg.values())
            np.testing.assert_allclose(_np(tg[k]), v, atol=1e-6 * scale, rtol=0, err_msg=k)
            continue
        np.testing.assert_allclose(_np(tg[k]), v, atol=1e-5 * scale, rtol=0, err_msg=k)


def _peak_cpu_bytes(fn):
    """Peak of the bytes allocated on the CPU while ``fn`` runs, from the
    profiler's allocation events (each op's own allocations and frees, in
    time order)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.events() if e.self_cpu_memory_usage),
                    key=lambda e: e.time_range.start)
    cur = peak = 0
    for e in events:
        cur += e.self_cpu_memory_usage
        peak = max(peak, cur)
    return peak


def test_remat_lowers_the_gradient_calls_peak_memory():
    """The point of remat: a vmapped gradient call of a 4-layer decoder at
    S 128 holds one layer's activations at a time, not four. torch.func's
    grad runs the backward with create_graph=True, so a recompute whose
    inputs stayed tracked would record its own backward and keep every
    layer's recomputed activations to the end; that showed as the same
    peak as without remat (99.4 MB against 13.3 here). ``"dots"`` keeps
    the layers' weight products as well, so its peak lies between."""
    cfg = dataclasses.replace(get_arch("qwen1.5-32b").reduced(), num_layers=4)
    tm = build_model(cfg, device="cpu")
    tp = tm.init(0)
    seqs = np.random.RandomState(37).randint(0, cfg.vocab_size, (2, 2, 129)).astype(np.int32)
    batch = format_batch(seqs, device="cpu")
    pc = {k: v.expand((2,) + v.shape) for k, v in tp.items()}
    peaks = {}
    for remat in (False, True, "dots"):
        vg = vmap(grad_and_value(lambda p, b: tm.loss(p, b, remat=remat), has_aux=True))
        peaks[remat] = _peak_cpu_bytes(lambda: vg(pc, batch))
    assert 0 < peaks[True] < 0.5 * peaks[False], peaks
    # "dots" keeps every layer's weight products: between the two
    assert peaks[True] < peaks["dots"] < peaks[False], peaks


def _count_norms(monkeypatch):
    calls = []
    real = rn_ops.ref.rmsnorm
    monkeypatch.setattr(rn_ops.ref, "rmsnorm", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("arch,per_layer", [("qwen1.5-32b", 2), ("hymba-1.5b", 4)])
def test_rmsnorm_forwards_under_remat(monkeypatch, arch, per_layer):
    """A gradient call runs each layer's norms twice (the forward and the
    recompute) and the final norm once: 2kL + 1 against kL + 1 without
    remat, k the layer's norms (Hymba's fusion adds two); the forward
    alone under ``no_grad`` is kL + 1 whatever ``remat`` says."""
    _, _, tm, tp = _pair(arch)
    L = tm.config.num_layers
    calls = _count_norms(monkeypatch)
    batch = _batch(tm.config, (C, B), seed=33)
    for remat, want in ((True, 2 * per_layer * L + 1), (False, per_layer * L + 1)):
        calls.clear()
        _vmapped_grads(tm, tp, batch, remat)
        assert len(calls) == want, remat
        calls.clear()
        with torch.no_grad():
            tm.loss(tp, {k: torch.from_numpy(v[0]) for k, v in batch.items()}, remat=remat)
        assert len(calls) == per_layer * L + 1, remat


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "xlstm-1.3b", "whisper-medium"])
def test_remat_dots_raises_naming_a18_and_bad_values_raise(arch):
    """``remat="dots"`` (each block keeps its weight products, the JAX
    package's ``dots_with_no_batch_dims_saveable``): gradients and values
    bitwise equal to ``remat=True`` under ``vmap(grad_and_value)``, and
    within the families' bars of ``jax.grad`` of the JAX
    ``loss_fn(remat="dots")``; a value other than True, False and "dots"
    still raises."""
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.config, (C, B), seed=34)
    gd, (ld, md) = _vmapped_grads(tm, tp, batch, "dots")
    g1, (l1, m1) = _vmapped_grads(tm, tp, batch, True)
    for k in g1:
        assert torch.equal(gd[k], g1[k]), k
    assert torch.equal(ld, l1) and torch.equal(md["ce"], m1["ce"])
    jgv = jax.vmap(jax.value_and_grad(lambda p, b: jm.loss(p, b, remat="dots")[0]),
                   in_axes=(None, 0))
    jl, jg = jgv(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = bridge.flatten(jax.tree.map(np.asarray, jg))
    np.testing.assert_allclose(_np(ld), np.asarray(jl), atol=2e-4, rtol=2e-4)
    gmax = max(float(np.abs(x).max()) for x in jg.values())
    for k, v in jg.items():
        # b_k: 0 in exact arithmetic, float32 noise on both sides (the bar above)
        tol = 1e-6 * gmax if "b_k" in k else 1e-5 * max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(_np(gd[k]), v, atol=tol, rtol=0, err_msg=k)
    one = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    with pytest.raises(ValueError, match="remat"):
        tm.forward(tp, one, remat="full")
    with pytest.raises(ValueError, match="remat"):
        tm.loss(tp, one, remat=1)


def test_remat_leaves_the_forward_and_the_serving_paths_alone():
    """Values without a gradient: remat True and False give the same
    logits, and prefill (which takes no ``remat``) is unchanged."""
    _, _, tm, tp = _pair("granite-moe-1b-a400m")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.config, (B,), seed=35).items()}
    l1, a1 = tm.forward(tp, batch)
    l0, a0 = tm.forward(tp, batch, remat=False)
    assert torch.equal(l1, l0) and torch.equal(a1, a0)
    logits, _ = tm.prefill(tp, {"tokens": batch["tokens"]})
    torch.testing.assert_close(logits, l0[:, -1], atol=1e-5, rtol=1e-4)


def test_remat_round_bitwise_equal_to_none():
    """``make_round_step`` over the reduced dense LM: the default remat
    against ``remat=False``, params and statistics bit for bit."""
    _, _, tm, tp = _pair("qwen1.5-32b")
    r = np.random.RandomState(36)
    T = 3
    seqs = r.randint(0, tm.config.vocab_size, (C, T, B, S + 1)).astype(np.int32)
    args = (format_batch(seqs, device="cpu"), torch.tensor([3, 2, 1]),
            torch.tensor([0.5, 0.2, 0.3]), torch.tensor(0.3))
    p1, s1, _ = make_round_step(tm.loss, eta=0.05)(tp, *args)
    p0, s0, _ = make_round_step(functools.partial(tm.loss, remat=False), eta=0.05)(tp, *args)
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k
    for f in ("loss0", "beta", "delta", "g0_sqnorm", "update_sqnorm"):
        assert torch.equal(getattr(s1, f), getattr(s0, f)), f


def test_simulator_with_remat_bitwise_equal_to_none():
    """``FederatedSimulator`` on LM token shards: the model's default remat
    against the same model with ``remat=False``, rows and params bit for
    bit."""
    _, _, tm, tp = _pair("qwen1.5-32b")
    vocab = tm.config.vocab_size
    tokens = tsyn.make_lm_tokens(48, 8, vocab, seed=0)
    parts = tpart.partition_iid(len(tokens), 3, seed=0)
    clients = [tsyn.Dataset(tokens.x[s], tokens.y[s]) for s in parts]
    test = tsyn.make_lm_tokens(6, 8, vocab, seed=1)
    cfg = FedSimConfig(rounds=2, tau_max=2, batch_size=2, eta=0.05)
    logs = [FederatedSimulator(m, clients, cfg, test_data=test).run(params=tp)
            for m in (tm, dataclasses.replace(tm, loss=functools.partial(tm.loss, remat=False)))]
    for a, b in zip(*(log.rows for log in logs)):
        np.testing.assert_array_equal(a["tau"], b["tau"])
        assert a["train_loss"] == b["train_loss"] and a["test_loss"] == b["test_loss"]
    for k in tp:
        assert torch.equal(logs[0].params[k], logs[1].params[k]), k
