"""The port's MoE block, selective SSM and xLSTM cells against the JAX
package's, on the same numpy inputs.

MoE: routing (``expert_idx``) and the capacity cut (``keep``) exactly,
against the JAX package's own lines (``moe.py:75-110``) run here in jnp,
since its ``moe_apply`` returns neither; y and the aux loss 1e-5 (float32
sums in another order: the combine sums each token's k contributions
where the JAX package scatter-adds them). Cases: with and without shared
experts, with and without ``token_mask``, with capacity binding (tokens
dropped) and not, with ``num_experts_pad``. The SSM and both xLSTM cells:
outputs and final states 1e-5, from a zero state and from the state the
JAX package's cell leaves after a first segment of the sequence (float32
step recurrences; the JAX package scans the SSM in chunks of 16 with
zero-step padding, which leaves the state as it is).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch, **kw):
    return replace(jax_get_arch(arch).reduced(), **kw), replace(get_arch(arch).reduced(), **kw)


def _params(init, cfg, seed):
    jp = init(jax.random.PRNGKey(seed), cfg, cfg.d_model)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().float().numpy()


def _jax_routing(cfg, p, x, token_mask):
    """``expert_idx`` and the token-order ``keep`` of the JAX package's
    ``moe_apply`` (its lines 75-110, verbatim in jnp)."""
    B, S, d = x.shape
    T, k = B * S, cfg.experts_per_token
    E = cfg.num_experts + cfg.num_experts_pad
    xf = x.reshape(T, d)
    logits = (xf.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
    if cfg.num_experts_pad:
        logits = jnp.pad(logits, ((0, 0), (0, cfg.num_experts_pad)), constant_values=-1e30)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = int(max(1, round(k * T / cfg.num_experts * cfg.capacity_factor)))
    e_flat = expert_idx.reshape(-1)
    if token_mask is not None:
        live_k = jnp.repeat(token_mask.reshape(T), k)
        order = jnp.argsort(e_flat * 2 + (1 - live_k.astype(e_flat.dtype)))
    else:
        live_k, order = None, jnp.argsort(e_flat)
    e_s = e_flat[order]
    counts = jnp.zeros((E,), jnp.int32).at[e_flat].add(1)
    starts = jnp.cumsum(counts) - counts
    keep = jnp.arange(T * k, dtype=jnp.int32) - starts[e_s] < cap
    if live_k is not None:
        keep &= live_k[order]
    keep_tk = jnp.zeros((T * k,), bool).at[order].set(keep).reshape(T, k)
    return np.asarray(expert_idx), np.asarray(keep_tk)


@pytest.mark.parametrize("pad", [0, 2])
@pytest.mark.parametrize("cf", [0.5, 4.0])  # capacity binds (tokens dropped) / not
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])  # shared: no / yes
def test_moe_apply_matches_jax(arch, masked, cf, pad):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, num_experts_pad=pad)
    assert bool(tcfg.num_shared_experts) == (arch == "qwen2-moe-a2.7b")
    jp, tp = _params(jmoe.moe_init, jcfg, seed=3)
    r = np.random.RandomState(4)
    B, S = 3, 10
    x = r.randn(B, S, tcfg.d_model).astype(np.float32)
    mask = (r.rand(B, S) < 0.6) if masked else None
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x),
                              None if mask is None else jnp.asarray(mask))
    ty, taux = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x),
                              None if mask is None else torch.from_numpy(mask))
    want_idx, want_keep = _jax_routing(jcfg, jp, jnp.asarray(x),
                                       None if mask is None else jnp.asarray(mask))
    r_t = tmoe.dispatch(tcfg, tp, torch.from_numpy(x).reshape(B * S, -1),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(r_t.expert_idx.numpy(), want_idx)
    np.testing.assert_array_equal(r_t.keep.numpy(), want_keep)
    assert bool((r_t.expert_idx < tcfg.num_experts).all())  # pad experts never routed
    dropped = (~want_keep).sum() - (0 if mask is None else (~mask).sum() * tcfg.experts_per_token)
    assert (dropped > 0) == (cf < 1)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_moe_apply_vmapped_gradient_is_per_client():
    """The round's use: ``vmap(grad)`` over clients with routing batched per
    client equals each client's own gradient (the scatter is out of place
    and accumulates; a plain ``index_put`` would let a dropped token's zero
    row overwrite the kept token in bucket row 0)."""
    _, cfg = _cfgs("granite-moe-1b-a400m", capacity_factor=0.5)
    _, p = _params(jmoe.moe_init, cfg, seed=5)
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 2, 8, cfg.d_model).astype(np.float32))

    def loss(p, x):
        y, aux = tmoe.moe_apply(cfg, p, x)
        return (y ** 2).mean() + aux

    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p, x)
    for c in range(3):
        one = torch.func.grad(loss)(p, x[c])
        for k in p:
            torch.testing.assert_close(batched[k][c], one[k], atol=1e-6, rtol=1e-5)


def test_moe_two_runs_same_bits_and_router_ignores_tf32_setting():
    _, cfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5)
    _, p = _params(jmoe.moe_init, cfg, seed=7)
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 16, cfg.d_model).astype(np.float32))
    a, _ = tmoe.moe_apply(cfg, p, x)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        b, _ = tmoe.moe_apply(cfg, p, x)
        assert torch.get_float32_matmul_precision() == "high"  # restored after the router
    finally:
        torch.set_float32_matmul_precision(prec)
    assert torch.equal(a, b)


@pytest.mark.parametrize("from_state", [False, True])
def test_ssm_apply_matches_jax(from_state):
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jp, tp = _params(jssm.ssm_init, jcfg, seed=9)
    r = np.random.RandomState(10)
    B, S, d = 2, 37, tcfg.d_model  # not a multiple of the JAX package's chunk of 16
    x = r.randn(B, S, d).astype(np.float32)
    jst = tst = None
    if from_state:
        _, jst = jssm.ssm_apply(jcfg, jp, jnp.asarray(r.randn(B, 19, d).astype(np.float32)))
        tst = tssm.SSMState(*(torch.from_numpy(np.array(a)) for a in jst))
    jy, js = jssm.ssm_apply(jcfg, jp, jnp.asarray(x), jst)
    ty, ts = tssm.ssm_apply(tcfg, tp, torch.from_numpy(x), tst)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(ts.h), np.asarray(js.h), **TOL)
    np.testing.assert_array_equal(_np(ts.conv), np.asarray(js.conv))


def test_softplus_is_jax_softplus_beyond_20():
    x = np.array([-40.0, -3.0, 0.0, 19.5, 20.5, 35.0, 90.0], np.float32)
    np.testing.assert_allclose(_np(tssm.softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("cell", ["m", "s"])
def test_xlstm_cells_match_jax(cell, from_state):
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jinit, japply, tapply, tstate_t = (
        (jxlstm.mlstm_init, jxlstm.mlstm_apply, txlstm.mlstm_apply, txlstm.MLSTMState)
        if cell == "m" else
        (jxlstm.slstm_init, jxlstm.slstm_apply, txlstm.slstm_apply, txlstm.SLSTMState))
    jp, tp = _params(jinit, jcfg, seed=11)
    r = np.random.RandomState(12)
    B, S, d = 2, 21, tcfg.d_model
    x = r.randn(B, S, d).astype(np.float32)
    jst = tst = None
    if from_state:
        _, jst = japply(jcfg, jp, jnp.asarray(r.randn(B, 13, d).astype(np.float32)))
        tst = tstate_t(*(torch.from_numpy(np.array(a)) for a in jst))
    jy, js = japply(jcfg, jp, jnp.asarray(x), jst)
    ty, ts = tapply(tcfg, tp, torch.from_numpy(x), tst)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for name, a, b in zip(js._fields, ts, js):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **TOL)
