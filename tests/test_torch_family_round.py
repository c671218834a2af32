"""The paper's FedVeca round on the MoE, hybrid, xLSTM and VLM families, in
the port against the JAX package (its tests/test_arch_smoke.py runs the
round on granite-moe-1b-a400m and xlstm-1.3b). The VLM round takes
text-only LM batches, as the JAX simulator feeds a VLM; whisper has no
round (the LM batches carry no ``frames``).

The round step, teacher-forced on explicit batches with params carried
over by ``repro_torch.bridge``, at the round-step bars of
tests/test_torch_lm_round.py: tau exact, new params atol 1e-6, beta and
delta rtol 1e-3 (atol 1e-5), loss0 atol 1e-6 (rtol 1e-5), the g0 norms
and the update/params/gradient norms rtol 1e-4, the Eq. 8 global gradient
atol 1e-6. The simulator, free-running from one numpy seed over host
batches: round 0's tau and train loss (rtol 1e-5) against the JAX
package's simulator, and the MoE round launches rmsnorm once a norm call
for all clients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedveca import make_round_step as jax_make_round_step
from repro.data import synthetic as jsyn
from repro.data.device import format_batch as jax_format_batch
from repro.fed.simulator import FederatedSimulator as JaxSimulator
from repro.fed.simulator import FedSimConfig as JaxFedSimConfig
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.core.fedveca import make_round_step
from repro_torch.data import synthetic as tsyn
from repro_torch.data.device import format_batch
from repro_torch.fed import FederatedSimulator, FedSimConfig
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models.model import build_model_by_name as torch_build

torch.set_num_threads(2)


def _pair(arch):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().cpu().numpy()


def _close_tree(t, j, **tol):
    assert sorted(t) == sorted(bridge.flatten(j))
    for k, v in bridge.flatten(j).items():
        np.testing.assert_allclose(_np(t[k]), np.asarray(v), err_msg=k, **tol)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-1.3b", "hymba-1.5b",
                                  "phi-3-vision-4.2b"])
def test_round_step_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    C, T, B, S = 3, 3, 2, 16
    r = np.random.RandomState(1)
    seqs = r.randint(0, jm.config.vocab_size, (C, T, B, S + 1)).astype(np.int32)
    tau = np.array([T, 2, 1], np.int32)
    p = np.array([0.5, 0.2, 0.3], np.float32)
    jstep = jax.jit(jax_make_round_step(jm.loss, tau_max=T, eta=0.05, aggregator="fallback"))
    jparams, jst, _ = jstep(jp, jax_format_batch(jnp.asarray(seqs)), jnp.asarray(tau),
                            jnp.asarray(p), jnp.float32(0.3), None)
    tparams, tst, _ = make_round_step(tm.loss, eta=0.05)(
        tp, format_batch(seqs, device="cpu"), torch.from_numpy(tau), torch.from_numpy(p),
        torch.tensor(0.3), None)
    np.testing.assert_array_equal(_np(tst.tau), np.asarray(jst.tau))
    _close_tree(tparams, jparams, atol=1e-6, rtol=0)
    for f in ("beta", "delta"):
        np.testing.assert_allclose(_np(getattr(tst, f)), np.asarray(getattr(jst, f)),
                                   rtol=1e-3, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(_np(tst.loss0), np.asarray(jst.loss0), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(tst.g0_sqnorm), np.asarray(jst.g0_sqnorm), rtol=1e-4)
    _close_tree(tst.global_grad, jst.global_grad, atol=1e-6, rtol=0)
    for f in ("update_sqnorm", "params_sqnorm", "global_grad_sqnorm"):
        np.testing.assert_allclose(_np(getattr(tst, f)), np.asarray(getattr(jst, f)),
                                   rtol=1e-4, atol=1e-9, err_msg=f)


def test_moe_round_launches_rmsnorm_once_a_norm_call(monkeypatch):
    """What chip_smoke.py's MoE round is held to: tau_max trips of one
    vmapped gradient call each, 4L + 1 norm calls a gradient call under the
    default remat (each layer's two norms run again in its recompute; the
    final norm is not recomputed) and 2L + 1 with ``remat=False`` (the
    router adds none), counted on the plain version, which the op runs
    exactly where the card launches the kernel."""
    _, _, tm, tp = _pair("granite-moe-1b-a400m")
    L = tm.config.num_layers
    calls = []
    real = rn_ops.ref.rmsnorm
    monkeypatch.setattr(rn_ops.ref, "rmsnorm", lambda *a, **k: calls.append(1) or real(*a, **k))
    C, T, B, S = 2, 3, 2, 8
    seqs = np.random.RandomState(2).randint(0, 512, (C, T, B, S + 1)).astype(np.int32)
    for loss, per_call in ((tm.loss, 4 * L + 1),
                           (functools.partial(tm.loss, remat=False), 2 * L + 1)):
        calls.clear()
        make_round_step(loss, eta=0.05)(tp, format_batch(seqs, device="cpu"), torch.tensor([3, 1]),
                                        torch.tensor([0.5, 0.5]), torch.tensor(0.0))
        assert len(calls) == T * per_call


def test_simulator_runs_the_moe_family_like_jax():
    jm, jp, tm, tp = _pair("granite-moe-1b-a400m")
    V, S = jm.config.vocab_size, 16
    clients = [tsyn.make_lm_tokens(16, S, V, topic=i) for i in range(2)]
    test = tsyn.make_lm_tokens(6, S, V, topic=None, seed=99)
    kw = dict(mode="fedveca", rounds=2, tau_max=2, batch_size=2, eta=0.05, data_path="host")
    tlog = FederatedSimulator(tm, clients, FedSimConfig(**kw), test).run(params=tp)
    jlog = JaxSimulator(jm, [jsyn.Dataset(c.x, c.y) for c in clients], JaxFedSimConfig(**kw),
                        jsyn.Dataset(test.x, test.y)).run(params=jax.tree.map(jnp.copy, jp))
    np.testing.assert_array_equal(tlog.rows[0]["tau"], jlog.rows[0]["tau"])
    np.testing.assert_allclose(tlog.rows[0]["train_loss"], jlog.rows[0]["train_loss"],
                               rtol=1e-5)
    assert all(np.isfinite(r["test_loss"]) for r in tlog.rows) and len(tlog.rows) == 2
