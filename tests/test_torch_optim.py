"""The port's optimizers against the JAX package's (``repro.optim``): equal
updates on equal gradients over 50 steps, on a tree of float32 and bf16
leaves.

Bars: float32 leaves rtol 1e-6 (the same float32 operations; XLA and
torch may round ``b ** t`` and the square root in the last bit), bf16
leaves within one bf16 ulp of the JAX package's (each rounds its own
float32 result to bf16); optimizer states rtol 1e-6 and the step count
exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import bridge, optim as toptim

torch.set_num_threads(2)

OPTS = [("sgd", dict(lr=0.1)), ("momentum", dict(lr=0.05, beta=0.9)),
        ("adam", dict(lr=1e-2)), ("adam", dict(lr=1e-2, b1=0.8, b2=0.99, eps=1e-6,
                                               weight_decay=0.1))]


def _tree(r):
    return {"w": r.randn(7, 5).astype(np.float32), "b": r.randn(5).astype(np.float32),
            "e": r.randn(3, 4).astype(ml_dtypes.bfloat16)}


def _ulp_bf16(a):
    a = np.abs(a.astype(np.float32)).clip(2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("name,kw", OPTS)
def test_optimizer_updates_match_jax(name, kw):
    r = np.random.RandomState(0)
    params = _tree(r)
    jopt, topt = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = bridge.params_from_numpy(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(50):
        g = {k: (r.randn(*v.shape) * 0.5).astype(v.dtype) for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.update(bridge.params_from_numpy(g), ts, tp)
    for k, v in jp.items():
        got, want = bridge.tensor_to_numpy(tp[k]), np.asarray(v)
        assert got.dtype == want.dtype, k
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            d = np.abs(got.astype(np.float32) - want.astype(np.float32))
            assert (d <= _ulp_bf16(want)).all(), k
    if name == "momentum":
        for k, v in js.items():
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert int(ts["t"]) == int(js["t"]) == 50
        for part in ("m", "v"):
            for k, v in js[part].items():
                np.testing.assert_allclose(ts[part][k].numpy(), np.asarray(v),
                                           rtol=1e-6, atol=1e-9)


def test_optimizers_descend():
    """tests/test_simulator.py::test_optimizers_descend on the port."""
    def quad(p):
        return ((p["w"] - 3.0) ** 2).sum()

    for opt in (toptim.sgd(0.1), toptim.momentum(0.05), toptim.adam(0.2)):
        params = {"w": torch.zeros(4)}
        state = opt.init(params)
        for _ in range(50):
            params, state = opt.update(torch.func.grad(quad)(params), state, params)
        assert float(quad(params)) < 0.2
