"""The port's vecavg plain version against the JAX package's Pallas kernel
(interpret mode), at the shapes of tests/test_kernels.py.

On the CPU the port's ``vecavg``/``vecavg_tree`` take the plain version
(``kernels/vecavg/ref.py``); the CUDA kernel is held against that plain
version on the card in test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances are the JAX package's own kernel-vs-oracle bars
(tests/test_kernels.py): delta_w 1e-6 in float32 and 2e-2 in bf16 (one
bf16 rounding of the output), per-client squared norms rtol 1e-4 (float32
sums taken in another order).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.vecavg import ops as jax_ops
from repro_torch import bridge
from repro_torch.kernels.vecavg import ops, ref

torch.set_num_threads(2)

SHAPES = [(2, 64), (5, 513), (16, 2048), (32, 100)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-6),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(C, D, np_dtype):
    r = np.random.RandomState(C * 100 + D)
    u = r.randn(C, D).astype(np.float32).astype(np_dtype)
    p = (np.abs(r.rand(C)) + 0.1).astype(np.float32)
    return u, p / p.sum()


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("C,D", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vecavg_plain_matches_pallas(C, D, dtype):
    np_dt, j_dt, t_dt, tol = DTYPES[dtype]
    u, p = _inputs(C, D, np_dt)
    dw_j, sqn_j = jax_ops.vecavg(jnp.asarray(u, j_dt), jnp.asarray(p), 0.73, block_d=128)
    dw_t, sqn_t = ops.vecavg(bridge.tensor_from_numpy(u), torch.from_numpy(p), 0.73)
    assert dw_t.dtype == t_dt and dw_t.shape == (D,) and sqn_t.shape == (C,)
    np.testing.assert_allclose(_f32(dw_t), np.asarray(dw_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(sqn_t.numpy(), np.asarray(sqn_j), rtol=1e-4)


@pytest.mark.parametrize("C,D", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vecavg_tree_plain_matches_pallas(C, D, dtype):
    """Leaves of several shapes and both dtypes, one concatenated pass."""
    np_dt, j_dt, t_dt, tol = DTYPES[dtype]
    r = np.random.RandomState(D)
    tree = {"w": r.randn(C, D).astype(np_dt), "b": r.randn(C, 3).astype(np_dt),
            "conv": r.randn(C, 2, 2, 3).astype(np.float32)}
    _, p = _inputs(C, D, np_dt)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    out_j, sqn_j = jax_ops.vecavg_tree(jt, jnp.asarray(p), -0.5, block_d=128)
    out_t, sqn_t = ops.vecavg_tree(bridge.params_from_numpy(tree), torch.from_numpy(p), -0.5)
    assert list(out_t) == sorted(tree)
    for k in tree:
        assert out_t[k].dtype == bridge.tensor_from_numpy(tree[k]).dtype
        assert out_t[k].shape == tree[k].shape[1:]
        np.testing.assert_allclose(_f32(out_t[k]), np.asarray(out_j[k], np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(sqn_t.numpy(), np.asarray(sqn_j), rtol=1e-4)


def test_vecavg_tensor_scale_and_no_launch_on_cpu():
    """A one-element scale tensor works like the number; the CPU path
    never counts a kernel launch."""
    u, p = _inputs(5, 513, np.float32)
    ops.reset_launches()
    a, sa = ops.vecavg(torch.from_numpy(u), torch.from_numpy(p), 0.25)
    b, sb = ops.vecavg(torch.from_numpy(u), torch.from_numpy(p), torch.tensor([0.25]))
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert ops.launches == {"vecavg": 0}
    want, _ = ref.vecavg(torch.from_numpy(u), torch.from_numpy(p), 0.25)
    assert torch.equal(a, want)


def test_vecavg_refuses_non_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version."""
    meta = torch.empty(3, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.vecavg(meta, torch.empty(3, device="meta"), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.vecavg_tree({"w": meta}, torch.empty(3, device="meta"), 1.0)
