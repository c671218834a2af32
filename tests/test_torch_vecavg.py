"""The port's vecavg plain version against the JAX package's Pallas kernel
(interpret mode), at the shapes of tests/test_kernels.py.

On the CPU the port's ``vecavg``/``vecavg_tree`` take the plain version
(``kernels/vecavg/ref.py``); the CUDA kernel is held against that plain
version on the card in test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances are the JAX package's own kernel-vs-oracle bars
(tests/test_kernels.py): delta_w 1e-6 in float32 and 2e-2 in bf16 (one
bf16 rounding of the output), per-client squared norms rtol 1e-4 (float32
sums taken in another order).

The tree form's ``div`` folds in the JAX package's G = cum_g / tau
(``tree_map(lambda x: x / tau, cum_g)`` before ``vecavg_tree``); on the
CPU the plain version divides first, so a reduce with ``div`` gives the
bits of the reduce on the divided tree.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.vecavg import ops as jax_ops
from repro_torch import bridge
from repro_torch.core.fedveca import make_round_step
from repro_torch.core.strategy import fallback_reduce, kernel_reduce
from repro_torch.core.tree import tree_map
from repro_torch.kernels.vecavg import ops, ref
from repro_torch.models.model import build_model_by_name

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
    """A tensor on a device without a kernel (not the CPU, CUDA or meta)
    never takes the plain version. A meta tensor (the dry run) takes it
    for its shapes and counts the card's launch in ``meta_launches``."""
    from _elsewhere import Elsewhere

    with pytest.raises(ValueError, match="no kernel"):
        ops.vecavg(Elsewhere(3, 8), Elsewhere(3), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.vecavg_tree({"w": Elsewhere(3, 8)}, Elsewhere(3), 1.0)
    ops.reset_launches()
    meta = torch.empty(3, 8, device="meta")
    dw, sqn = ops.vecavg(meta, torch.empty(3, device="meta"), 1.0)
    assert dw.is_meta and dw.shape == (8,) and sqn.shape == (3,)
    ops.vecavg_tree({"w": meta, "e": torch.empty(3, 0, device="meta")},
                    torch.empty(3, device="meta"), 1.0)
    ops.vecavg_tree({"e": torch.empty(3, 0, device="meta")}, torch.empty(3, device="meta"),
                    1.0)  # every leaf empty: the card launches nothing
    assert ops.meta_launches["vecavg"] == 2 and ops.launches["vecavg"] == 0


# The CNN's 8 leaves (cnn-cifar10, D 555178), C 5
CNN_LEAVES = {"b1": (32,), "b2": (32,), "bf1": (256,), "bf2": (10,), "conv1": (5, 5, 3, 32),
              "conv2": (5, 5, 32, 32), "fc1": (2048, 256), "fc2": (256, 10)}
TREES = [("shape", C, D) for C, D in SHAPES] + [("cnn", 5, None)]


def _tree(kind, C, D, np_dt, seed=0):
    """numpy leaves [C, ...], weights p [C] and taus [C] (float32 1..50)."""
    r = np.random.RandomState(seed * 7 + C)
    if kind == "cnn":
        tree = {k: r.randn(C, *s).astype(np.float32).astype(np_dt) for k, s in CNN_LEAVES.items()}
    else:
        tree = {"w": r.randn(C, D).astype(np_dt), "b": r.randn(C, 3).astype(np_dt),
                "conv": r.randn(C, 2, 2, 3).astype(np.float32)}
    p = (np.abs(r.rand(C)) + 0.1).astype(np.float32)
    tau = r.randint(1, 51, C).astype(np.float32)
    return tree, p / p.sum(), tau


def _divide(tree, tau):
    return tree_map(lambda x: x / tau.reshape((-1,) + (1,) * (x.dim() - 1)), tree)


@pytest.mark.parametrize("kind,C,D", TREES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vecavg_tree_div_plain_matches_pallas_on_divided_tree(kind, C, D, dtype):
    """vecavg_tree(cum_g, p, s, div=tau) against the JAX package's
    vecavg_tree(tree_map(x / tau, cum_g), p, s): each leaf divides into the
    promoted dtype (bf16 / float32 -> float32) and is reduced at that
    dtype's bar."""
    np_dt, j_dt, t_dt, _ = DTYPES[dtype]
    tree, p, tau = _tree(kind, C, D, np_dt)
    jtau = jnp.asarray(tau)
    jt = jax.tree.map(lambda x: jnp.asarray(x) / jtau.reshape((-1,) + (1,) * (x.ndim - 1)),
                      {k: jnp.asarray(v) for k, v in tree.items()})
    out_j, sqn_j = jax_ops.vecavg_tree(jt, jnp.asarray(p), 0.235, block_d=128)
    out_t, sqn_t = ops.vecavg_tree(bridge.params_from_numpy(tree), torch.from_numpy(p), 0.235,
                                   div=torch.from_numpy(tau))
    assert list(out_t) == sorted(tree)
    for k in tree:
        assert out_t[k].dtype == torch.float32 and out_t[k].shape == tree[k].shape[1:]
        assert np.asarray(out_j[k]).dtype == np.float32
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(sqn_t.numpy(), np.asarray(sqn_j), rtol=1e-4)


@pytest.mark.parametrize("kind,C,D", TREES)
def test_fallback_and_kernel_reduce_agree_with_div(kind, C, D):
    """The two reduces of core/strategy.py, both with div, on the CPU:
    scale * sum_c w_c (x_c / div_c) and the divided rows' norms."""
    tree, p, tau = _tree(kind, C, D, np.float32, seed=1)
    t, w, d = bridge.params_from_numpy(tree), torch.from_numpy(p), torch.from_numpy(tau)
    scale = torch.tensor(-0.01 * 23.5)
    (out_k, sqn_k), (out_f, sqn_f) = (kernel_reduce(t, w, scale, div=d),
                                      fallback_reduce(t, w, scale, div=d))
    assert list(out_k) == list(out_f)
    for k in out_k:
        torch.testing.assert_close(out_k[k], out_f[k], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(sqn_k, sqn_f, atol=0, rtol=1e-4)


@pytest.mark.parametrize("reduce", [kernel_reduce, fallback_reduce], ids=["kernel", "fallback"])
@pytest.mark.parametrize("kind,C,D", [("shape", 5, 513), ("cnn", 5, None)])
def test_reduce_with_div_is_bitwise_reduce_of_divided_tree(reduce, kind, C, D):
    """reduce(cum_g, p, s, div=tau) == reduce(tree_map(x / tau), p, s)
    exactly on the CPU: the plain versions divide first."""
    tree, p, tau = _tree(kind, C, D, np.float32, seed=2)
    t, w, d = bridge.params_from_numpy(tree), torch.from_numpy(p), torch.from_numpy(tau)
    scale = torch.tensor(-0.05 * 4.0)
    out, sqn = reduce(t, w, scale, div=d)
    want, want_sqn = reduce(_divide(t, d), w, scale)
    assert list(out) == list(want) and torch.equal(sqn, want_sqn)
    assert all(torch.equal(out[k], want[k]) for k in out)


def _parent_reduce(stacked, w, scale, div=None):
    """The reduce as the round called it before ``div``: G = cum_g / tau
    made as a tree, then the tree form on it."""
    if div is not None:
        stacked = _divide(stacked, div)
    return ops.vecavg_tree(stacked, w, -scale)


@pytest.mark.parametrize("mode", ["fedveca", "fednova"])
def test_round_params_bitwise_those_of_dividing_first(mode):
    """A CNN round on the CPU through the kernel reduce (div folded) gives
    the bits of the round that materialises G = cum_g / tau first."""
    model = build_model_by_name("cnn-cifar10", device="cpu")
    params = model.init(0)
    r = np.random.RandomState(3)
    C, T, B = 3, 3, 2
    batches = dict(x=torch.from_numpy(r.randn(C, T, B, 32, 32, 3).astype(np.float32)),
                   y=torch.from_numpy(r.randint(0, 10, (C, T, B)).astype(np.int32)))
    tau = torch.tensor([3, 2, 1], dtype=torch.int32)
    pw = torch.tensor([0.5, 0.2, 0.3])
    outs = [make_round_step(model.loss, eta=0.01, mode=mode, aggregator=agg)(
        params, batches, tau, pw, torch.tensor(0.05)) for agg in ("auto", _parent_reduce)]
    (new, stats, _), (old, old_stats, _) = outs
    assert all(torch.equal(new[k], old[k]) for k in params)
    assert torch.equal(stats.update_sqnorm, old_stats.update_sqnorm)
    assert torch.equal(stats.g0_sqnorm, old_stats.g0_sqnorm)
