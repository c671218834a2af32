"""The port's rmsnorm (``kernels/rmsnorm``) against the JAX package, on the
CPU, where the op runs its plain version (``ref.py``).

Tolerances and why:
  * the plain version against the Pallas kernel in interpret mode, at
    tests/test_kernels.py's shapes: float32 atol 1e-5, the JAX test's bar.
    In bf16 each side rounds its own float32 result; torch and XLA sum the
    squares in other orders, so the float32 results may differ in the last
    bit and, rarely, round to neighbouring bf16 values. The bf16 bar is
    one bf16 ulp of the output, on at most 1e-4 of the elements, and
    equality everywhere else;
  * the op's gradient against ``jax.grad`` of the JAX package's
    ``layers.rmsnorm`` (XLA's autodiff of the plain formula): atol 1e-5,
    rtol 1e-4 (float32, the formula's terms in another order);
  * ``torch.func.vmap(grad_and_value)`` through the op against a loop over
    clients in the port: 1e-6 (the vmap rule folds the clients into one
    grouped call; each row's arithmetic is the same, summed in tensors of
    another shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.models import layers as jlayers
from repro_torch.kernels.rmsnorm import ops, ref
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)

SHAPES = [(4, 7, 128), (1000, 256), (3, 64)]  # tests/test_kernels.py::test_rmsnorm_matches_ref


def _inputs(shape):
    r = np.random.RandomState(sum(shape))
    return r.randn(*shape).astype(np.float32), (r.randn(shape[-1]) * 0.1).astype(np.float32)


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_f32(shape):
    x, s = _inputs(shape)
    o = np.asarray(rmsnorm_pallas(jnp.asarray(x), jnp.asarray(s), interpret=True))
    t = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert t.dtype == torch.float32 and t.shape == shape
    np.testing.assert_allclose(t.numpy(), o, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_bf16(shape):
    x, s = _inputs(shape)
    o = np.asarray(rmsnorm_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                                  interpret=True), np.float32)
    t = ref.rmsnorm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s))
    assert t.dtype == torch.bfloat16
    t = t.float().numpy()
    diff = np.abs(t - o)
    assert np.all(diff <= _bf16_ulp(o))
    assert np.count_nonzero(diff) <= 1e-4 * diff.size


def test_op_and_layers_rmsnorm_equal_the_plain_formula_on_cpu():
    """On a CPU tensor the op computes the formula the port's
    ``layers.rmsnorm`` computed before it called the op, bit for bit, so
    every CPU parity test of the dense models keeps its result."""
    x, s = _inputs((5, 9, 96))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    xf = xt.float()
    want = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) * (1.0 + st))
    assert torch.equal(ops.rmsnorm(xt, st), want)
    assert torch.equal(tlayers.rmsnorm(xt, st), want)
    assert torch.equal(ops.rmsnorm(xt, st, use_pallas=False), want)
    np.testing.assert_allclose(tlayers.rmsnorm(xt, st).numpy(),
                               np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_gradient_matches_jax_grad(dtype):
    r = np.random.RandomState(3)
    x = r.randn(5, 6, 64).astype(np.float32)
    s = (r.randn(64) * 0.1).astype(np.float32)
    w = r.randn(5, 6, 64).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jloss(x, s):
        return jnp.sum(jlayers.rmsnorm(x, s).astype(jnp.float32) * w)

    jgx, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(s))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    (ops.rmsnorm(xt, st).float() * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == dtype and st.grad.dtype == torch.float32
    if dtype == torch.float32:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), atol=1e-5, rtol=1e-4)
    else:  # both round dx to bf16 from float32 values that agree to ~1e-6
        np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jgx, np.float32),
                                   atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), atol=1e-3, rtol=1e-3)


def test_op_gradient_matches_autograd_of_the_plain_version():
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(7, 33).astype(np.float32)).requires_grad_()
    s = torch.from_numpy((r.randn(33) * 0.1).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(r.randn(7, 33).astype(np.float32))
    gk = torch.autograd.grad((ops.rmsnorm(x, s) * w).sum(), (x, s))
    gp = torch.autograd.grad((ops.rmsnorm(x, s, use_pallas=False) * w).sum(), (x, s))
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def _loss(s, x, w):
    return (ops.rmsnorm(x, s) * w).sum()


def test_vmap_grad_with_per_client_scale_matches_a_client_loop():
    """The round's use: scale and x batched over C clients."""
    r = np.random.RandomState(5)
    C = 3
    x = torch.from_numpy(r.randn(C, 4, 5, 32).astype(np.float32))
    s = torch.from_numpy((r.randn(C, 32) * 0.1).astype(np.float32))
    w = torch.from_numpy(r.randn(C, 4, 5, 32).astype(np.float32))
    (gs, gx), v = torch.func.vmap(torch.func.grad_and_value(_loss, argnums=(0, 1)))(s, x, w)
    for c in range(C):
        (gsc, gxc), vc = torch.func.grad_and_value(_loss, argnums=(0, 1))(s[c], x[c], w[c])
        torch.testing.assert_close(gs[c], gsc, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(gx[c], gxc, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(v[c], vc, atol=1e-6, rtol=1e-6)


def test_vmap_grad_over_one_client_matches_the_plain_call():
    """A batch of one client (one client a rank of a sharded round): the
    rule hands the op the client's scale as every row's, one call."""
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(1, 2, 16, 64).astype(np.float32))
    s = torch.from_numpy((r.randn(1, 64) * 0.1).astype(np.float32))
    w = torch.from_numpy(r.randn(1, 2, 16, 64).astype(np.float32))
    (gs, gx), v = torch.func.vmap(torch.func.grad_and_value(_loss, argnums=(0, 1)))(s, x, w)
    (gs0, gx0), v0 = torch.func.grad_and_value(_loss, argnums=(0, 1))(s[0], x[0], w[0])
    torch.testing.assert_close(gs[0], gs0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gx[0], gx0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(v[0], v0, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("in_dims", [(0, None, 0), (None, 0, 0), (1, 2, 2)])
def test_vmap_rule_takes_every_mix_of_batched_inputs(in_dims):
    """scale unbatched (x's batch dim becomes more rows), x unbatched (it is
    expanded to the clients), and batch dims that are not leading."""
    r = np.random.RandomState(6)
    C, d = 3, 16
    sd, xd, wd = in_dims
    s = torch.from_numpy((r.randn(*([C, d] if sd == 0 else [d, C] if sd == 1 else [d]))
                          * 0.1).astype(np.float32))
    xshape, wshape = [4, 5, d], [4, 5, d]
    if xd is not None:
        xshape.insert(xd, C)
    wshape.insert(wd, C)
    x = torch.from_numpy(r.randn(*xshape).astype(np.float32))
    w = torch.from_numpy(r.randn(*wshape).astype(np.float32))
    (gs, gx), v = torch.func.vmap(torch.func.grad_and_value(_loss, argnums=(0, 1)),
                                  in_dims=(sd, xd, wd))(s, x, w)
    for c in range(C):
        sc = s if sd is None else s.select(sd, c)
        xc = x if xd is None else x.select(xd, c)
        (gsc, gxc), vc = torch.func.grad_and_value(_loss, argnums=(0, 1))(sc, xc, w.select(wd, c))
        torch.testing.assert_close(v[c], vc, atol=1e-5, rtol=1e-6)
        torch.testing.assert_close(gs[c], gsc, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(gx[c], gxc, atol=1e-6, rtol=1e-6)


def test_nested_vmap_folds_groups_of_groups():
    """vmap over vmap: the inner rule's grouped call is batched again and
    folds into C_outer * C_inner groups."""
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.randn(2, 3, 5, 8).astype(np.float32))
    s = torch.from_numpy((r.randn(2, 3, 8) * 0.1).astype(np.float32))
    out = torch.func.vmap(torch.func.vmap(lambda x_, s_: ops.rmsnorm(x_, s_)))(x, s)
    want = torch.stack([torch.stack([ref.rmsnorm(x[i, j], s[i, j]) for j in range(3)])
                        for i in range(2)])
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


def test_vmap_over_a_grouped_call_with_shared_scale():
    """x batched, a grouped scale shared by the batch: the groups stay the
    leading logical dim and the batch dim moves behind them."""
    r = np.random.RandomState(10)
    x = torch.from_numpy(r.randn(3, 2, 5, 8).astype(np.float32))
    s = torch.from_numpy((r.randn(2, 8) * 0.1).astype(np.float32))
    out = torch.func.vmap(lambda x_: ops.rmsnorm(x_, s, groups=2))(x)
    want = torch.stack([torch.stack([ref.rmsnorm(x[i, g], s[g]) for g in range(2)])
                        for i in range(3)])
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


def test_grouped_plain_version_equals_per_group_calls():
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(4, 6, 7, 16).astype(np.float32))
    s = torch.from_numpy((r.randn(4, 16) * 0.1).astype(np.float32))
    out = ops.rmsnorm(x, s, groups=4)
    for g in range(4):
        assert torch.equal(out[g], ref.rmsnorm(x[g], s[g]))
    with pytest.raises(ValueError, match="groups"):
        ops.rmsnorm(x, s[:3], groups=4)


def test_one_forward_call_per_norm_call_under_vmap_grad(monkeypatch):
    """Under the round's vmap(grad_and_value) the op's forward runs once per
    norm call for all clients: where the card launches its kernel."""
    calls = []
    real = ref.rmsnorm
    monkeypatch.setattr(ref, "rmsnorm", lambda *a, **k: calls.append(1) or real(*a, **k))
    r = np.random.RandomState(9)
    x = torch.from_numpy(r.randn(4, 3, 16).astype(np.float32))
    s = torch.from_numpy(r.randn(4, 16).astype(np.float32))

    def two_norms(s_, x_):
        return ops.rmsnorm(ops.rmsnorm(x_, s_), s_).sum()

    torch.func.vmap(torch.func.grad_and_value(two_norms, argnums=(0, 1)))(s, x)
    assert len(calls) == 2


def test_wrapper_refuses_a_device_without_kernel():
    """A device without a kernel (not the CPU, CUDA or meta) raises; a
    meta tensor (the dry run) takes the plain version for its shapes,
    checked as the kernel checks it, and counts ``meta_launches``."""
    from _elsewhere import Elsewhere

    with pytest.raises(ValueError, match="no kernel"):
        ops.RMSNorm.forward(Elsewhere(2, 8), Elsewhere(8), 1, 1e-6)
    ops.reset_launches()
    meta = torch.empty(2, 8, device="meta")
    assert ops.rmsnorm(meta, torch.empty(8, device="meta")).is_meta
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm(meta.half(), torch.empty(8, device="meta"))
    assert ops.meta_launches["rmsnorm"] == 1 and ops.launches["rmsnorm"] == 0
