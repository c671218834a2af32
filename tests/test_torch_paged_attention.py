"""The port's paged-attention plain versions against the JAX package's
Pallas kernels (interpret mode) and jnp oracle. The CUDA kernels are held
against these plain versions in test_torch_kernels_cuda.py (on a card).

Bars: pools bitwise equal (both sides copy the new rows verbatim);
attention outputs within atol/rtol 1e-5 in float32 (the Pallas kernel's
online softmax reassociates the reduction: ULP-level differences).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import kernel as pa_kernel
from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as tref

torch.set_num_threads(2)


def _scenario(seed, B, Hq, Hkv, hd, N, P, ps, *, n_tail_unalloc=0, recycled=False):
    """numpy inputs, as tests/test_paged_kernel.py builds them."""
    r = np.random.RandomState(seed)
    q = r.randn(B, Hq, hd).astype(np.float32)
    kp = r.randn(N, ps, Hkv, hd).astype(np.float32)
    vp = r.randn(N, ps, Hkv, hd).astype(np.float32)
    kn = r.randn(B, Hkv, hd).astype(np.float32)
    vn = r.randn(B, Hkv, hd).astype(np.float32)
    pt = r.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    if n_tail_unalloc:
        pt[:, P - n_tail_unalloc:] = -1
    if recycled:
        pt[0, 0] = pt[-1, -1] if pt[-1, -1] >= 0 else pt[0, 0]
    return q, kp, vp, kn, vn, pt


def _compare(q, kp, vp, kn, vn, pt, pos, active, window):
    B = q.shape[0]
    act = np.ones(B, bool) if active is None else np.asarray(active, bool)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, kn, vn, pt, pos)]
    o_p, kk_p, vk_p = pa_kernel.paged_decode_attention_pallas(
        *jargs, jnp.asarray(act), window=window, interpret=True)
    o_r, kk_r, vk_r = jref.paged_decode_attention(*jargs, jnp.asarray(act), window=window)

    t = [torch.from_numpy(a.copy()) for a in (q, kp, vp, kn, vn, pt, pos)]
    o_t = pa_ops.paged_decode_attention(
        *t, window=window, active=None if active is None else torch.from_numpy(act))
    for kk in (kk_p, kk_r):
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(kk))
    for vk in (vk_p, vk_r):
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(vk))
    for o in (o_p, o_r):
        np.testing.assert_allclose(o_t.numpy()[act], np.asarray(o)[act],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_plain_matches_pallas(ps, window, G):
    Hkv = 2
    B, P, N = 3, max(1, 16 // ps), 3 * max(1, 16 // ps) + 2
    args = _scenario(ps * 31 + window + G, B, G * Hkv, Hkv, 16, N, P, ps)
    cap = P * ps
    pos = np.asarray([0, cap // 2, cap - 1], np.int32)
    _compare(*args, pos, None, window)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_plain_partial_active(window):
    B, Hkv, ps, P = 4, 2, 4, 2
    args = _scenario(7 + window, B, 4, Hkv, 8, 12, P, ps)
    pos = np.asarray([1, 3, 5, 7], np.int32)
    for active in ([True, False, True, False], [False, True, True, True],
                   [True, True, True, True]):
        _compare(*args, pos, active, window)


def test_decode_plain_all_inactive_is_noop_write():
    B, Hkv, ps, P = 3, 2, 4, 2
    q, kp, vp, kn, vn, pt = _scenario(11, B, 4, Hkv, 8, 8, P, ps)
    t = [torch.from_numpy(a.copy()) for a in (q, kp, vp, kn, vn, pt)]
    pa_ops.paged_decode_attention(*t, torch.tensor([2, 3, 4], dtype=torch.int32),
                                  window=0, active=torch.zeros(B, dtype=torch.bool))
    np.testing.assert_array_equal(t[1].numpy(), kp)
    np.testing.assert_array_equal(t[2].numpy(), vp)


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_plain_unallocated_and_recycled_pages(ps, window):
    B, Hkv = 3, 2
    P = max(2, 32 // ps)
    N = B * P + 2
    args = _scenario(ps + window, B, 4, Hkv, 16, N, P, ps, n_tail_unalloc=1,
                     recycled=True)
    pos = np.asarray([0, ps - 1, (P - 1) * ps - 1], np.int32)
    _compare(*args, pos, None, window)


def test_decode_plain_ring_wraps():
    """SWA positions past the window: the floor-modulo ring arithmetic."""
    B, Hkv, ps, W = 3, 2, 4, 8
    P = W // ps
    args = _scenario(5, B, 4, Hkv, 8, B * P + 1, P, ps)
    pos = np.asarray([W - 1, W + 3, 3 * W + 5], np.int32)
    _compare(*args, pos, [True, True, False], W)


@pytest.mark.parametrize("n_alloc", [0, 1, 3])
def test_insert_plain_matches_pallas(n_alloc):
    L, N, P, ps, Hkv, hd = 2, 9, 3, 4, 2, 16
    r = np.random.RandomState(n_alloc)
    kp, vp = (r.randn(L, N, ps, Hkv, hd).astype(np.float32) for _ in range(2))
    ks, vs = (r.randn(L, P, ps, Hkv, hd).astype(np.float32) for _ in range(2))
    ids = np.full(P, -1, np.int32)
    ids[:n_alloc] = r.permutation(N)[:n_alloc]
    jargs = [jnp.asarray(a) for a in (kp, vp, ks, vs, ids)]
    kk_p, vk_p = pa_kernel.paged_insert_pallas(*jargs, interpret=True)
    kk_r, vk_r = jref.paged_insert(*jargs)
    t = [torch.from_numpy(a.copy()) for a in (kp, vp, ks, vs, ids)]
    pa_ops.paged_insert(*t)
    for kk, vk in ((kk_p, vk_p), (kk_r, vk_r)):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(kk))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(vk))


def test_slot_valid_matches_jax():
    r = np.random.RandomState(0)
    pt = r.randint(-1, 9, (4, 3)).astype(np.int32)
    pos = np.asarray([0, 5, 11, 30], np.int32)
    for window in (0, 8):
        want = np.asarray(jref.slot_valid(jnp.asarray(pt), jnp.asarray(pos), 4, window))
        got = tref.slot_valid(torch.from_numpy(pt), torch.from_numpy(pos), 4, window)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_counts_no_launch():
    """The plain versions are not kernel launches."""
    pa_ops.reset_launches()
    args = _scenario(1, 2, 4, 2, 8, 5, 2, 4)
    t = [torch.from_numpy(a.copy()) for a in args]
    pa_ops.paged_decode_attention(*t, torch.tensor([1, 2], dtype=torch.int32))
    assert pa_ops.launches == {"paged_decode": 0, "paged_insert": 0}
