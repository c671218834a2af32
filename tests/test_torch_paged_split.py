"""The plain mirror of the CUDA decode kernel's split walk and merge
(``ref.paged_decode_attention_split``) against the JAX package's Pallas
decode kernel (interpret mode) and its jnp oracle, on numpy inputs from a
seed. The CUDA kernel itself is held against the plain versions in
test_torch_kernels_cuda.py (on a card).

Bars: pools bitwise equal (every side copies the new rows verbatim);
outputs within atol and rtol 1e-6 in float32 (the split partials and
their merge reassociate the softmax's float32 sums: ULP-level
differences).
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

TOL = 1e-6
B, HKV, HD, PS, P = 3, 2, 16, 4, 12  # 48 entries a slot


def _inputs(seed, G, holes=()):
    """numpy q, pools, new rows and a page table of distinct pages; each
    (slot, logical page) in ``holes`` is -1."""
    r = np.random.RandomState(seed)
    N = B * P + 2
    q = r.randn(B, G * HKV, HD).astype(np.float32)
    kp = r.randn(N, PS, HKV, HD).astype(np.float32)
    vp = r.randn(N, PS, HKV, HD).astype(np.float32)
    kn = r.randn(B, HKV, HD).astype(np.float32)
    vn = r.randn(B, HKV, HD).astype(np.float32)
    pt = r.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    for b, p in holes:
        pt[b, p] = -1
    return q, kp, vp, kn, vn, pt


def _check(args, pos, active, window, splits):
    """Mirror vs Pallas (interpret) and vs the jnp oracle: pools bitwise,
    every slot's output within TOL. Returns the mirror's output."""
    pos = np.asarray(pos, np.int32)
    act = np.asarray(active, bool)
    jargs = [jnp.asarray(a) for a in (*args, pos)]
    o_p, kk_p, vk_p = pa_kernel.paged_decode_attention_pallas(
        *jargs, jnp.asarray(act), window=window, interpret=True)
    o_r, kk_r, vk_r = jref.paged_decode_attention(*jargs, jnp.asarray(act), window=window)
    t = [torch.from_numpy(a.copy()) for a in (*args, pos)]
    o_t = tref.paged_decode_attention_split(*t, torch.from_numpy(act), window=window,
                                            splits=splits)
    for kk, vk in ((kk_p, vk_p), (kk_r, vk_r)):
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(kk))
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(vk))
    for o in (o_p, o_r):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o), atol=TOL, rtol=TOL)
    return o_t


# splits of P pages (1 split), 3 pages (4), 1 page (P) and uneven (5: 3 or 2)
@pytest.mark.parametrize("splits", [1, 4, P, 5])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("G", [1, 3])
def test_split_mirror_matches_pallas(splits, window, G):
    """-1 pages inside the live range of slots 1 and 2; window 8 leaves
    only pages 0 and 1 live, so most splits have no live key."""
    args = _inputs(splits * 7 + window + G, G, holes=((1, 2), (2, 0), (2, 6)))
    pos = [0, 17, 46] if window == 0 else [3, 7, 30]
    _check(args, pos, [True, True, True], window, splits)


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("window", [0, 8])
def test_split_mirror_inactive_slots(splits, window):
    """Inactive slots write nothing and attend over the pool as it is."""
    args = _inputs(40 + splits + window, 3, holes=((0, 1),))
    for active in ([False, True, False], [False, False, False]):
        _check(args, [9, 30, 5], active, window, splits)


@pytest.mark.parametrize("splits", [3, P])
def test_split_mirror_wrapped_ring(splits):
    """SWA positions far past the window: the floor-modulo ring, with the
    new row landing mid-ring."""
    W = 16
    args = _inputs(50 + splits, 3, holes=((1, 3),))
    _check(args, [W - 1, W + 5, 7 * W + 11], [True, True, False], W, splits)


@pytest.mark.parametrize("splits", [1, 4, P])
def test_split_mirror_slot_with_no_live_key_is_zero(splits):
    """Every page of active slot 1 is -1: its output is exactly 0, and the
    other slots do not move."""
    args = _inputs(60 + splits, 3, holes=tuple((1, p) for p in range(P)))
    o = _check(args, [20, 33, 47], [True, True, True], 0, splits)
    assert torch.equal(o[1], torch.zeros_like(o[1]))


def test_split_mirror_matches_plain_version():
    """The mirror against the port's own plain decode at a serving-like
    shape, at the split count the wrapper would launch on a 132-SM card
    holding 2 blocks an SM (bf16 at hd 128)."""
    r = np.random.RandomState(80)
    b, hkv, g, hd, ps, p = 4, 2, 12, 32, 16, 64
    n = b * p + 1
    q = torch.from_numpy(r.randn(b, g * hkv, hd).astype(np.float32))
    kp = torch.from_numpy(r.randn(n, ps, hkv, hd).astype(np.float32))
    vp = torch.from_numpy(r.randn(n, ps, hkv, hd).astype(np.float32))
    kn = torch.from_numpy(r.randn(b, hkv, hd).astype(np.float32))
    vn = torch.from_numpy(r.randn(b, hkv, hd).astype(np.float32))
    pt = torch.from_numpy(r.permutation(n)[:b * p].reshape(b, p).astype(np.int32))
    pt[0, 20] = pt[3, 1] = -1
    pos = torch.tensor([400, 3, 1023, 70], dtype=torch.int32)
    act = torch.tensor([True, True, False, True])
    splits = pa_ops.decode_splits(b, hkv, p, 2 * 132)
    assert splits == 16
    pools = [kp.clone(), vp.clone(), kp.clone(), vp.clone()]
    o_s = tref.paged_decode_attention_split(q, pools[0], pools[1], kn, vn, pt, pos, act,
                                            window=0, splits=splits)
    o_p = tref.paged_decode_attention(q, pools[2], pools[3], kn, vn, pt, pos, act)
    assert torch.equal(pools[0], pools[2]) and torch.equal(pools[1], pools[3])
    torch.testing.assert_close(o_s, o_p, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,hkv,p,resident,want", [
    (8, 2, 256, 2 * 132, 16),  # StarCoder2-3B serving, bf16: 256 blocks, one wave
    (8, 2, 256, 132, 8),       # the same in float32: 1 block an SM (128 KB of pages)
    (8, 40, 256, 2 * 132, 1),  # Qwen1.5-32B: 320 (slot, kv head) pairs fill the card
    (4, 2, 4, 2 * 132, 1),     # a 4-page table feeds one split of 4 warps
    (1, 1, 9, 2 * 132, 3),     # capped at ceil(P / 4)
])
def test_decode_splits_from_shapes(b, hkv, p, resident, want):
    assert pa_ops.decode_splits(b, hkv, p, resident) == want
