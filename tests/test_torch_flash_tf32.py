"""The float32 flash kernel's arithmetic, three TF32 products a product on
the tensor cores (3xTF32), in its plain mirror ``ref.attention_tf32x3``,
against the JAX package's flash attention (the Pallas kernel in interpret
mode) and its reference, on numpy inputs from a seed. The CUDA kernel itself
is held against the plain version in test_torch_kernels_cuda.py (on a card).

Bar: 2e-5, the JAX package's float32 kernel-vs-oracle bar
(tests/test_kernels.py), which the card's kernel is held to as well. A
single TF32 product in P V errs by ~2^-11 of |v| and misses it: a test
checks that, so that the reason for three products is tested and not only
stated. A query row with no live key is exactly 0 in the kernel, the
mirror and the Pallas kernel; the JAX ``ref.attention`` gives the uniform
mean there, so it is compared only where no row is empty.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import ref as fa_ref

torch.set_num_threads(2)

TOL = 2e-5

# test_torch_flash_attention.py's SHAPES (tests/test_kernels.py's), plus hd
# 128 at Sq = Sk = 256, causal, with and without a window (the main path's
# head dim)
SHAPES = [
    (1, 128, 128, 4, 2, 32, True, 0, 0),
    (2, 200, 200, 4, 4, 16, True, 64, 0),
    (1, 64, 256, 2, 1, 32, True, 0, 192),
    (2, 128, 128, 8, 2, 64, False, 0, 0),
    (1, 257, 257, 2, 2, 128, True, 100, 0),
    (1, 256, 256, 4, 2, 128, True, 0, 0),
    (1, 256, 256, 4, 2, 128, True, 96, 0),
]


def _qkv(seed, B, Sq, Sk, Hq, Hkv, hd):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, hd).astype(np.float32), r.randn(B, Sk, Hkv, hd).astype(np.float32),
            r.randn(B, Sk, Hkv, hd).astype(np.float32))


def _mirror(q, k, v, **kw):
    return fa_ref.attention_tf32x3(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


def _jax(fn, q, k, v, **kw):
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_tf32_split_rounds_ties_away_and_holds_22_bits():
    """big keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna); big + small is within 2^-22 of x."""
    one = 1.0 + 2.0 ** -11  # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, one - 2.0 ** -23, 3.0, 0.0], dtype=torch.float32)
    big, _ = fa_ref.tf32_split(x)
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0]
    r = np.random.RandomState(0)
    x = torch.from_numpy((r.randn(4096) * 10.0 ** r.uniform(-6, 6, 4096)).astype(np.float32))
    big, small = fa_ref.tf32_split(x)
    assert not ((big.view(torch.int32) | small.view(torch.int32)) & 0x1FFF).any()
    x64 = x.double()
    err = (x64 - (big.double() + small.double())).abs()
    assert (err <= 2.0 ** -22 * x64.abs()).all()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,qoff", SHAPES)
def test_tf32x3_mirror_matches_pallas_kernel_and_ref(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                                                      qoff):
    q, k, v = _qkv(Sq + Sk + hd, B, Sq, Sk, Hq, Hkv, hd)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o = _mirror(q, k, v, **kw)
    o_pallas = _jax(jfa_ops.flash_attention, q, k, v, **kw, block_q=64, block_k=64)
    o_ref = _jax(jfa_ref.attention, q, k, v, **kw)
    np.testing.assert_allclose(o, o_pallas, atol=TOL, rtol=0)
    np.testing.assert_allclose(o, o_ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("window", [0, 96])
def test_one_tf32_product_in_pv_misses_the_bar(window):
    """At hd 128, S 256, causal: with three products in P V the mirror holds
    2e-5 against the JAX reference, with one (a_big b_big) it does not."""
    q, k, v = _qkv(11 + window, 1, 256, 256, 4, 2, 128)
    kw = dict(causal=True, window=window, q_offset=0)
    o_ref = _jax(jfa_ref.attention, q, k, v, **kw)
    err3 = np.abs(_mirror(q, k, v, **kw) - o_ref).max()
    err1 = np.abs(_mirror(q, k, v, **kw, pv_products=1) - o_ref).max()
    assert err3 <= TOL < err1, (err3, err1)


@pytest.mark.parametrize("qoff", [100, 10])
def test_tf32x3_row_with_no_live_key_is_zero_as_in_pallas_kernel(qoff):
    """Non-causal, window 4, Sk 16: rows at positions >= 19 have no live
    key; they are exactly 0 in the mirror and the Pallas kernel."""
    q, k, v = _qkv(3, 1, 16, 16, 2, 1, 16)
    kw = dict(causal=False, window=4, q_offset=qoff)
    o = _mirror(q, k, v, **kw)
    o_pallas = _jax(jfa_ops.flash_attention, q, k, v, **kw)
    empty = qoff + np.arange(16) >= 19
    assert empty.any()
    assert (o[:, empty] == 0).all() and (o_pallas[:, empty] == 0).all()
    np.testing.assert_allclose(o, o_pallas, atol=TOL, rtol=0)
