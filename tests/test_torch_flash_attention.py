"""The port's flash attention (its plain version, which the op takes for CPU
tensors) and chunked attention against the JAX package.

Bars are the JAX package's kernel-vs-oracle bars (tests/test_kernels.py):
2e-5 in float32, 3e-2 in bf16 (the Pallas kernel keeps float32
probabilities, the plain version rounds them to bf16 before PV). A query
row with no live key is exactly 0 in both, as in the Pallas kernel; the
JAX ``ref.attention`` gives the uniform mean there, so it is compared only
where no row is empty.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import attention as jattn
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

# tests/test_kernels.py::test_flash_attention_matches_ref's shapes
SHAPES = [
    (1, 128, 128, 4, 2, 32, True, 0, 0),
    (2, 200, 200, 4, 4, 16, True, 64, 0),
    (1, 64, 256, 2, 1, 32, True, 0, 192),  # decode-chunk with offset
    (2, 128, 128, 8, 2, 64, False, 0, 0),
    (1, 257, 257, 2, 2, 128, True, 100, 0),  # ragged block edges
    (1, 200, 200, 4, 2, 96, True, 0, 0),  # phi-3's head dim, GQA, ragged
    (2, 72, 300, 2, 1, 96, True, 128, 228),  # hd 96, window with offset
]


def _qkv(seed, B, Sq, Sk, Hq, Hkv, hd):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, hd).astype(np.float32), r.randn(B, Sk, Hkv, hd).astype(np.float32),
            r.randn(B, Sk, Hkv, hd).astype(np.float32))


def _torch(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,qoff", SHAPES)
def test_plain_flash_matches_pallas_kernel_and_ref(B, Sq, Sk, Hq, Hkv, hd, causal, window, qoff):
    q, k, v = _qkv(Sq + Sk, B, Sq, Sk, Hq, Hkv, hd)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o = fa_ops.flash_attention(*_torch(q, k, v), **kw)
    o_pallas = jfa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
                                       block_q=64, block_k=64)
    o_ref = jfa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(_np(o), np.asarray(o_pallas), atol=2e-5)
    np.testing.assert_allclose(_np(o), np.asarray(o_ref), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_dtypes_match_pallas_kernel(dtype):
    """tests/test_kernels.py::test_flash_attention_dtypes: the same inputs
    rounded to ``dtype`` in both frameworks."""
    q, k, v = _qkv(7, 1, 96, 96, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    o_pallas = jfa_ops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    o = fa_ops.flash_attention(tq, tk, tv)
    assert o.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(o), np.asarray(o_pallas, np.float32),
                               atol=2e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("qoff", [100, 10])
def test_row_with_no_live_key_is_zero_as_in_pallas_kernel(qoff):
    """Non-causal, window 4, Sk 16: at q_offset 100 no row has a live key,
    at 10 the rows at positions >= 19 have none. Those rows are exactly 0
    in the Pallas kernel and the plain version; the rest agree at 2e-5."""
    q, k, v = _qkv(3, 1, 16, 16, 2, 1, 16)
    kw = dict(causal=False, window=4, q_offset=qoff)
    o = _np(fa_ops.flash_attention(*_torch(q, k, v), **kw))
    o_pallas = np.asarray(jfa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), **kw))
    empty = qoff + np.arange(16) >= 19
    assert empty.any()
    assert (o[:, empty] == 0).all() and (o_pallas[:, empty] == 0).all()
    np.testing.assert_allclose(o, o_pallas, atol=2e-5)
    if not empty.all():
        o_ref = np.asarray(jfa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        np.testing.assert_allclose(o[:, ~empty], o_ref[:, ~empty], atol=2e-5)


def test_use_pallas_false_is_the_plain_version():
    q, k, v = _torch(*_qkv(5, 1, 40, 40, 4, 2, 32))
    torch.testing.assert_close(fa_ops.flash_attention(q, k, v, window=8, use_pallas=False),
                               fa_ref.attention(q, k, v, window=8), atol=0, rtol=0)


def test_backward_through_flash_raises_on_cpu():
    q, k, v = _torch(*_qkv(6, 1, 32, 32, 2, 1, 16))
    q.requires_grad_(True)
    o = fa_ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        o.sum().backward()


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,want", [
    (lambda: _bf16(2, 8, 4, 64), []),
    (lambda: _bf16(2, 8, 2 + 2 * 1, 64)[:, :, :2], []),  # q of a fused projection
    (lambda: _bf16(1, 5, 1, 68)[..., :64], ["sequence"]),  # size-1 axes: stride not read
    (lambda: _bf16(2, 5, 3, 68)[..., :64], ["batch", "sequence", "head"]),
    (lambda: _bf16(1, 5, 3, 4), ["sequence", "head"]),
    (lambda: _bf16(1 + 8 * 2 * 64)[1:].view(1, 8, 2, 64), ["base address"]),
])
def test_tma_check_names_each_misaligned_stride(make, want):
    """The bf16 kernel's TMA needs 16-byte aligned rows: the wrapper's check
    names what does not fit (on the card the call then raises)."""
    bad = fa_ops.tma_misfits(make())
    assert len(bad) == len(want) and all(w in b for w, b in zip(want, bad))


def test_wrapper_refuses_a_device_without_kernel():
    """A tensor on a device without a kernel (not the CPU, CUDA or meta)
    never takes the plain version. A meta tensor (the dry run) takes it
    for its shapes and counts the card's launch in ``meta_launches``."""
    from _elsewhere import Elsewhere

    q = Elsewhere(1, 8, 2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        fa_ops._FlashAttention.forward(q, q, q, True, 0, 0)
    fa_ops.reset_launches()
    meta = torch.empty(1, 8, 2, 16, device="meta")
    out = fa_ops.flash_attention(meta, meta, meta)
    assert out.is_meta and out.shape == meta.shape
    assert fa_ops.meta_launches["flash_attention"] == 1
    assert fa_ops.launches["flash_attention"] == 0


@pytest.mark.parametrize("S,causal,window,hq,hkv", [(77, True, 20, 4, 2), (77, True, 0, 2, 2),
                                                    (50, False, 9, 4, 1)])
def test_chunked_attention_matches_jax(S, causal, window, hq, hkv):
    """Small blocks and a ragged S, so both the q and KV padding and the
    online-softmax carry across blocks are exercised."""
    q, k, v = _qkv(S + window, 2, S, S, hq, hkv, 16)
    pos = np.arange(S, dtype=np.int32)
    o = tattn._chunked_attention(*_torch(q, k, v), torch.from_numpy(pos), torch.from_numpy(pos),
                                 causal, window, q_block=16, k_block=32)
    o_jax = jattn._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), jnp.asarray(pos), causal, window,
                                     q_block=16, k_block=32)
    np.testing.assert_allclose(_np(o), np.asarray(o_jax), atol=2e-5)


@pytest.mark.parametrize("S,want", [(2048, "direct"), (2049, "chunked")])
def test_auto_switches_to_chunked_above_2048(monkeypatch, S, want):
    cfg = get_arch("starcoder2-3b").reduced()
    called = []

    def spy(name):
        def f(q, k, v, *a, **kw):
            called.append(name)
            return torch.zeros_like(q)
        return f

    monkeypatch.setattr(tattn, "_direct_attention", spy("direct"))
    monkeypatch.setattr(tattn, "_chunked_attention", spy("chunked"))
    lp = {f"attn/{n}": torch.zeros(cfg.d_model, w) for n, w in
          (("w_q", cfg.q_dim), ("w_k", cfg.kv_dim), ("w_v", cfg.kv_dim))}
    lp["attn/w_o"] = torch.zeros(cfg.q_dim, cfg.d_model)
    x = torch.zeros(1, S, cfg.d_model)
    tattn.attention_block(cfg, lp, x, torch.arange(S, dtype=torch.int32), impl="auto")
    assert called == [want]
    with pytest.raises(ValueError, match="impl"):
        tattn.attention_block(cfg, lp, x[:, :4], torch.arange(4), impl="flash")
