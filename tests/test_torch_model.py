"""The port's model layers, prefill and paged decode against the JAX
package, on params carried across with ``repro_torch.bridge``.

Tolerances: layer ops 1e-6; prefill logits and KV caches atol 1e-5 /
rtol 1e-4 (float32, different matmul kernels); paged decode steps at
the bars of tests/test_paged_kernel.py's kernel-vs-mask test: logits
2e-4, pools 1e-5 / 1e-4, greedy argmax identical. The pools cannot be
bitwise here, even at layer 0: each framework projects the new K/V rows
with its own matmul (ULP-level differences). That the kernels copy the
rows they are given bit for bit is held in test_torch_paged_attention.py
on identical inputs.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import build_model_by_name as jax_build
from repro.models.transformer import insert_cache_pages as jax_insert_cache_pages
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model_by_name as torch_build
from repro_torch.models.transformer import insert_cache_pages

torch.set_num_threads(2)

ARCHS = ["starcoder2-3b", "qwen1.5-32b"]


def _pair(arch):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _np(t):
    return t.detach().cpu().numpy()


def test_bridge_round_trip_with_bf16():
    r = np.random.RandomState(0)
    tree = {"embed": r.randn(5, 3).astype(np.float32),
            "layers": {"attn": {"w_q": r.randn(2, 3, 4).astype(ml_dtypes.bfloat16)},
                       "ids": np.arange(4, dtype=np.int32)}}
    flat = bridge.params_from_numpy(tree)
    assert set(flat) == {"embed", "layers/attn/w_q", "layers/ids"}
    assert flat["layers/attn/w_q"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(flat)
    for a, b in ((tree["embed"], back["embed"]),
                 (tree["layers"]["attn"]["w_q"], back["layers"]["attn"]["w_q"]),
                 (tree["layers"]["ids"], back["layers"]["ids"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the bf16 bits reach torch unchanged
    want = jnp.asarray(tree["layers"]["attn"]["w_q"]).astype(jnp.float32)
    np.testing.assert_array_equal(_np(flat["layers/attn/w_q"].float()), np.asarray(want))


def test_layer_ops_match_jax():
    r = np.random.RandomState(1)
    x = r.randn(2, 5, 4, 16).astype(np.float32)
    scale, bias = r.randn(16).astype(np.float32), r.randn(16).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        _np(tlayers.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias))),
        np.asarray(jlayers.layernorm(jnp.asarray(x), scale, bias)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm(tx, torch.from_numpy(scale))),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), scale)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(tlayers.gelu(tx)), np.asarray(jax.nn.gelu(x)),
                               atol=1e-6, rtol=1e-6)
    pos = np.arange(5, dtype=np.int32) * 37
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(tx, torch.from_numpy(pos), 999_999.0)),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 999_999.0)),
        atol=1e-6, rtol=1e-6)


def _close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(_np(a), np.asarray(b), atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """Exact-length prefill; S stays inside the reduced SWA window (64),
    where the JAX prefill's full attention equals windowed attention."""
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.RandomState(2).randint(0, jm.config.vocab_size, (1, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pad_to=32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, pad_to=32)
    _close(tl, jl)
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
    np.testing.assert_array_equal(_np(tc.kv.pos), np.asarray(jc.kv.pos))


def test_swa_prefill_beyond_window_matches_jax_forward():
    """Reduced StarCoder2 (window W = 64) with a prompt of S = 101 > W: the
    port's windowed prefill against the JAX package's ``forward``, which
    applies the window (its ``prefill`` does not for S > W: ROADMAP C/R1).
    The ring cache of each layer is held against ``prefill_kv_cache(
    window=W)`` on that layer's windowed input: ``pos`` exactly, K/V at the
    prefill tolerance."""
    jm, jp, tm, tp = _pair("starcoder2-3b")
    cfg = jm.config
    W, S = cfg.sliding_window, cfg.sliding_window + 37
    assert W == 64
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    jlogits, _ = jtransformer.forward(cfg, jp, batch)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jlogits[:, -1])
    h = jtransformer.embed_tokens(cfg, jp, batch)
    positions = jnp.arange(S)
    for layer in range(cfg.num_layers):
        lp = jax.tree.map(lambda x: x[layer], jp["layers"])
        ring = jattn.prefill_kv_cache(cfg, lp["attn"], jlayers.apply_norm(cfg, lp["norm1"], h),
                                      positions, window=W)
        np.testing.assert_array_equal(_np(tc.kv.pos[layer]), np.asarray(ring.pos))
        _close(tc.kv.k[layer], ring.k)
        _close(tc.kv.v[layer], ring.v)
        h, _ = jtransformer.layer_apply(cfg, lp, h, positions, window=W)


def test_prefill_padded_length_matches_jax():
    """Bucket-padded full-attention prefill (``length=``)."""
    jm, jp, tm, tp = _pair("qwen1.5-32b")
    toks = np.zeros((1, 32), np.int32)
    toks[0, :19] = np.random.RandomState(3).randint(0, jm.config.vocab_size, 19)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pad_to=48,
                        length=jnp.asarray([19], jnp.int32))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, pad_to=48,
                        length=torch.tensor([19], dtype=torch.int32))
    _close(tl, jl)
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)
    np.testing.assert_array_equal(_np(tc.kv.pos), np.asarray(jc.kv.pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_matches_jax_kernel_path(arch):
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.config
    B, ps = 3, 4
    P = -(-(cfg.sliding_window or 16) // ps)
    n_pages = B * P + 1
    pt = np.random.RandomState(0).permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    jcache = jm.init_paged_cache(B, n_pages, ps)
    tcache = tm.init_paged_cache(B, n_pages, ps)
    tok = np.asarray([1, 2, 3], np.int32)
    pos = np.asarray([0, 1, 2], np.int32)
    for t, active in enumerate(([True] * 3, [True] * 3, [True, True, False])):
        act = np.asarray(active)
        jl, jcache = jm.paged_decode_step(
            jp, jcache, jnp.asarray(pt), jnp.asarray(tok + t), jnp.asarray(pos + t),
            cache_update="kernel", active=jnp.asarray(act))
        tl, tcache = tm.paged_decode_step(
            tp, tcache, torch.from_numpy(pt), torch.from_numpy(tok + t),
            torch.from_numpy(pos + t), cache_update="kernel",
            active=torch.from_numpy(act))
        _close(tcache.kv.k, jcache.kv.k)
        _close(tcache.kv.v, jcache.kv.v)
        np.testing.assert_allclose(_np(tl)[act], np.asarray(jl)[act], atol=2e-4, rtol=2e-4)
        assert (_np(tl).argmax(-1)[act] == np.asarray(jl).argmax(-1)[act]).all()


def test_insert_cache_pages_matches_jax_kernel_path():
    jm, jp, tm, tp = _pair("qwen1.5-32b")
    B, ps, P = 2, 4, 3
    toks = np.ones((1, 8), np.int32)
    _, jone = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pad_to=P * ps)
    _, tone = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, pad_to=P * ps)
    ids = np.asarray([4, 1, -1], np.int32)
    jc = jax_insert_cache_pages(jm.init_paged_cache(B, B * P, ps), jone, jnp.int32(0),
                                jnp.asarray(ids), cache_update="kernel")
    # carry the JAX prefill rows over so the copy itself is compared bitwise
    tone = tone._replace(kv=tone.kv._replace(k=torch.from_numpy(np.array(jone.kv.k)),
                                             v=torch.from_numpy(np.array(jone.kv.v))))
    tc = insert_cache_pages(tm.init_paged_cache(B, B * P, ps), tone, 0,
                            torch.from_numpy(ids), cache_update="kernel")
    np.testing.assert_array_equal(_np(tc.kv.k), np.asarray(jc.kv.k))
    np.testing.assert_array_equal(_np(tc.kv.v), np.asarray(jc.kv.v))
