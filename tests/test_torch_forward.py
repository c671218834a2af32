"""The port's dense forward, loss and prefill against the JAX package, for
each attention path, on params carried across with ``repro_torch.bridge``.

Reduced StarCoder2 (window 64) runs at S = 96 > W, so the window bites;
reduced Qwen1.5 has no window. Bars: logits and losses 2e-4 (the JAX
package's own pallas-vs-direct bar at model level,
tests/test_kernels.py::test_flash_attention_is_model_attention); the
cross entropy 1e-6; prefill caches at the prefill tolerance of
tests/test_torch_model.py (atol 1e-5, rtol 1e-4) against the JAX prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import build_model_by_name as torch_build

torch.set_num_threads(2)

IMPLS = ["direct", "chunked", "pallas"]


def _pair(arch):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _batch(cfg, B, S, seed, mask=False):
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (r.rand(B, S) < 0.7).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    r = np.random.RandomState(4)
    logits = (3 * r.randn(3, 7, 50)).astype(np.float32)
    targets = r.randint(0, 50, (3, 7)).astype(np.int32)
    mask = (r.rand(3, 7) < 0.5).astype(np.float32) if with_mask else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    # an all-zero mask: the sum is clamped at 1, the loss is 0
    zero = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                 torch.zeros(3, 7))
    assert zero.item() == 0.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen1.5-32b"])
def test_forward_and_loss_match_jax(arch, impl):
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.config
    S = 96
    assert cfg.sliding_window in (0, 64)  # S > W where there is a window
    jb, tb = _batch(cfg, 2, S, seed=11, mask=True)
    jl, jaux = jtransformer.forward(cfg, jp, jb, impl=impl)
    tl, taux = tm.forward(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    assert float(taux) == float(jaux) == 0.0
    jloss, jm_ = jtransformer.loss_fn(cfg, jp, jb, impl=impl)
    tloss, tm_ = tm.loss(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tm_["ce"]), np.asarray(jm_["ce"]), atol=2e-4, rtol=2e-4)


def test_impls_agree_and_auto_is_direct_at_short_s():
    """Within the port: the three paths at the model-level bar, and "auto"
    (S <= 2048) bitwise the direct path."""
    _, _, tm, tp = _pair("starcoder2-3b")
    _, tb = _batch(tm.config, 1, 100, seed=12)
    outs = {impl: tm.forward(tp, tb, impl=impl)[0] for impl in IMPLS + ["auto"]}
    assert torch.equal(outs["auto"], outs["direct"])
    for impl in ("chunked", "pallas"):
        torch.testing.assert_close(outs[impl], outs["direct"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen1.5-32b"])
def test_pallas_prefill_matches_jax_prefill_within_window(arch):
    """S <= W (reduced window 64): the JAX prefill's full attention equals
    windowed attention, so the two prefills are held against each other."""
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.RandomState(13).randint(0, jm.config.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, impl="pallas", pad_to=48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl="pallas", pad_to=48)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.k), np.asarray(jc.kv.k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.v), np.asarray(jc.kv.v), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))


def test_pallas_prefill_beyond_window_matches_jax_forward():
    """S > W: the JAX prefill attends fully there (ROADMAP C/R1), so the
    port's windowed prefill is held against the JAX ``forward`` (C2's
    rule), and against its own direct prefill's cache."""
    jm, jp, tm, tp = _pair("starcoder2-3b")
    cfg = jm.config
    S = cfg.sliding_window + 29
    toks = np.random.RandomState(14).randint(0, cfg.vocab_size, (1, S)).astype(np.int32)
    jlogits, _ = jtransformer.forward(cfg, jp, {"tokens": jnp.asarray(toks)}, impl="pallas")
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl="pallas")
    np.testing.assert_allclose(_np(tl), np.asarray(jlogits[:, -1]), atol=2e-4, rtol=2e-4)
    _, dc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl="direct")
    torch.testing.assert_close(tc.kv.k, dc.kv.k, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(tc.kv.v, dc.kv.v, atol=1e-5, rtol=1e-4)
    assert torch.equal(tc.kv.pos, dc.kv.pos)


def test_backward_through_pallas_raises_and_direct_has_grads():
    _, _, tm, tp = _pair("starcoder2-3b")
    _, tb = _batch(tm.config, 1, 32, seed=15)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = tm.loss(params, tb, impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        loss.backward()
    loss, _ = tm.loss(params, tb, impl="direct")
    loss.backward()
    assert params["layers/attn/w_q"].grad is not None


def test_non_dense_forward_raises_naming_a13():
    """A13c is ported: a StarCoder2 config turned VLM or audio builds and
    runs forward, loss and prefill (tests/test_torch_vlm.py and
    tests/test_torch_encdec.py hold them against the JAX package), while
    the decoder stack's own functions refuse the audio family, which is
    models.encdec's."""
    from dataclasses import replace

    from repro_torch.models.model import build_model

    base = torch_build("starcoder2-3b", reduced=True, device="cpu").config
    vlm = replace(base, family="vlm", num_patches=4, vision_dim=64)
    audio = replace(base, family="audio", learned_pos=True, encoder_layers=2,
                    encoder_seq=16, frontend_dim=base.d_model)
    r = np.random.RandomState(16)
    toks = torch.from_numpy(r.randint(0, base.vocab_size, (1, 12)).astype(np.int64))
    extra = {"vlm": ("patches", (1, 4, 64)), "audio": ("frames", (1, 16, base.d_model))}
    for cfg in (vlm, audio):
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        name, shape = extra[cfg.family]
        batch = {"tokens": toks, "targets": toks, name: torch.from_numpy(
            r.randn(*shape).astype(np.float32))}
        logits, _ = model.forward(params, batch)
        assert logits.shape == (1, 12, base.vocab_size) and bool(torch.isfinite(logits).all())
        assert bool(torch.isfinite(model.loss(params, batch)[0]))
        last, _ = model.prefill(params, {k: v for k, v in batch.items() if k != "targets"})
        torch.testing.assert_close(last, logits[:, -1], atol=1e-5, rtol=1e-4)
    for call in (lambda: ttransformer.forward(audio, {}, {"tokens": toks}),
                 lambda: ttransformer.init_params(audio, device="cpu")):
        with pytest.raises(NotImplementedError, match="models.encdec"):
            call()


@pytest.mark.parametrize("impl", ["direct", "pallas"])
def test_prefill_window_rings_a_full_attention_model(impl):
    """ROADMAP C3: ``prefill(window=W)`` on reduced Qwen1.5 (full attention)
    with S = 40 > W = 16 lays the prompt into a W-slot ring and attends
    with window W, as the JAX ``prefill(window=W)``: last-token logits
    against the JAX ``forward(window=W)`` (2e-4), the ring of every layer
    against the JAX prefill's cache (``pos`` exactly, K/V at the prefill
    tolerance). ``unroll=`` is accepted and ignored."""
    jm, jp, tm, tp = _pair("qwen1.5-32b")
    cfg = jm.config
    assert cfg.sliding_window == 0
    W, S = 16, 40
    toks = np.random.RandomState(16).randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jlogits, _ = jtransformer.forward(cfg, jp, {"tokens": jnp.asarray(toks)}, window=W)
    _, jc = jtransformer.prefill(cfg, jp, {"tokens": jnp.asarray(toks)}, window=W)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl=impl, window=W, unroll=2)
    np.testing.assert_allclose(_np(tl), np.asarray(jlogits[:, -1]), atol=2e-4, rtol=2e-4)
    assert tc.kv.k.shape[2] == W
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
    np.testing.assert_allclose(_np(tc.kv.k), np.asarray(jc.kv.k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.v), np.asarray(jc.kv.v), atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="full-attention only"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, window=W,
                   length=torch.tensor([S, S]))
