"""The audio family (whisper-medium's encoder-decoder) in the port against
the JAX package: config, init, the bridge's round trip, forward, loss,
gradients and prefill on the reduced arch, params carried across with
``repro_torch.bridge`` and frames and tokens made with numpy.

Bars: logits and losses 2e-4, gradients 1e-5 of each leaf's largest
entry, prefill logits, caches and the encoder's output atol 1e-5 / rtol
1e-4 and cache ``pos`` exactly (those of tests/test_torch_families.py).
The bf16 case holds float32 frames through bf16 ``frame_proj`` to one bf16
ulp of the JAX package's first encoder state (each rounds its own float32
product to bf16). ``impl`` is accepted and ignored, as the JAX functions'
``**_`` does: every impl gives the same bits.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import encdec as jencdec
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import encdec as tencdec
from repro_torch.models.layers import wmatmul
from repro_torch.models.model import build_model_by_name as torch_build

torch.set_num_threads(2)

ARCH = "whisper-medium"


def _pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(ARCH, reduced=True, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B, S, seed):
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (r.rand(B, S) < 0.7).astype(np.float32),
         "frames": r.randn(B, cfg.encoder_seq, cfg.frontend_dim).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy()


def test_config_reduced_and_param_count_match_jax():
    assert ARCH in list_archs()
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    assert full.__dict__ == jfull.__dict__
    assert full.reduced().__dict__ == jfull.reduced().__dict__
    assert full.param_count() == jfull.param_count()
    assert full.reduced().param_count() == jfull.reduced().param_count()
    red = full.reduced()
    assert (red.encoder_layers, red.encoder_seq, red.frontend_dim) == (2, 16, red.d_model)


def test_init_params_keys_shapes_and_dtypes_match_jax():
    jm, jp, tm, _ = _pair()
    want = bridge.flatten(jax.tree.map(np.asarray, jp))
    got = tm.init(0)
    assert sorted(got) == sorted(want)
    assert got["pos_embed"].shape[0] == 32768 and got["enc_pos"].shape[0] == 16
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_nested_trees_bit_exact(dtype):
    """whisper's nested ``enc_layers/attn/...`` and ``dec_layers/cross_attn/...``
    and phi-3's ``vision_proj`` go to torch and back with every bit and
    every key, bf16 through its uint16 bits."""
    for arch, module in ((ARCH, jencdec), ("phi-3-vision-4.2b", None)):
        cfg = replace(jax_get_arch(arch).reduced(), param_dtype=dtype)
        if module is None:
            from repro.models import transformer as module
        jp = jax.tree.map(np.asarray, module.init_params(jax.random.PRNGKey(6), cfg))
        tp = bridge.params_from_numpy(jp)
        back = bridge.params_to_numpy(tp)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        flat_j, flat_b = bridge.flatten(jp), bridge.flatten(back)
        assert sorted(flat_b) == sorted(flat_j)
        for k, v in flat_j.items():
            assert flat_b[k].dtype == v.dtype, k
            bits = np.uint16 if v.dtype.name == "bfloat16" else v.dtype
            np.testing.assert_array_equal(flat_b[k].view(bits), v.view(bits), err_msg=k)
        key = "dec_layers/cross_attn/w_q" if module is jencdec else "vision_proj"
        assert str(tp[key].dtype) == f"torch.{dtype}"


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_forward_and_loss_match_jax(impl, monkeypatch):
    """The port's functions take ``impl`` and ignore it, as the JAX
    ``forward(**_)`` does: no kernel is reached (the plain versions' calls,
    which stand for the kernels here, are counted)."""
    jm, jp, tm, tp = _pair()
    cfg = jm.config
    calls = []
    for mod, name in ((fa_ops.ref, "attention"), (rn_ops.ref, "rmsnorm")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    jb, tb = _batch(cfg, 2, 24, seed=51)
    jl, jaux = jencdec.forward(cfg, jp, jb, impl=impl)
    tl, taux = tm.forward(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    assert float(taux) == float(jaux) == 0.0
    jloss, jmet = jencdec.loss_fn(cfg, jp, jb, impl=impl)
    tloss, tmet = tm.loss(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tmet["ce"]), np.asarray(jmet["ce"]), atol=2e-4, rtol=2e-4)
    assert torch.equal(tl, tm.forward(tp, tb, impl="direct")[0])
    assert calls == []


def test_encoder_output_matches_jax_and_frames_are_on_the_path():
    jm, jp, tm, tp = _pair()
    cfg = jm.config
    jb, tb = _batch(cfg, 2, 8, seed=52)
    te = tencdec.encode(cfg, tp, tb["frames"])
    np.testing.assert_allclose(_np(te), np.asarray(jencdec.encode(cfg, jp, jb["frames"])),
                               atol=1e-5, rtol=1e-4)
    other = dict(tb, frames=tb["frames"] + 1.0)
    assert not torch.allclose(tm.forward(tp, other)[0], tm.forward(tp, tb)[0])


def test_loss_gradients_match_jax_grad():
    """``torch.func.grad`` of the loss against ``jax.grad``, every leaf of
    both stacks, the cross-attention and the frame projector included. The
    key biases' true gradient is 0 (a bias on every key moves each query's
    logits by one constant, which the softmax drops), so both sides give
    float32 noise there: those leaves are held under 1e-6 of the largest
    gradient of the tree instead."""
    jm, jp, tm, tp = _pair()
    jb, tb = _batch(jm.config, 2, 12, seed=53)
    jg = bridge.flatten(jax.grad(lambda p: jm.loss(p, jb)[0])(jp))
    tg = torch.func.grad(lambda p: tm.loss(p, tb)[0])(tp)
    assert sorted(tg) == sorted(jg)
    for k in ("frame_proj", "enc_layers/attn/w_q", "dec_layers/cross_attn/w_k"):
        assert float(np.abs(np.asarray(jg[k])).max()) > 0, k
    top = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k, v in jg.items():
        v = np.asarray(v)
        if k.endswith("/b_k"):
            assert max(float(np.abs(v).max()), float(tg[k].abs().max())) <= 1e-6 * top, k
            continue
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(_np(tg[k]), v, atol=1e-5 * scale, rtol=0, err_msg=k)


def test_prefill_matches_jax():
    jm, jp, tm, tp = _pair()
    jb, tb = _batch(jm.config, 2, 20, seed=54)
    for b in (jb, tb):
        b.pop("targets"), b.pop("loss_mask")
    jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb, impl="pallas")
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-4)
    assert tc["kv"].k.shape == (jm.config.num_layers, 2, 20, 4, 32)
    np.testing.assert_array_equal(tc["kv"].pos.numpy(), np.asarray(jc["kv"].pos))
    for f in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc["kv"], f)), np.asarray(getattr(jc["kv"], f)),
                                   atol=1e-5, rtol=1e-4, err_msg=f)
    np.testing.assert_allclose(_np(tc["enc_out"]), np.asarray(jc["enc_out"]), atol=1e-5,
                               rtol=1e-4)
    assert torch.equal(tl, tm.forward(tp, tb)[0][:, -1])


def test_float32_frames_into_bf16_weights_promote_as_in_jax():
    """Full-width whisper holds ``frame_proj`` in bf16 while the frames are
    float32: jnp promotes the product to float32 and casts it to the
    compute type. The first encoder state agrees with the JAX package's to
    one bf16 ulp; the bf16 forward runs."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = replace(jax_get_arch(ARCH).reduced(), **kw), replace(get_arch(ARCH).reduced(), **kw)
    jp = jencdec.init_params(jax.random.PRNGKey(7), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["frame_proj"].dtype == torch.bfloat16
    jb, tb = _batch(jcfg, 1, 8, seed=55)
    jh = np.asarray((jb["frames"] @ jp["frame_proj"]).astype(jnp.bfloat16), np.float32)
    th = wmatmul(tb["frames"], tp["frame_proj"]).to(torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jh), 1e-30))) - 7)
    assert (np.abs(_np(th) - jh) <= ulp).all()
    tl, _ = tencdec.forward(tcfg, tp, tb)
    jl, _ = jencdec.forward(jcfg, jp, jb)
    assert tl.dtype == torch.bfloat16 and bool(torch.isfinite(tl.float()).all())
    assert np.asarray(jl).dtype.name == "bfloat16"
