"""The VLM family (phi-3-vision-4.2b) in the port against the JAX package:
config, init, the patch embedding, forward, loss, gradients and prefill on
the reduced arch, params carried across with ``repro_torch.bridge`` and
batches made with numpy.

Bars: logits and losses 2e-4, gradients 1e-5 of each leaf's largest entry,
prefill logits and caches atol 1e-5 / rtol 1e-4 and cache ``pos`` exactly
(those of tests/test_torch_families.py). The reduced arch has head dim 32;
a copy widened to head dim 96 (phi-3's) puts that head dim through
``impl="pallas"``: the flash kernel's plain version here, the Pallas kernel
in interpret mode on the JAX side. The bf16 cases hold float32 patches
through bf16 ``vision_proj`` to one bf16 ulp of the JAX package's
embedding (each rounds its own float32 product to bf16).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jtransformer
from repro.models.model import build_model_by_name as jax_build
from repro_torch import bridge
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import build_model, build_model_by_name as torch_build

torch.set_num_threads(2)

ARCH = "phi-3-vision-4.2b"
IMPLS = ["auto", "direct", "chunked", "pallas"]


def _pair(arch=ARCH):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B, S, seed, patches=True):
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (r.rand(B, S) < 0.7).astype(np.float32)}
    if patches:
        b["patches"] = r.randn(B, cfg.num_patches, cfg.vision_dim).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy()


def _hd96():
    """The reduced arch widened to phi-3's head dim: 2 heads of 96."""
    kw = dict(d_model=192, num_heads=2, num_kv_heads=2, head_dim=96, d_ff=384)
    jcfg = replace(jax_get_arch(ARCH).reduced(), **kw)
    tcfg = replace(get_arch(ARCH).reduced(), **kw)
    jp = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, tcfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def test_config_reduced_and_param_count_match_jax():
    assert ARCH in list_archs()
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    assert full.__dict__ == jfull.__dict__
    assert full.reduced().__dict__ == jfull.reduced().__dict__
    assert full.param_count() == jfull.param_count()
    assert full.reduced().param_count() == jfull.reduced().param_count()
    assert full.head_dim == 96 and full.reduced().num_patches == 4


def test_init_params_keys_shapes_and_dtypes_match_jax():
    jm, jp, tm, _ = _pair()
    want = bridge.flatten(jax.tree.map(np.asarray, jp))
    got = tm.init(0)
    assert "vision_proj" in got and sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k


def test_learned_positions_init_and_embedding_match_jax():
    """``learned_pos`` on the decoder side: ``pos_embed`` of max(encoder_seq,
    32768) rows, added to the embedding of the first S positions."""
    jcfg = replace(jax_get_arch(ARCH).reduced(), learned_pos=True)
    tcfg = replace(get_arch(ARCH).reduced(), learned_pos=True)
    jp = jtransformer.init_params(jax.random.PRNGKey(4), jcfg)
    assert ttransformer.init_params(tcfg, device="cpu")["pos_embed"].shape == (32768, 128)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    jb, tb = _batch(jcfg, 2, 24, seed=40)
    np.testing.assert_allclose(_np(ttransformer.embed_tokens(tcfg, tp, tb)),
                               np.asarray(jtransformer.embed_tokens(jcfg, jp, jb)),
                               atol=1e-6, rtol=0)
    jl, _ = jtransformer.forward(jcfg, jp, jb)
    tl, _ = ttransformer.forward(tcfg, tp, tb)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match_jax(impl):
    jm, jp, tm, tp = _pair()
    cfg = jm.config
    jb, tb = _batch(cfg, 2, 40, seed=41)
    jl, jaux = jtransformer.forward(cfg, jp, jb, impl=impl)
    tl, taux = tm.forward(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    assert float(taux) == float(jaux) == 0.0
    jloss, jmet = jtransformer.loss_fn(cfg, jp, jb, impl=impl)
    tloss, tmet = tm.loss(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tmet["ce"]), np.asarray(jmet["ce"]), atol=2e-4, rtol=2e-4)
    # the patches change the logits: they are on the path
    nl, _ = tm.forward(tp, {"tokens": tb["tokens"]}, impl=impl)
    assert not torch.allclose(nl[:, :cfg.num_patches], tl[:, :cfg.num_patches])


def test_loss_gradients_match_jax_grad():
    """``torch.func.grad`` of the loss against ``jax.grad``, every leaf, the
    vision projector included."""
    jm, jp, tm, tp = _pair()
    jb, tb = _batch(jm.config, 2, 24, seed=42)
    jg = bridge.flatten(jax.grad(lambda p: jm.loss(p, jb)[0])(jp))
    tg = torch.func.grad(lambda p: tm.loss(p, tb)[0])(tp)
    assert sorted(tg) == sorted(jg)
    assert float(np.abs(np.asarray(jg["vision_proj"])).max()) > 0
    for k, v in jg.items():
        v = np.asarray(v)
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(_np(tg[k]), v, atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("impl", ["direct", "pallas"])
def test_prefill_matches_jax(impl):
    jm, jp, tm, tp = _pair()
    jb, tb = _batch(jm.config, 2, 20, seed=43)
    jb.pop("targets"), tb.pop("targets")
    jl, jc = jm.prefill(jp, jb, pad_to=24)
    tl, tc = tm.prefill(tp, tb, impl=impl, pad_to=24)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
    np.testing.assert_allclose(_np(tc.kv.k), np.asarray(jc.kv.k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.v), np.asarray(jc.kv.v), atol=1e-5, rtol=1e-4)


def test_head_dim_96_through_pallas_matches_jax():
    """phi-3's head dim on the model path: ``impl="pallas"`` takes the flash
    kernel's plain version here and the Pallas kernel (interpret mode) in
    the JAX package; forward, loss and prefill."""
    jcfg, jp, tcfg, tp = _hd96()
    jb, tb = _batch(jcfg, 2, 40, seed=44)
    jl, _ = jtransformer.forward(jcfg, jp, jb, impl="pallas")
    tl, _ = ttransformer.forward(tcfg, tp, tb, impl="pallas")
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    jloss, _ = jtransformer.loss_fn(jcfg, jp, jb, impl="pallas")
    tloss, _ = ttransformer.loss_fn(tcfg, tp, tb, impl="pallas")
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=2e-4, rtol=2e-4)
    pb = {k: v for k, v in tb.items() if k != "targets"}
    tpl, tc = ttransformer.prefill(tcfg, tp, pb, impl="pallas")
    np.testing.assert_allclose(_np(tpl), np.asarray(jl[:, -1]), atol=2e-4, rtol=2e-4)
    jpl, jc = jtransformer.prefill(jcfg, jp, {k: v for k, v in jb.items() if k != "targets"})
    np.testing.assert_allclose(_np(tpl), np.asarray(jpl), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.k), np.asarray(jc.kv.k), atol=1e-5, rtol=1e-4)
    assert tc.kv.k.shape[-1] == 96


def test_more_patches_than_positions_are_ignored_as_in_jax():
    """The JAX quirk, kept: with num_patches (4) > S (3) the patches are
    dropped and the forward is the text-only one."""
    jm, jp, tm, tp = _pair()
    jb, tb = _batch(jm.config, 2, 3, seed=45)
    jl, _ = jtransformer.forward(jm.config, jp, jb)
    tl, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    text, _ = tm.forward(tp, {"tokens": tb["tokens"]})
    assert torch.equal(tl, text)


def test_float32_patches_into_bf16_weights_promote_as_in_jax():
    """Full-width phi-3 holds ``vision_proj`` in bf16 while the patches are
    float32: jnp promotes the product to float32 and casts it to the
    compute type (torch would raise on the mixed product). The embedding
    agrees with the JAX package's to one bf16 ulp, and differs from the
    product of patches first rounded to bf16."""
    jcfg = replace(jax_get_arch(ARCH).reduced(), param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    tcfg = replace(get_arch(ARCH).reduced(), param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jtransformer.init_params(jax.random.PRNGKey(5), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["vision_proj"].dtype == torch.bfloat16
    jb, tb = _batch(jcfg, 2, 16, seed=46)
    assert tb["patches"].dtype == torch.float32
    th = ttransformer.embed_tokens(tcfg, tp, tb)
    jh = np.asarray(jtransformer.embed_tokens(jcfg, jp, jb), np.float32)
    assert th.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jh), 1e-30))) - 7)
    assert (np.abs(_np(th) - jh) <= ulp).all()
    rounded = (tb["patches"].bfloat16() @ tp["vision_proj"]).float()
    assert not torch.equal(th[:, :tcfg.num_patches].float(), rounded)
    tl, _ = build_model(tcfg, device="cpu").forward(tp, tb, impl="pallas")
    assert tl.dtype == torch.bfloat16 and bool(torch.isfinite(tl.float()).all())
