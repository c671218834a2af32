"""The MoE, hybrid and xLSTM decoder families, and the two dense configs
copied with them, in the port against the JAX package: configs, init,
forward, loss, gradients and MoE prefill, on the reduced archs, params
carried across with ``repro_torch.bridge`` and batches passed explicitly.

Bars: logits and losses 2e-4 (the dense tests' model-level bar,
tests/test_torch_forward.py); the routers' aux loss 1e-6 (float32 means
over another order); gradients 1e-5 of each leaf's largest entry (float32
sums in other orders through two layers); MoE prefill logits and caches at
the prefill tolerance of tests/test_torch_model.py (atol 1e-5, rtol 1e-4)
and cache ``pos`` exactly. On the CPU ``impl="pallas"`` takes flash
attention's plain version, as the JAX package's CPU tests take its
interpreted kernel.
"""
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
from repro_torch.models.model import build_model_by_name as torch_build

torch.set_num_threads(2)

NEW = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-1.3b",
       "deepseek-coder-33b", "nemotron-4-15b"]
IMPLS = ["auto", "direct", "chunked", "pallas"]


def _pair(arch):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B, S, seed):
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (r.rand(B, S) < 0.7).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", NEW)
def test_config_reduced_and_param_count_match_jax(arch):
    assert arch in list_archs()
    full, jfull = get_arch(arch), jax_get_arch(arch)
    assert full.__dict__ == jfull.__dict__
    assert full.reduced().__dict__ == jfull.reduced().__dict__
    assert full.param_count() == jfull.param_count()
    assert full.reduced().param_count() == jfull.reduced().param_count()


@pytest.mark.parametrize("arch", NEW)
def test_init_params_keys_shapes_and_dtypes_match_jax(arch):
    jm, jp, tm, _ = _pair(arch)
    want = bridge.flatten(jax.tree.map(np.asarray, jp))
    got = tm.init(0)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NEW)
def test_forward_and_loss_match_jax(arch, impl):
    """S 96 > the reduced window 64 of Hymba, so its window bites."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.config
    jb, tb = _batch(cfg, 2, 96, seed=21)
    jl, jaux = jtransformer.forward(cfg, jp, jb, impl=impl)
    tl, taux = tm.forward(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
    assert (float(taux) > 0) == cfg.is_moe
    jloss, jm_ = jtransformer.loss_fn(cfg, jp, jb, impl=impl)
    tloss, tm_ = tm.loss(tp, tb, impl=impl)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tm_["ce"]), np.asarray(jm_["ce"]), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hymba-1.5b", "xlstm-1.3b"])
def test_loss_gradients_match_jax_grad(arch):
    """``torch.func.grad`` of the port's loss against ``jax.grad``, every
    leaf (the MoE router and experts, the SSM's scan, both xLSTM cells)."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batch(jm.config, 2, 24, seed=22)
    jg = bridge.flatten(jax.grad(lambda p: jm.loss(p, jb)[0])(jp))
    tg = torch.func.grad(lambda p: tm.loss(p, tb)[0])(tp)
    assert sorted(tg) == sorted(jg)
    for k, v in jg.items():
        v = np.asarray(v)
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(_np(tg[k]), v, atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("impl", ["direct", "pallas"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_moe_prefill_with_length_matches_jax(arch, impl):
    """Right-padded prompts: the pad tokens route behind live ones
    (``token_mask``), logits come from position length-1 and padded cache
    slots get pos -1, against the JAX ``prefill``."""
    jm, jp, tm, tp = _pair(arch)
    r = np.random.RandomState(23)
    toks = r.randint(0, jm.config.vocab_size, (3, 20)).astype(np.int32)
    length = np.array([20, 13, 1], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pad_to=24,
                        length=jnp.asarray(length))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl=impl, pad_to=24,
                        length=torch.from_numpy(length))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(tc.kv.pos.numpy(), np.asarray(jc.kv.pos))
    np.testing.assert_allclose(_np(tc.kv.k), np.asarray(jc.kv.k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(tc.kv.v), np.asarray(jc.kv.v), atol=1e-5, rtol=1e-4)
    # and without length: the last position's logits
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, impl=impl)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5, rtol=1e-4)


def test_xlstm_stacks_are_super_block_by_block():
    """The reduced ("m", "s") pattern keeps [1, 1, ...] stacks, the full one
    [6, 7, ...] and [6, 1, ...], as the JAX package's ``init_params``
    (``transformer.py:86-90``); the full stack's shapes are taken from a
    one-super-block model (no 1.7 B-parameter init on the CPU)."""
    _, _, tm, tp = _pair("xlstm-1.3b")
    assert tp["xlstm/m/w_up"].shape[:2] == tp["xlstm/s/w_r"].shape[:2] == (1, 1)
    assert tp["xlstm/m_norm/bias"].shape == (1, 1, tm.config.d_model)
    from dataclasses import replace
    cfg = replace(get_arch("xlstm-1.3b"), num_layers=8, d_model=64, num_heads=4,
                  vocab_size=32, param_dtype="float32")
    p = ttransformer.init_params(cfg, device="cpu")
    assert p["xlstm/m/w_q"].shape == (1, 7, 128, 128)
    assert p["xlstm/s/w_r"].shape == (1, 1, 4, 16, 64)
    cfg = replace(cfg, num_layers=48)
    p = ttransformer.init_params(cfg, device="cpu")
    assert p["xlstm/m/w_q"].shape[:2] == (6, 7) and p["xlstm/s/b"].shape == (6, 1, 256)
