"""The port's CUDA kernels against their plain versions, on a CUDA card.

Imports torch and the port only (no JAX), so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a card every test skips (the kernels have no CPU mode). Bars:
pools bitwise; outputs 1e-5 in float32, 2e-2 in bf16 (the plain version
rounds logits and probabilities to bf16, the kernel keeps float32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as tref

torch.set_num_threads(2)


def _scenario(seed, B, Hq, Hkv, hd, N, P, ps, n_tail_unalloc=0):
    r = np.random.RandomState(seed)
    arrs = [r.randn(*s).astype(np.float32) for s in
            ((B, Hq, hd), (N, ps, Hkv, hd), (N, ps, Hkv, hd), (B, Hkv, hd), (B, Hkv, hd))]
    pt = r.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    if n_tail_unalloc:
        pt[:, P - n_tail_unalloc:] = -1
    return arrs, pt


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("G", [1, 12])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, window, G):
    B, Hkv, hd, ps, P = 4, 2, 128, 16, 4
    arrs, pt = _scenario(G + window, B, G * Hkv, Hkv, hd, B * P + 3, P, ps,
                         n_tail_unalloc=1)
    pos = torch.tensor([0, 17, 40, 47], dtype=torch.int32)
    active = torch.tensor([True, False, True, True])
    dev = [torch.from_numpy(a).to(cuda, dtype) for a in arrs]
    ker = [t.clone() for t in dev]
    pln = [t.clone() for t in dev]
    ptd = torch.from_numpy(pt).to(cuda)
    o_k = pa_ops.paged_decode_attention(*ker, ptd, pos.to(cuda), window=window,
                                        active=active.to(cuda))
    o_p = tref.paged_decode_attention(*pln, ptd, pos.to(cuda), active.to(cuda),
                                      window=window)
    torch.cuda.synchronize()
    assert torch.equal(ker[1], pln[1]) and torch.equal(ker[2], pln[2])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o_k[active.to(cuda)].float(), o_p[active.to(cuda)].float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_insert_kernel_matches_plain_on_card(cuda, dtype):
    L, N, P, ps, Hkv, hd = 3, 9, 4, 16, 2, 128
    g = torch.Generator().manual_seed(0)
    kp, vp = (torch.randn(L, N, ps, Hkv, hd, generator=g).to(cuda, dtype) for _ in range(2))
    ks, vs = (torch.randn(L, P, ps, Hkv, hd, generator=g).to(cuda, dtype) for _ in range(2))
    ids = torch.tensor([7, -1, 2, 4], dtype=torch.int32, device=cuda)
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    pa_ops.paged_insert(kk, vk, ks, vs, ids)
    tref.paged_insert(kr, vr, ks, vs, ids)
    torch.cuda.synchronize()
    assert torch.equal(kk, kr) and torch.equal(vk, vr)


def test_kernel_wrapper_raises_rather_than_falls_back(cuda):
    q = torch.zeros(2, 4, 128, dtype=torch.int32, device=cuda)
    pool = torch.zeros(3, 16, 2, 128, dtype=torch.int32, device=cuda)
    new = torch.zeros(2, 2, 128, dtype=torch.int32, device=cuda)
    pt = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pa_ops.paged_decode_attention(q, pool, pool.clone(), new, new.clone(), pt,
                                      torch.zeros(2, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen1.5-32b"])
def test_serve_streams_kernel_equal_plain_on_card(cuda, arch):
    """Reduced models in float32 on the card: greedy streams through the
    kernels equal those through the plain versions, and both kernels ran."""
    from repro_torch.models.model import build_model_by_name
    from repro_torch.serve import PagedServeLoop, poisson_trace

    model = build_model_by_name(arch, reduced=True, device=cuda)
    params = model.init(0)
    trace = poisson_trace(6, rate=4.0, plen_choices=(8, 40), max_new_choices=(20, 40),
                          vocab_size=model.config.vocab_size, seed=3)
    outs = {}
    for cu in ("scatter", "kernel"):
        reqs = [r.clone() for r in trace]
        pa_ops.reset_launches()
        PagedServeLoop(model, params, device=cuda, n_slots=3, capacity=96, page_size=16,
                       cache_update=cu).run(reqs)
        outs[cu] = [r.out for r in reqs]
        launched = dict(pa_ops.launches)
    assert launched["paged_decode"] > 0 and launched["paged_insert"] == len(trace)
    assert outs["kernel"] == outs["scatter"]
