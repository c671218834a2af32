"""The port's CUDA kernels against their plain versions, on a CUDA card.

Imports torch and the port only (no JAX), so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a card every test skips (the kernels have no CPU mode). Bars:
pools bitwise; outputs 1e-5 in float32, 2e-2 in bf16 (the plain version
rounds logits and probabilities to bf16, the kernel keeps float32), and
two decode launches on one input bitwise equal;
vecavg 1e-6 in float32 and 2e-2 in bf16 with norms at rtol 1e-4 (the bars
of tests/test_kernels.py), two launches on one input bitwise equal, and
its division folded in bitwise equal to dividing first;
flash attention 2e-5 in float32 and 3e-2 in bf16 (tests/test_kernels.py's
flash bars), rows with no live key exactly 0, two launches bitwise equal; rmsnorm 1e-5 in float32
(tests/test_kernels.py's bar) and one bf16 ulp of the output in bf16
(kernel and plain version each round their own float32 result, which may
differ in the last float32 bit: the sums of squares run in other orders),
two launches on one input bitwise equal. The engine's cohort round and the
prototype server's two reduces through vecavg against the plain tree
reduce: 1e-6, with their launch counts. The client-axis sharded round on
2 gloo ranks sharing the card against the unsharded round: params 1e-6,
the per-client statistics rtol 1e-5 / atol 1e-6 (tests/test_sharded_round.py's
bars), vecavg twice on each rank.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as tref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.vecavg import ops as va_ops
from repro_torch.kernels.vecavg import ref as va_ref

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


# (window, pos of the 4 slots): P 256 pages of 16 a slot, so the wrapper
# splits each (slot, kv head) across ~33 blocks; the short slots leave most
# splits with no live key, window 16 all but split 0, and window 4096 wraps
# the ring of slots 2 and 3
SPLIT_POS = {0: [5, 700, 2050, 4095], 16: [3, 15, 40, 1000],
             4096: [5, 700, 5000, 9000]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16, 4096])
@pytest.mark.parametrize("G", [1, 12])
def test_decode_split_kernel_matches_plain_on_card(cuda, dtype, window, G):
    """The split page walk: -1 pages inside the live ranges (so inside
    splits), an inactive slot, pools bitwise, outputs within the bars, and
    two launches on fresh clones bitwise equal."""
    B, Hkv, hd, ps, P = 4, 2, 128, 16, 256
    arrs, pt = _scenario(300 + G + window, B, G * Hkv, Hkv, hd, B * P + 3, P, ps)
    for b, p in ((1, 7), (2, 1), (2, 100), (3, 33)):
        pt[b, p] = -1
    pos = torch.tensor(SPLIT_POS[window], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    dev = [torch.from_numpy(a).to(cuda, dtype) for a in arrs]
    ptd = torch.from_numpy(pt).to(cuda)
    outs, pools = [], []
    for _ in range(2):
        ker = [t.clone() for t in dev]
        before = pa_ops.launches["paged_decode"]
        outs.append(pa_ops.paged_decode_attention(*ker, ptd, pos, window=window,
                                                  active=active))
        assert pa_ops.launches["paged_decode"] == before + 1
        pools.append(ker[1:3])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa_ops.last_decode["splits"] == pa_ops.decode_splits(
        B, Hkv, P, sms * pa_ops.last_decode["blocks_per_sm"]) > 1
    pln = [t.clone() for t in dev]
    o_p = tref.paged_decode_attention(*pln, ptd, pos, active, window=window)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for kp, vp in pools:
        assert torch.equal(kp, pln[1]) and torch.equal(vp, pln[2])
    assert bool(torch.isfinite(outs[0].float()).all())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(outs[0].float(), o_p.float(), atol=tol, rtol=tol)


def test_decode_slot_with_no_live_key_is_zero_on_card(cuda):
    """An active slot whose every page is -1 gives exactly 0; its
    neighbours match the plain version."""
    B, Hkv, hd, ps, P = 4, 2, 128, 16, 64
    arrs, pt = _scenario(400, B, 12 * Hkv, Hkv, hd, B * P + 3, P, ps)
    pt[2, :] = -1
    pos = torch.tensor([100, 900, 500, 1023], dtype=torch.int32, device=cuda)
    active = torch.ones(B, dtype=torch.bool, device=cuda)
    ker = [torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrs]
    pln = [t.clone() for t in ker]
    ptd = torch.from_numpy(pt).to(cuda)
    o = pa_ops.paged_decode_attention(*ker, ptd, pos, window=0, active=active)
    o_p = tref.paged_decode_attention(*pln, ptd, pos, active, window=0)
    torch.cuda.synchronize()
    assert torch.equal(o[2], torch.zeros_like(o[2]))
    assert torch.equal(ker[1], pln[1]) and torch.equal(ker[2], pln[2])
    torch.testing.assert_close(o.float(), o_p.float(), atol=2e-2, rtol=2e-2)


def test_decode_occupancy_from_the_kernel_on_card(cuda):
    """The kernel's C side reports its shared memory and blocks an SM: the
    float32 hd-128 page buffers (128 KB) leave room for one block, a 64-row
    page for none."""
    index = torch.cuda.current_device()
    smem, blocks = pa_ops.decode_occupancy(torch.float32, 128, 12, 16, index)
    assert (smem, blocks) == (4 * 4 * 16 * 128 * 4, 1)
    smem, blocks = pa_ops.decode_occupancy(torch.bfloat16, 128, 12, 16, index)
    assert smem == 4 * 4 * 16 * 128 * 2 and blocks >= 1
    assert pa_ops.decode_occupancy(torch.float32, 128, 12, 64, index)[1] == 0


def test_decode_raises_on_shapes_the_kernel_cannot_take(cuda):
    """A head_dim the kernel is not built for, more than 16 query heads a
    kv head, or a page whose buffers do not fit an SM, raise before any
    launch."""
    pt = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    for Hq, Hkv, hd, ps in ((4, 2, 80, 16), (34, 2, 128, 16), (4, 2, 128, 64), (68, 4, 96, 16)):
        q = torch.zeros(2, Hq, hd, device=cuda)
        pool = torch.zeros(3, ps, Hkv, hd, device=cuda)
        new = torch.zeros(2, Hkv, hd, device=cuda)
        before = pa_ops.launches["paged_decode"]
        with pytest.raises(ValueError):
            pa_ops.paged_decode_attention(q, pool, pool.clone(), new, new.clone(), pt, pos)
        assert pa_ops.launches["paged_decode"] == before


# (G, Hkv, window, P): phi-3-vision's G 1 on a short table (one split) and
# a long one (the wrapper splits the walk), and G 4 with a window that the
# ring of slot 3 has wrapped
HD96_CASES = [(1, 4, 0, 4), (1, 4, 0, 128), (4, 2, 48, 8), (4, 2, 48, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Hkv,window,P", HD96_CASES)
def test_decode_hd96_matches_plain_on_card(cuda, dtype, G, Hkv, window, P):
    """The head-dim-96 instance (a bf16 lane slice is three 8-byte vectors,
    a float32 one three 16-byte vectors): an inactive slot, an unallocated
    page inside a live range, pools bitwise, outputs within the bars, two
    launches on fresh clones bitwise equal."""
    B, hd, ps = 4, 96, 16
    arrs, pt = _scenario(960 + G + window + P, B, G * Hkv, Hkv, hd, B * P + 3, P, ps)
    pt[2, 1] = -1
    cap = min(P * ps, window) if window else P * ps
    pos = torch.tensor([3, cap // 2, cap - 1, 5 * cap + 7 if window else cap - 9],
                       dtype=torch.int32, device=cuda)
    active = torch.tensor([True, False, True, True], device=cuda)
    dev = [torch.from_numpy(a).to(cuda, dtype) for a in arrs]
    ptd = torch.from_numpy(pt).to(cuda)
    outs, pools = [], []
    for _ in range(2):
        ker = [t.clone() for t in dev]
        before = pa_ops.launches["paged_decode"]
        outs.append(pa_ops.paged_decode_attention(*ker, ptd, pos, window=window,
                                                  active=active))
        assert pa_ops.launches["paged_decode"] == before + 1
        pools.append(ker[1:3])
    pln = [t.clone() for t in dev]
    o_p = tref.paged_decode_attention(*pln, ptd, pos, active, window=window)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for kp, vp in pools:
        assert torch.equal(kp, pln[1]) and torch.equal(vp, pln[2])
    assert bool(torch.isfinite(outs[0].float()).all())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(outs[0][active].float(), o_p[active].float(), atol=tol,
                               rtol=tol)


def test_decode_hd96_occupancy_from_the_kernel_on_card(cuda):
    """The hd-96 instance's shared memory from the kernel's C side: four
    warps' double K/V page buffers, 48 KB in bf16 and 96 KB in float32 at
    page size 16, and at least one block an SM in both."""
    index = torch.cuda.current_device()
    for dtype, el in ((torch.bfloat16, 2), (torch.float32, 4)):
        smem, blocks = pa_ops.decode_occupancy(dtype, 96, 1, 16, index)
        assert smem == 4 * 4 * 16 * 96 * el and blocks >= 1


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "hymba-1.5b"])
def test_paged_tick_of_the_new_families_on_card(cuda, arch):
    """Reduced phi-3-vision widened to its head dim 96 (with patches) and
    reduced Hymba (window, SSM rows) in float32: whole PagedServeLoop ticks
    under "kernel", decode launched L times a tick and insert once an
    admission; streams equal those of the plain versions ("scatter")."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve import PagedServeLoop, poisson_trace

    cfg = get_arch(arch).reduced()
    if cfg.vision_dim:
        cfg = dataclasses.replace(cfg, d_model=192, num_heads=2, num_kv_heads=2, head_dim=96,
                                  d_ff=384)
    model = build_model(cfg, device=cuda)
    params = model.init(0)
    trace = poisson_trace(5, rate=2.0, plen_choices=(8, 20, 40), max_new_choices=(6, 12),
                          vocab_size=cfg.vocab_size, seed=4)
    if cfg.vision_dim:
        r = np.random.RandomState(5)
        for q in trace:
            q.patches = r.randn(cfg.num_patches, cfg.vision_dim).astype(np.float32)
    outs = {}
    for cu in ("scatter", "kernel"):
        reqs = [r.clone() for r in trace]
        pa_ops.reset_launches()
        stats = PagedServeLoop(model, params, device=cuda, n_slots=3, capacity=64,
                               page_size=16, cache_update=cu).run(reqs)
        outs[cu] = [r.out for r in reqs]
    assert pa_ops.launches["paged_decode"] == cfg.num_layers * stats["decode_dispatches"] > 0
    assert pa_ops.launches["paged_insert"] == stats["prefill_dispatches"] == len(trace)
    assert outs["kernel"] == outs["scatter"]


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


@pytest.mark.parametrize("C,D", [(2, 64), (5, 513), (16, 2048), (32, 100), (1, 4099),
                                 (5, 555178)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vecavg_kernel_matches_plain_on_card(cuda, C, D, dtype):
    g = torch.Generator().manual_seed(C * 100 + D)
    u = torch.randn(C, D, generator=g).to(cuda, dtype)
    p = torch.rand(C, generator=g).add_(0.1).to(cuda)
    p /= p.sum()
    va_ops.reset_launches()
    dw, sqn = va_ops.vecavg(u, p, 0.73)
    dw2, sqn2 = va_ops.vecavg(u, p, torch.tensor(0.73, device=cuda))
    dw_r, sqn_r = va_ref.vecavg(u, p, 0.73)
    torch.cuda.synchronize()
    assert va_ops.launches["vecavg"] == 2
    assert dw.dtype == dtype and torch.equal(dw, dw2) and torch.equal(sqn, sqn2)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dw.float(), dw_r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(sqn, sqn_r, atol=0, rtol=1e-4)


def test_round_reduces_launch_the_kernel_on_card(cuda):
    """On the card 'auto' and 'pallas' launch vecavg twice a round;
    'fallback' launches it never. The kernel round and the fallback round
    agree within 1e-6 (deterministic cuDNN: only the reduce differs)."""
    from repro_torch.core.fedveca import make_round_step
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("cnn-cifar10", device=cuda)
    params = model.init(0)
    g = torch.Generator().manual_seed(0)
    C, T, B = 3, 3, 4
    batches = dict(x=torch.randn(C, T, B, 32, 32, 3, generator=g).to(cuda),
                   y=torch.randint(0, 10, (C, T, B), generator=g).to(cuda, torch.int32))
    tau = torch.tensor([3, 2, 3], dtype=torch.int32, device=cuda)
    pw = torch.tensor([0.5, 0.2, 0.3], device=cuda)
    outs = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        for agg in ("auto", "pallas", "fallback"):
            va_ops.reset_launches()
            step = make_round_step(model.loss, eta=0.01, aggregator=agg)
            outs[agg] = step(params, batches, tau, pw, torch.tensor(0.05, device=cuda))
            torch.cuda.synchronize()
            assert va_ops.launches["vecavg"] == (0 if agg == "fallback" else 2), agg
    for k in params:
        assert torch.equal(outs["auto"][0][k], outs["pallas"][0][k])
        torch.testing.assert_close(outs["auto"][0][k], outs["fallback"][0][k], atol=1e-6, rtol=0)


def test_cohort_round_launches_the_kernel_on_card(cuda):
    """A cohort of 2 of 4 clients through the engine: vecavg twice a round
    under 'auto', never under 'fallback'; the two rounds agree within 1e-6
    (deterministic cuDNN: only the reduce differs) and take the same taus."""
    from repro_torch.core.controller import ControllerConfig, ControllerCore
    from repro_torch.core.engine import EngineConfig, RoundEngine
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("cnn-cifar10", device=cuda)
    params = model.init(0)
    g = torch.Generator().manual_seed(1)
    C, T, B = 4, 3, 4
    batches = dict(x=torch.randn(C, T, B, 32, 32, 3, generator=g),
                   y=torch.randint(0, 10, (C, T, B), generator=g).to(torch.int32))
    p, cohort = np.float32([0.4, 0.1, 0.3, 0.2]), np.array([1, 3], np.int32)
    outs = {}
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        for agg in ("auto", "fallback"):
            eng = RoundEngine(model.loss, EngineConfig(eta=0.01, tau_max=T, aggregator=agg),
                              controller=ControllerCore(ControllerConfig(eta=0.01, tau_max=T), C))
            st = eng.init_controller_state(params, np.array([3, 2, 3, 1], np.int32))
            va_ops.reset_launches()
            outs[agg] = eng.run_fused(params, st, p, batches=batches, cohort=cohort)
            torch.cuda.synchronize()
            assert va_ops.launches["vecavg"] == (2 if agg == "auto" else 0), agg
    (pk, sk, _, dk), (pf, sf, _, df) = outs["auto"], outs["fallback"]
    for k in params:
        torch.testing.assert_close(pk[k], pf[k], atol=1e-6, rtol=0)
    assert int(dk["tau_round_sum"]) == 3
    assert sk.ever.cpu().tolist() == [False, True, False, True]
    assert torch.equal(dk["tau_next"], df["tau_next"])


def test_sharded_cnn_round_on_two_ranks_of_the_card(cuda):
    """``fed.simulator.run_on_ranks``: 2 gloo ranks on cuda:0, 2 CNN clients
    each, one round of host batches from the seed's init, against the
    same round unsharded in this process."""
    from repro_torch.data import synthetic
    from repro_torch.fed.simulator import FederatedSimulator, FedSimConfig, run_on_ranks
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("cnn-cifar10", device=cuda)
    orig = synthetic.make_classification(64, (32, 32, 3), 10, seed=0)
    ds = [synthetic.Dataset(orig.x[i::4], orig.y[i::4]) for i in range(4)]
    cfg = FedSimConfig(rounds=1, tau_max=3, batch_size=4, eta=0.01, data_path="host")
    (r0,), (r1,) = run_on_ranks(2, "gloo", model.config, ds, [cfg])
    ref = FederatedSimulator(model, ds, cfg).run()
    for o in (r0, r1):
        assert o["launches"]["vecavg"] == 2
        for k, v in ref.params.items():
            torch.testing.assert_close(o["params"][k], v.cpu(), atol=1e-6, rtol=0)
        for k, v in ref.controller_state.vals.items():
            np.testing.assert_allclose(o["vals"][k], v.cpu().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(r0["rows"][0]["tau"], ref.rows[0]["tau"])


@pytest.mark.parametrize("mode", ["fedveca", "fedavg"])
def test_server_halves_launch_the_kernel_on_card(cuda, mode):
    """The prototype server's reduces: ``server_aggregate`` and
    ``weighted_average`` launch vecavg once a call under 'auto' and agree
    with the plain tree reduce within 1e-6 (float32 sums in another
    order)."""
    from repro_torch.core.engine import EngineConfig, RoundEngine

    g = torch.Generator().manual_seed(2)
    C = 5
    params = {k: torch.randn(s, generator=g).to(cuda) for k, s in CNN_LEAVES.items()}
    G = {k: torch.randn((C,) + s, generator=g).to(cuda) for k, s in CNN_LEAVES.items()}
    tau = torch.randint(2, 51, (C,), generator=g).to(torch.int32)
    p = torch.rand(C, generator=g).add_(0.1)
    p = p / p.sum()
    res = {}
    for agg in ("auto", "fallback"):
        eng = RoundEngine(lambda *a: None, EngineConfig(mode=mode, eta=0.01, aggregator=agg))
        va_ops.reset_launches()
        new, tau_k = eng.server_aggregate(params, G, tau, p)
        avg = eng.weighted_average(G, p)
        torch.cuda.synchronize()
        assert va_ops.launches["vecavg"] == (2 if agg == "auto" else 0), agg
        res[agg] = (new, tau_k, avg)
    for k in params:
        torch.testing.assert_close(res["auto"][0][k], res["fallback"][0][k], atol=1e-6, rtol=0)
        torch.testing.assert_close(res["auto"][2][k], res["fallback"][2][k], atol=1e-6, rtol=0)
    assert torch.equal(res["auto"][1], res["fallback"][1])


# The CNN's leaves (cnn-cifar10, D 555178): bf2 is 10 floats, 40 B a row,
# so its rows 1, 3 of C 5 are not 16-byte aligned
CNN_LEAVES = {"b1": (32,), "b2": (32,), "bf1": (256,), "bf2": (10,), "conv1": (5, 5, 3, 32),
              "conv2": (5, 5, 32, 32), "fc1": (2048, 256), "fc2": (256, 10)}
# mixed dtypes; rows of 1, 3, 10 and 1023 columns (misaligned for C > 1);
# leaves that end 1, 1023 and 952 columns into a 1024-column chunk
MIXED_LEAVES = {"a": ((1,), torch.float32), "b": ((3,), torch.bfloat16),
                "c": ((10,), torch.float32), "d": ((1023,), torch.bfloat16),
                "e": ((1025,), torch.float32), "f": ((2047,), torch.bfloat16),
                "g": ((3, 1000), torch.float32)}
VECAVG_TREES = ([("cnn", 5)] + [("mixed", C) for C in (1, 2, 5, 32, 1536)])


def _vecavg_tree(cuda, name, C, seed=0):
    g = torch.Generator().manual_seed(seed * 1000 + C)
    spec = ({k: (s, torch.float32) for k, s in CNN_LEAVES.items()} if name == "cnn"
            else MIXED_LEAVES)
    tree = {k: torch.randn((C,) + s, generator=g).to(cuda, dt) for k, (s, dt) in spec.items()}
    p = torch.rand(C, generator=g).add_(0.1).to(cuda)
    tau = torch.randint(1, 51, (C,), generator=g).to(cuda, torch.float32)
    return tree, p / p.sum(), tau


def _tree_bitwise(a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("div", [False, True])
@pytest.mark.parametrize("name,C", VECAVG_TREES)
def test_vecavg_tree_matches_plain_on_card(cuda, name, C, div):
    """The tree form, one launch a call, twice bitwise equal, against its
    plain version (which divides first, then concatenates)."""
    tree, p, tau = _vecavg_tree(cuda, name, C)
    d = tau if div else None
    scale = torch.tensor(-0.01 * 23.5, device=cuda)
    va_ops.reset_launches()
    out, sqn = va_ops.vecavg_tree(tree, p, scale, div=d)
    out2, sqn2 = va_ops.vecavg_tree(tree, p, scale, div=d)
    torch.cuda.synchronize()
    assert va_ops.launches["vecavg"] == 2
    assert _tree_bitwise(out, out2) and torch.equal(sqn, sqn2)
    want, sqn_r = va_ref.vecavg_tree({k: v.cpu() for k, v in tree.items()}, p.cpu(),
                                     scale.cpu(), None if d is None else d.cpu())
    assert list(out) == sorted(tree)
    for k in tree:
        assert out[k].dtype == want[k].dtype and out[k].shape == tree[k].shape[1:], k
        tol = 1e-6 if out[k].dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out[k].float().cpu(), want[k].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(sqn.cpu(), sqn_r, atol=0, rtol=1e-4)


@pytest.mark.parametrize("name,C", VECAVG_TREES)
def test_vecavg_div_folded_is_dividing_first_bitwise_on_card(cuda, name, C):
    """The kernel's division gives the bits of torch's x / tau before it,
    in both output trees and the norms (bf16 leaves divide into float32)."""
    tree, p, tau = _vecavg_tree(cuda, name, C, seed=1)
    folded, sqn_f = va_ops.vecavg_tree(tree, p, 0.3, div=tau)
    first = {k: x / tau.reshape((-1,) + (1,) * (x.dim() - 1)) for k, x in tree.items()}
    plain, sqn_p = va_ops.vecavg_tree(first, p, 0.3)
    torch.cuda.synchronize()
    assert _tree_bitwise(folded, plain) and torch.equal(sqn_f, sqn_p)


def test_vecavg_counter_resets_across_calls_on_card(cuda):
    """20 calls over alternating shapes (other grids, other leaf tables),
    each bitwise equal to a call on a fresh workspace: the last block set
    the counter back to 0 every time."""
    cases = [_vecavg_tree(cuda, "cnn", 5, seed=2), _vecavg_tree(cuda, "mixed", 32, seed=3),
             _vecavg_tree(cuda, "mixed", 2, seed=4)]
    fresh = []
    for tree, p, tau in cases:
        va_ops._workspaces.clear()
        fresh.append(va_ops.vecavg_tree(tree, p, 0.5, div=tau))
    for i in range(20):
        tree, p, tau = cases[i % len(cases)]
        out, sqn = va_ops.vecavg_tree(tree, p, 0.5, div=tau)
        want, want_sqn = fresh[i % len(cases)]
        assert _tree_bitwise(out, want) and torch.equal(sqn, want_sqn), i
    torch.cuda.synchronize()


def test_vecavg_leaf_cap_raises_on_card(cuda):
    p = torch.full((2,), 0.5, device=cuda)
    ok = {f"w{i:03d}": torch.ones(2, 3, device=cuda) for i in range(va_ops.MAX_LEAVES)}
    out, sqn = va_ops.vecavg_tree(ok, p, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(sqn, torch.full((2,), 3.0 * va_ops.MAX_LEAVES, device=cuda))
    assert all(torch.equal(v, torch.full((3,), -1.0, device=cuda)) for v in out.values())
    over = dict(ok, extra=torch.ones(2, 3, device=cuda))
    with pytest.raises(ValueError, match=f"cap of {va_ops.MAX_LEAVES}"):
        va_ops.vecavg_tree(over, p, 1.0)


def test_vecavg_is_one_cuda_kernel_a_call_on_card(cuda):
    """torch.profiler sees exactly one CUDA kernel per tree call (with div
    and a device scale) and per matrix call, and it is vecavg's."""
    from torch.profiler import ProfilerActivity, profile

    tree, p, tau = _vecavg_tree(cuda, "cnn", 5, seed=5)
    scale = torch.tensor(0.235, device=cuda)
    u = torch.randn(5, 555178, device=cuda)
    va_ops.vecavg_tree(tree, p, scale, div=tau)
    va_ops.vecavg(u, p, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            va_ops.vecavg_tree(tree, p, scale, div=tau)
            va_ops.vecavg(u, p, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name
               and "Memset" not in e.name]
    assert kernels, "the profiler recorded no device event"
    assert len(kernels) == 6 and all("vecavg" in k for k in kernels), kernels


# tests/test_kernels.py's flash shapes, plus rows with no live key, plus
# cases across the bf16 kernel's 128 x 128 tiles
FLASH_SHAPES = [
    (1, 128, 128, 4, 2, 32, True, 0, 0),
    (2, 200, 200, 4, 4, 16, True, 64, 0),
    (1, 64, 256, 2, 1, 32, True, 0, 192),  # q_offset, Sq < Sk
    (2, 128, 128, 8, 2, 64, False, 0, 0),
    (1, 257, 257, 2, 2, 128, True, 100, 0),  # ragged block edges
    (1, 16, 16, 2, 1, 16, False, 4, 10),  # rows past position 18 have no live key
    (1, 96, 96, 4, 2, 32, True, 0, 0),  # tests/test_kernels.py::test_flash_attention_dtypes
    (1, 300, 450, 4, 2, 128, True, 0, 150),  # Sq, Sk not multiples of 128
    (2, 333, 333, 6, 2, 64, True, 0, 0),
    (1, 512, 512, 2, 1, 128, True, 200, 0),  # the window's edge cuts KV tiles mid-way
    (1, 1024, 1024, 2, 1, 128, True, 700, 0),  # q tiles with KV tiles wholly inside the window
    (1, 640, 640, 24, 2, 128, True, 256, 0),  # G 12, as StarCoder2-3B
    (1, 200, 200, 4, 2, 16, False, 0, 0),  # each head dim without a mask
    (1, 200, 200, 4, 2, 32, False, 0, 0),
    (1, 200, 200, 4, 2, 64, False, 0, 0),
    (1, 200, 200, 4, 2, 128, False, 0, 0),
    (1, 4096, 4096, 25, 5, 64, True, 2048, 0),  # Hymba-1.5B: G 5, hd 64, window 2048
    (1, 4096, 4096, 16, 16, 128, True, 0, 0),  # Qwen1.5-MoE-A2.7B
    (1, 200, 200, 4, 2, 96, False, 0, 0),  # hd 96: three 32-column blocks
    (1, 300, 450, 4, 2, 96, True, 0, 150),  # ragged Sq, Sk around the 128-row tiles
    (2, 640, 640, 8, 2, 96, True, 256, 0),  # G 4, the window's edge inside tiles
    (1, 16, 16, 2, 1, 96, False, 4, 10),  # rows with no live key
    (1, 4096, 4096, 32, 32, 96, True, 0, 0),  # phi-3-vision-4.2B
]


# bf16 kernel vs the plain version in float32 on the upcast inputs, each
# element relative to s = sum_j p_j |v_j| / l: the kernel's two bf16
# roundings (P before P V, the output) give at most 2^-7 s (chip_smoke.py's
# FLASH_BF16_F32_REL).
FLASH_BF16_F32_REL = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,qoff", FLASH_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, B, Sq, Sk, Hq, Hkv, hd, causal,
                                            window, qoff):
    g = torch.Generator().manual_seed(Sq + Sk)
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(cuda, dtype)
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    fa_ops.reset_launches()
    o = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches["flash_attention"] == 1
    o_r = fa_ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(o.float(), o_r.float(), atol=tol, rtol=0)
    empty = ~fa_ref.live_mask(Sq, Sk, device=cuda, **kw).any(1)
    assert (o[:, empty] == 0).all()
    if dtype == torch.bfloat16:
        from repro_torch import strict_fp32
        with strict_fp32():
            q32, k32, v32 = q.float(), k.float(), v.float()
            o32 = fa_ref.attention(q32, k32, v32, **kw)
            s = fa_ref.attention(q32, k32, v32.abs(), **kw).clamp_min(1e-30)
        rel = ((o.float() - o32).abs() / s).max().item()
        assert rel <= FLASH_BF16_F32_REL, rel


# float32 cases across the 3xTF32 kernel's edges: 64-row q tiles, KV tiles
# of 32 keys at hd 96 and 128 and 64 below, 16-byte copies (q, k, v
# contiguous) and 4-byte copies (misalign 1: each base 4 bytes past 16-byte
# alignment); hd 96 copies its rows as 64 columns, then 32
FLASH_F32_EDGES = [
    # B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, misalign
    (1, 77, 77, 4, 2, 128, True, 0, 0, 0),  # Sq, Sk not multiples of the tiles
    (2, 100, 150, 2, 2, 64, False, 0, 0, 0),
    (1, 50, 131, 4, 4, 64, True, 0, 81, 0),  # q_offset > 0, Sq < Sk, G 1
    (1, 90, 300, 12, 1, 128, True, 100, 210, 0),  # and a window, G 12
    (1, 300, 300, 2, 1, 128, True, 45, 0, 0),  # the window's edge inside a 32-key tile
    (1, 300, 300, 4, 4, 64, True, 45, 0, 0),  # ... inside a 64-key tile
    (1, 200, 200, 12, 1, 32, True, 70, 0, 0),
    (1, 130, 130, 2, 2, 16, True, 0, 0, 0),
    (1, 130, 130, 2, 1, 32, False, 0, 0, 0),
    (1, 16, 16, 2, 1, 16, False, 4, 10, 0),  # rows past position 18 have no live key
    (1, 77, 77, 4, 2, 128, True, 0, 0, 1),
    (2, 100, 150, 4, 1, 64, False, 30, 60, 1),
    (1, 64, 64, 2, 2, 16, True, 0, 0, 1),
    (1, 200, 200, 12, 1, 32, True, 45, 0, 1),
    (1, 77, 77, 4, 2, 96, True, 0, 0, 0),
    (1, 300, 300, 2, 1, 96, True, 45, 0, 0),  # the window's edge inside a 32-key tile
    (1, 90, 300, 12, 1, 96, True, 100, 210, 0),  # q_offset, Sq < Sk, G 12
    (1, 77, 77, 4, 2, 96, True, 0, 0, 1),
    (2, 100, 150, 4, 1, 96, False, 30, 60, 1),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,qoff,misalign", FLASH_F32_EDGES)
def test_flash_f32_kernel_edges_on_card(cuda, B, Sq, Sk, Hq, Hkv, hd, causal, window, qoff,
                                        misalign):
    """The float32 kernel against the plain version under strict_fp32() at
    2e-5, rows with no live key exactly 0, two launches bitwise equal, and
    4-byte copies bitwise equal to 16-byte copies of the same values."""
    from repro_torch import strict_fp32

    g = torch.Generator().manual_seed(7 * Sq + Sk + hd)

    def make(S, H):
        n = B * S * H * hd
        return torch.randn(n + misalign, generator=g).to(cuda)[misalign:].view(B, S, H, hd)

    q, k, v = make(Sq, Hq), make(Sk, Hkv), make(Sk, Hkv)
    assert all((t.data_ptr() % 16 != 0) == bool(misalign) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    fa_ops.reset_launches()
    o = fa_ops.flash_attention(q, k, v, **kw)
    o2 = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches["flash_attention"] == 2
    with strict_fp32():
        o_r = fa_ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert torch.equal(o, o2)
    torch.testing.assert_close(o, o_r, atol=2e-5, rtol=0)
    empty = ~fa_ref.live_mask(Sq, Sk, device=cuda, **kw).any(1)
    assert (o[:, empty] == 0).all()
    if misalign:
        o_a = fa_ops.flash_attention(q.clone(), k.clone(), v.clone(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, o_a)


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_flash_f32_long_rows_of_offset_values_on_card(cuda, hd):
    """v = 3 + randn over up to 4096 keys a row, so that |o| ~ 3: the
    tensor cores' float32 accumulation truncates, and summed over every key
    of a row in one accumulator it shrinks o by ~1e-4 of itself, past the
    2e-5 bar; the kernel keeps that sum on the CUDA cores."""
    from repro_torch import strict_fp32

    g = torch.Generator().manual_seed(hd)
    q = torch.randn(1, 512, 4, hd, generator=g).to(cuda)
    k = torch.randn(1, 4096, 2, hd, generator=g).to(cuda)
    v = (3.0 + torch.randn(1, 4096, 2, hd, generator=g)).to(cuda)
    kw = dict(causal=True, window=0, q_offset=4096 - 512)
    o = fa_ops.flash_attention(q, k, v, **kw)
    with strict_fp32():
        o_r = fa_ref.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_r, atol=2e-5, rtol=0)


def test_flash_kernel_reads_strided_layout_and_counts_launches(cuda):
    """q, k, v as views into one fused [B, S, Hq + 2 Hkv, hd] projection:
    the kernel reads the strides in place and equals the contiguous call."""
    g = torch.Generator().manual_seed(3)
    fused = torch.randn(2, 150, 8 + 2 * 2, 64, generator=g).to(cuda)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert not q.is_contiguous()
    fa_ops.reset_launches()
    o = fa_ops.flash_attention(q, k, v, window=40)
    o_c = fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=40)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == 2
    assert torch.equal(o, o_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_two_launches_bitwise_equal(cuda, dtype):
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, 700, 12, 128, generator=g).to(cuda, dtype)
    k, v = (torch.randn(1, 700, 1, 128, generator=g).to(cuda, dtype) for _ in range(2))
    o = fa_ops.flash_attention(q, k, v, window=300)
    o2 = fa_ops.flash_attention(q, k, v, window=300)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)


def test_flash_bf16_raises_where_tma_cannot_read(cuda):
    """bf16 reads q, k, v by TMA: a head stride of 68 elements (136 bytes)
    or a base address 2 bytes off raise; float32 (no TMA) takes both."""
    g = torch.Generator().manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        wide = torch.randn(1, 40, 2, 68, generator=g).to(cuda, dtype)[..., :64]
        flat = torch.randn(1 + 40 * 2 * 64, generator=g).to(cuda, dtype)[1:].view(1, 40, 2, 64)
        for q in (wide, flat):
            k = torch.randn(1, 40, 2, 64, generator=g).to(cuda, dtype)
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="TMA"):
                    fa_ops.flash_attention(q, k, k)
            else:
                o = fa_ops.flash_attention(q, k, k)
                torch.testing.assert_close(o, fa_ref.attention(q, k, k), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_unsupported_head_dim_raises_naming_the_list_on_card(cuda, dtype):
    """hd 96 has its instances; hd 80 has none, and the call raises naming
    the head dims there are (no launch, no plain version)."""
    fa_ops.reset_launches()
    q = torch.zeros(1, 8, 2, 80, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match=r"head_dim 80 not in \(16, 32, 64, 96, 128\)"):
        fa_ops.flash_attention(q, q, q)
    assert fa_ops.launches["flash_attention"] == 0
    q = torch.randn(1, 8, 2, 96, device=cuda).to(dtype)
    assert fa_ops.flash_attention(q, q, q).shape == q.shape
    assert fa_ops.launches["flash_attention"] == 1


def test_flash_kernel_raises_rather_than_falls_back(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)  # head_dim 48 has no kernel
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    x = torch.zeros(1, 8, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(x, x, x)
    q = torch.zeros(1, 8, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, q.detach(), q.detach()).sum().backward()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen1.5-32b"])
def test_pallas_forward_matches_direct_on_card(cuda, arch):
    """Reduced models in float32 on the card, S past the reduced window:
    forward through the kernel against the direct path, one launch a layer."""
    from repro_torch import strict_fp32
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name(arch, reduced=True, device=cuda)
    params = model.init(0)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, model.config.vocab_size, (2, 150), generator=g).to(cuda)}
    with strict_fp32():
        fa_ops.reset_launches()
        lp, _ = model.forward(params, batch, impl="pallas")
        assert fa_ops.launches["flash_attention"] == model.config.num_layers
        ld, _ = model.forward(params, batch, impl="direct")
    torch.testing.assert_close(lp, ld, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "hymba-1.5b",
                                  "xlstm-1.3b"])
def test_family_forward_on_card_matches_cpu_port(cuda, arch):
    """The reduced MoE, hybrid and xLSTM models on the card in float32
    (``impl="pallas"``: the flash and rmsnorm kernels) against the port's
    CPU path (held against the JAX package by tests/test_torch_families.py)
    at the model-level bar 2e-4, the aux loss at 1e-6; two card forwards
    bitwise equal in float32 and in bf16 (the MoE combine has no atomics)."""
    import dataclasses

    from repro_torch import strict_fp32
    from repro_torch.models.model import build_model, build_model_by_name

    host = build_model_by_name(arch, reduced=True, device="cpu")
    cfg = host.config
    params = host.init(0)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 150), generator=g)}
    card = build_model(cfg, device=cuda)
    pc = {k: v.to(cuda) for k, v in params.items()}
    bc = {k: v.to(cuda) for k, v in batch.items()}
    with strict_fp32():
        fa_ops.reset_launches()
        rn_ops.reset_launches()
        lc, auxc = card.forward(pc, bc, impl="pallas")
        L = cfg.num_layers if cfg.family != "ssm" else 0
        assert fa_ops.launches["flash_attention"] == L
        norms = {"rmsnorm": 2, "layernorm": 0}[cfg.norm] + 2 * cfg.hybrid_parallel_ssm
        assert rn_ops.launches["rmsnorm"] == norms * L + (cfg.norm == "rmsnorm")
        lc2, _ = card.forward(pc, bc, impl="pallas")
    lh, auxh = host.forward(params, batch, impl="pallas")
    assert torch.equal(lc, lc2)
    torch.testing.assert_close(lc.cpu(), lh, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(auxc.cpu(), auxh, atol=1e-6, rtol=0)
    bf = build_model(dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16"),
                     device=cuda)
    pb = bf.init(0)
    a, _ = bf.forward(pb, bc, impl="pallas")
    b, _ = bf.forward(pb, bc, impl="pallas")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_vlm_and_audio_forward_on_card_match_cpu_port(cuda):
    """Reduced phi-3-vision widened to head dim 96 (phi-3's) with patches,
    and reduced whisper with frames, on the card in float32 against the
    port's CPU path (held against the JAX package by tests/test_torch_vlm.py
    and tests/test_torch_encdec.py) at 2e-4: phi-3 through the hd-96 flash
    kernel (one launch a layer) and rmsnorm (2L + 1), whisper through no
    kernel."""
    import dataclasses

    from repro_torch import strict_fp32
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model

    g = torch.Generator().manual_seed(6)
    phi = dataclasses.replace(get_arch("phi-3-vision-4.2b").reduced(), d_model=192, num_heads=2,
                              num_kv_heads=2, head_dim=96, d_ff=384)
    wsp = get_arch("whisper-medium").reduced()
    cases = [(phi, "patches", (2, phi.num_patches, phi.vision_dim), phi.num_layers,
              2 * phi.num_layers + 1),
             (wsp, "frames", (2, wsp.encoder_seq, wsp.frontend_dim), 0, 0)]
    for cfg, name, shape, n_flash, n_rms in cases:
        host, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
        params = host.init(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 150), generator=g),
                 name: torch.randn(*shape, generator=g)}
        pc = {k: v.to(cuda) for k, v in params.items()}
        bc = {k: v.to(cuda) for k, v in batch.items()}
        with strict_fp32():
            fa_ops.reset_launches()
            rn_ops.reset_launches()
            lc, _ = card.forward(pc, bc, impl="pallas")
            torch.cuda.synchronize()
            assert fa_ops.launches["flash_attention"] == n_flash, cfg.name
            assert rn_ops.launches["rmsnorm"] == n_rms, cfg.name
        lh, _ = host.forward(params, batch, impl="pallas")
        torch.testing.assert_close(lc.cpu(), lh, atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


def _bf16_ulp(t):
    """One bf16 ulp at each element of ``t`` (float32 view)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _rmsnorm_close(o, o_r):
    assert o.dtype == o_r.dtype and o.shape == o_r.shape
    if o.dtype == torch.float32:
        torch.testing.assert_close(o, o_r, atol=1e-5, rtol=0)
    else:
        assert bool(((o.float() - o_r.float()).abs() <= _bf16_ulp(o_r)).all())


# tests/test_kernels.py's shapes, the LM step's rows, wide rows, and d that
# takes the element-by-element path (not a multiple of the 16-byte vector);
# odd row counts at the instances that put 2 or 4 rows in a block (d 5120
# and 7168 in bf16, d 1024 in float32)
RMSNORM_SHAPES = [(4, 7, 128), (1000, 256), (3, 64), (2048, 1024), (33, 5120), (5, 8192),
                  (9, 100), (7, 1030), (1, 1), (7, 7168), (1023, 1024), (2, 5, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g).to(cuda, dtype)
    s = (0.1 * torch.randn(shape[-1], generator=g)).to(cuda)
    rn_ops.reset_launches()
    o, o2 = rn_ops.rmsnorm(x, s), rn_ops.rmsnorm(x, s)
    o_r = rn_ref.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn_ops.launches["rmsnorm"] == 2
    assert torch.equal(o, o2)
    _rmsnorm_close(o, o_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_groups_strides_and_copies_on_card(cuda, dtype):
    """Grouped scale [4, 1024] over x [4, 512, 1024]; rows read in place at
    a stride (a view of a wider buffer, and a scale view of a stacked
    [4, 3, d] leaf); a transposed x is copied once and gives the same."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 512, 1024, generator=g).to(cuda, dtype)
    s = (0.1 * torch.randn(4, 3, 1024, generator=g)).to(cuda)[:, 1]
    assert not s.is_contiguous()
    rn_ops.reset_launches()
    o = rn_ops.rmsnorm(x, s, groups=4)
    _rmsnorm_close(o, rn_ref.rmsnorm(x, s, groups=4))
    wide = torch.randn(300, 1024 + 64, generator=g).to(cuda, dtype)
    view = wide[:, 32:32 + 1024]
    assert view.stride(0) == 1024 + 64
    torch.testing.assert_close(rn_ops.rmsnorm(view, s[0]), rn_ops.rmsnorm(view.contiguous(), s[0]),
                               atol=0, rtol=0)
    xt = torch.randn(1024, 300, generator=g).to(cuda, dtype).T
    torch.testing.assert_close(rn_ops.rmsnorm(xt, s[1]), rn_ops.rmsnorm(xt.contiguous(), s[1]),
                               atol=0, rtol=0)
    torch.cuda.synchronize()
    assert rn_ops.launches["rmsnorm"] == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1024, 5120, 7168, 8192])
def test_rmsnorm_grouped_scale_rows_at_a_stride_on_card(cuda, d, dtype):
    """Grouped scale [3, d] as rows of a stacked [3, 3, d] leaf (16-byte
    aligned, read in packs) and as a view one float off (read element by
    element), over an odd number of rows a group."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(3, 5, d, generator=g).to(cuda, dtype)
    stacked = (0.1 * torch.randn(3, 3, d, generator=g)).to(cuda)[:, 1]
    shifted = (0.1 * torch.randn(3, d + 1, generator=g)).to(cuda)[:, 1:]
    for s in (stacked, shifted):
        assert not s.is_contiguous()
        o = rn_ops.rmsnorm(x, s, groups=3)
        torch.cuda.synchronize()
        assert torch.equal(o, rn_ops.rmsnorm(x, s, groups=3))
        _rmsnorm_close(o, rn_ref.rmsnorm(x, s, groups=3))


def test_rmsnorm_vmap_grad_through_kernel_on_card(cuda):
    """The round's use: torch.func.vmap of grad over per-client scale and x.
    One launch for all clients; gradients equal autograd of the plain
    version (use_pallas=False) within 1e-5."""
    g = torch.Generator().manual_seed(6)
    C = 4
    x = torch.randn(C, 3, 128, 1024, generator=g).to(cuda)
    s = (0.1 * torch.randn(C, 1024, generator=g)).to(cuda)
    w = torch.randn(C, 3, 128, 1024, generator=g).to(cuda)

    def loss(pallas):
        return lambda s_, x_, w_: (rn_ops.rmsnorm(x_, s_, use_pallas=pallas) * w_).sum()

    rn_ops.reset_launches()
    gk = torch.func.vmap(torch.func.grad(loss(True), argnums=(0, 1)))(s, x, w)
    torch.cuda.synchronize()
    assert rn_ops.launches["rmsnorm"] == 1
    gp = torch.func.vmap(torch.func.grad(loss(False), argnums=(0, 1)))(s, x, w)
    torch.cuda.synchronize()
    assert rn_ops.launches["rmsnorm"] == 1
    torch.testing.assert_close(gk[0], gp[0], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(gk[1], gp[1], atol=1e-5, rtol=1e-4)


def test_rmsnorm_kernel_raises_rather_than_falls_back(cuda):
    with pytest.raises(ValueError, match="d="):
        rn_ops.rmsnorm(torch.zeros(2, 8193, device=cuda), torch.zeros(8193, device=cuda))
    with pytest.raises(TypeError):
        rn_ops.rmsnorm(torch.zeros(2, 64, dtype=torch.float16, device=cuda),
                       torch.zeros(64, device=cuda))
    with pytest.raises(TypeError):
        rn_ops.rmsnorm(torch.zeros(2, 64, device=cuda),
                       torch.zeros(64, dtype=torch.bfloat16, device=cuda))


def test_lm_round_launches_rmsnorm_per_norm_call_on_card(cuda):
    """A reduced Qwen1.5 (rmsnorm) FedVeca round on the card: rmsnorm
    launches once a norm call for all clients, tau_max * (4L + 1) a round
    (each gradient call's rematerialized layers run their two norms again),
    vecavg twice; the round through the kernel equals the round through the
    plain op within 1e-5 on the params."""
    import functools

    from repro_torch import strict_fp32
    from repro_torch.core.fedveca import make_round_step
    from repro_torch.models import layers
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("qwen1.5-32b", reduced=True, device=cuda)
    cfg = model.config
    params = model.init(0)
    g = torch.Generator().manual_seed(2)
    C, T, B, S = 3, 3, 2, 32
    seqs = torch.randint(0, cfg.vocab_size, (C, T, B, S + 1), generator=g).to(cuda, torch.int32)
    batches = {"tokens": seqs[..., :-1], "targets": seqs[..., 1:]}
    tau = torch.tensor([3, 2, 3], dtype=torch.int32, device=cuda)
    pw = torch.tensor([0.5, 0.2, 0.3], device=cuda)
    step = make_round_step(model.loss, eta=0.05)
    with strict_fp32():
        rn_ops.reset_launches()
        va_ops.reset_launches()
        pk, sk, _ = step(params, batches, tau, pw, torch.tensor(0.05, device=cuda))
        torch.cuda.synchronize()
        assert rn_ops.launches["rmsnorm"] == T * (4 * cfg.num_layers + 1)
        assert va_ops.launches["vecavg"] == 2
        plain = functools.partial(rn_ops.rmsnorm, use_pallas=False)
        orig, layers.rmsnorm = layers.rmsnorm, lambda x, s, eps=1e-6: plain(x, s, eps=eps)
        try:
            pp, sp, _ = step(params, batches, tau, pw, torch.tensor(0.05, device=cuda))
        finally:
            layers.rmsnorm = orig
        torch.cuda.synchronize()
    assert rn_ops.launches["rmsnorm"] == T * (4 * cfg.num_layers + 1)
    for k in params:
        torch.testing.assert_close(pk[k], pp[k], atol=1e-5, rtol=0)
    torch.testing.assert_close(sk.loss0, sp.loss0, atol=1e-6, rtol=1e-5)


def test_remat_gradients_bitwise_equal_to_none_on_card(cuda):
    """A 2-layer rmsnorm decoder (reduced Qwen1.5) under the round's
    ``vmap(grad_and_value)`` on the card: ``remat=True`` gives the
    gradients and values of ``remat=False`` bit for bit (the recompute
    launches the same kernels on the same inputs), with rmsnorm launched
    4L + 1 times against 2L + 1."""
    import functools

    from repro_torch import strict_fp32
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("qwen1.5-32b", reduced=True, device=cuda)
    cfg = model.config
    L = cfg.num_layers
    params = model.init(0)
    g = torch.Generator().manual_seed(3)
    C, B, S = 3, 2, 32
    seqs = torch.randint(0, cfg.vocab_size, (C, B, S + 1), generator=g).to(cuda, torch.int32)
    batch = {"tokens": seqs[..., :-1], "targets": seqs[..., 1:]}
    pc = {k: v.expand((C,) + v.shape) for k, v in params.items()}
    out = {}
    with strict_fp32():
        for remat in (True, False):
            vg = torch.func.vmap(torch.func.grad_and_value(
                functools.partial(model.loss, remat=remat), has_aux=True))
            rn_ops.reset_launches()
            out[remat] = vg(pc, batch)
            torch.cuda.synchronize()
            assert rn_ops.launches["rmsnorm"] == (4 if remat else 2) * L + 1, remat
    (g1, (l1, _)), (g0, (l0, _)) = out[True], out[False]
    assert torch.equal(l1, l0)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k


# ---------------------------------------------------------------------------
# the serving scheduler's pieces on the card
# ---------------------------------------------------------------------------


def test_sampler_uniforms_on_card_equal_cpu(cuda):
    """The sample stream is integer arithmetic: the card's uniforms are the
    CPU's bit for bit for the same (seed, rid, n)."""
    from repro_torch.serve.sampling import stream_bits, stream_uniforms

    rid = torch.tensor([0, 7, 123456, 2**31 - 1], dtype=torch.int32)
    n = torch.tensor([0, 3, 511, 9], dtype=torch.int32)
    for seed in (0, 5, 2**40 + 3):
        bits = stream_bits(seed, rid, n, 152064)
        assert torch.equal(stream_bits(seed, rid.to(cuda), n.to(cuda), 152064).cpu(), bits)
        u = stream_uniforms(seed, rid.to(cuda), n.to(cuda), 152064).cpu()
        assert torch.equal(u.view(torch.int64), stream_uniforms(seed, rid, n, 152064)
                           .view(torch.int64))


def _sched_model(cuda):
    from repro_torch.models.model import build_model_by_name

    model = build_model_by_name("qwen1.5-32b", reduced=True, device=cuda)
    return model, model.init(0)


def test_mask_and_scatter_pools_bitwise_on_card(cuda):
    """An admission, a chunk prefill and decode steps with an inactive slot
    under "mask" and "scatter" write the same pool bits on the card."""
    from repro_torch.models import transformer

    model, params = _sched_model(cuda)
    pt = torch.tensor([[0, 5, -1, -1], [2, 9, 4, -1], [7, -1, -1, -1]], dtype=torch.int32,
                      device=cuda)
    prompt = torch.randint(0, model.config.vocab_size, (1, 20),
                           generator=torch.Generator().manual_seed(0)).to(cuda, torch.int32)
    _, one = model.prefill(params, {"tokens": prompt}, pad_to=32)
    pools = {}
    for cu in ("mask", "scatter"):
        cache = model.init_paged_cache(3, 12, 8)
        transformer.insert_cache_pages(cache, one, 1, pt[1], cache_update=cu)
        model.paged_prefill_chunk(params, cache, pt[0],
                                  torch.arange(1, 9, dtype=torch.int32, device=cuda)[None],
                                  0, 6, cache_update=cu)
        pos = torch.tensor([6, 20, 31], dtype=torch.int32, device=cuda)
        for t in range(3):
            model.paged_decode_step(params, cache, pt,
                                    torch.tensor([3, 4, 5], device=cuda) + t, pos + t,
                                    cache_update=cu,
                                    active=torch.tensor([True, True, False], device=cuda))
        pools[cu] = cache
    torch.cuda.synchronize()
    for name in ("k", "v"):
        a, b = getattr(pools["mask"].kv, name), getattr(pools["scatter"].kv, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def test_evict_restore_round_trip_through_insert_kernel_on_card(cuda):
    """Forced preemption under "kernel": every restore re-inserts the staged
    rows through the insert kernel, and the pool pages then hold them bit for
    bit; insert launches = admissions + restores."""
    from repro_torch.serve import PagedServeLoop, poisson_trace

    class Audit(PagedServeLoop):
        restores = 0

        def _restore(self, slot, ent):
            super()._restore(slot, ent)
            row = torch.from_numpy(self.page_table[slot][:ent.pages]).long().to(cuda)
            for pool, staged in ((self.cache.kv.k, ent.k), (self.cache.kv.v, ent.v)):
                got = pool[:, row].cpu()
                assert torch.equal(got.view(torch.int32), staged[:, :ent.pages].view(torch.int32))
            self.restores += 1

    model, params = _sched_model(cuda)
    trace = poisson_trace(6, rate=1.0, plen_choices=(3, 5, 9), max_new_choices=(4, 8),
                          vocab_size=model.config.vocab_size, seed=3, prefix_families=2,
                          prefix_len=16)
    loop = Audit(model, params, device=cuda, n_slots=3, capacity=32, page_size=8, bucket=8,
                 n_pages=6, preempt=True, preempt_after=1, cache_update="kernel")
    pa_ops.reset_launches()
    stats = loop.run(trace)
    loop.check_invariants()
    assert loop.restores == stats["restore_dispatches"] == stats["preemptions"] >= 1
    assert pa_ops.launches["paged_insert"] == \
        stats["prefill_dispatches"] + stats["restore_dispatches"]
    assert pa_ops.launches["paged_decode"] == model.config.num_layers * stats["decode_dispatches"]
