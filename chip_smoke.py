"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device  — a CUDA card is present; its name and power limit as
     ``nvidia-smi`` prints them;
  2. build   — every CUDA kernel of the serving path, from the sources in
     this checkout, for sm_90a (nvcc, one process per source);
  3. parity  — each kernel against its plain PyTorch version on the card,
     at full StarCoder2-3B widths in bf16 (B 8, Hq 24, Hkv 2, hd 128,
     page 16, 256 pages a slot): SWA window 4096 with the ring wrapped and
     not, full attention, partly and wholly inactive batches, unallocated
     pages;
  4. serve   — full-config StarCoder2-3B (random bf16 weights from seed 0)
     serves a 16-request Poisson trace through
     ``PagedServeLoop(cache_update="kernel")``; the launch counters, zeroed
     just before, prove both kernels ran on that path; one decode step
     from a mid-trace state is run through the kernels and through the
     plain versions and the two are compared;
  5. profile — torch.profiler over a few serving ticks: device time by
     kernel and the device's busy share, against the wall of those ticks
     with the profiler on and of the same ticks replayed without it;
  6. timing  — each kernel at the serve shapes against its bound, its
     plain version and, where one exists, a single PyTorch call computing
     the same function.

Prints, before the last line, one JSON object with a row per kernel and
the card's ``name, power.limit``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one card and no network; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.models.model import build_model_by_name  # noqa: E402
from repro_torch.serve import PagedServeLoop, poisson_trace  # noqa: E402
from repro_torch.serve.slots import RequestQueue  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
B, HQ, HKV, HD, PS, P = 8, 24, 2, 128, 16, 256  # StarCoder2-3B serve shapes
W = 4096
DECODE_SRC = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
# Kernel vs plain decode output, bf16: the plain version (like the JAX
# reference) rounds the q.k logits and the probabilities to bf16 before
# the PV product, the kernel keeps both in float32; both round the output
# to bf16 (half an ulp is 2^-8 relative). 2e-2 absolute covers the two
# bf16 roundings of logits that reach ~|30| before scaling.
DECODE_ATOL = DECODE_RTOL = 2e-2
# Kernel vs a float32 evaluation of the plain version on the same inputs:
# only the kernel's bf16 output rounding (relative 2^-8 at most) and the
# float32 summation order separate them.
DECODE_F32_ATOL, DECODE_F32_RTOL = 1e-3, 2.0**-8
# One whole decode step of the 30-layer model, kernel path vs plain path:
# the per-layer bf16 differences above feed the residual stream of every
# later layer; logits have std ~1 at this init.
STEP_LOGITS_ATOL = 1e-1


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def sync():
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed nothing")
    print(f"[device] {out[0]}  torch {torch.__version__} cuda {torch.version.cuda}")
    return out[0]


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"[build] {json.dumps(secs)} in {time.perf_counter() - t0:.2f} s")
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {log.stem}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. parity at full widths
# ---------------------------------------------------------------------------


def _page_table(gen, n_pages, pages_needed):
    """Distinct pages per slot; each slot gets the pages its rows need and
    -1 after them."""
    perm = torch.randperm(n_pages, generator=gen, device=gen.device)[:B * P]
    perm = perm.view(B, P).to(torch.int32)
    for b in range(B):
        perm[b, pages_needed[b]:] = -1
    return perm


def decode_case(gen, dev, pos, active, window, tag):
    n_pages = B * P + 3
    need = []
    for p in pos:
        rows = min(p + 64, window) if window else min(p + 64, P * PS)
        need.append(-(-rows // PS))
    pt = _page_table(gen, n_pages, need)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, kn, vn = rnd(B, HQ, HD), rnd(B, HKV, HD), rnd(B, HKV, HD)
    kp, vp = rnd(n_pages, PS, HKV, HD), rnd(n_pages, PS, HKV, HD)
    posd = torch.tensor(pos, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.bool, device=dev)
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o_k = pa_ops.paged_decode_attention(q, kk, vk, kn, vn, pt, posd, window=window,
                                        active=act)
    sync()
    o_r = pa_ref.paged_decode_attention(q, kr, vr, kn, vn, pt, posd, act, window=window)
    o_32 = pa_ref.paged_decode_attention(q.float(), kp.float(), vp.float(), kn.float(),
                                         vn.float(), pt, posd, act, window=window)
    sync()
    require(torch.equal(kk, kr) and torch.equal(vk, vr),
            f"[parity] decode {tag}: pools differ from the plain version")
    require(bool(torch.isfinite(o_k).all()), f"[parity] decode {tag}: non-finite output")
    err = (o_k.float() - o_r.float()).abs().max().item()
    err32 = (o_k.float() - o_32).abs().max().item()
    ok = torch.allclose(o_k.float(), o_r.float(), atol=DECODE_ATOL, rtol=DECODE_RTOL)
    require(ok, f"[parity] decode {tag}: max |kernel - plain| {err}")
    require(torch.allclose(o_k.float(), o_32, atol=DECODE_F32_ATOL, rtol=DECODE_F32_RTOL),
            f"[parity] decode {tag}: max |kernel - f32| {err32}")
    print(f"[parity] decode {tag}: pools bitwise; max|o - plain| {err:.3e} "
          f"max|o - plain f32| {err32:.3e}")
    return err


def insert_case(gen, dev, L, n_alloc, tag):
    n_pages = B * P
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    kp, vp = rnd(L, n_pages, PS, HKV, HD), rnd(L, n_pages, PS, HKV, HD)
    ks, vs = rnd(L, P, PS, HKV, HD), rnd(L, P, PS, HKV, HD)
    ids = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ids[:n_alloc] = torch.randperm(n_pages, generator=gen, device=dev)[:n_alloc].to(torch.int32)
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    pa_ops.paged_insert(kk, vk, ks, vs, ids)
    sync()
    pa_ref.paged_insert(kr, vr, ks, vs, ids)
    sync()
    err = max((kk.float() - kr.float()).abs().max().item(),
              (vk.float() - vr.float()).abs().max().item())
    require(torch.equal(kk, kr) and torch.equal(vk, vr),
            f"[parity] insert {tag}: pools differ from the plain version (max {err})")
    print(f"[parity] insert {tag}: bitwise")
    return err


def phase_parity(dev):
    gen = torch.Generator(device=dev).manual_seed(1234)
    part = [True, True, False, True, True, True, False, True]
    errs = [
        decode_case(gen, dev, [5, 100, 1500, 4095, 4096, 5000, 9000, 123], part, W,
                    "window 4096, ring wrapped and not, partly active"),
        decode_case(gen, dev, [0, 17, 300, 1000, 2047, 4095, 50, 3000], part, 0,
                    "full attention, partly active"),
        decode_case(gen, dev, [7, 4200, 64, 900, 16, 4097, 1, 2048], [False] * B, W,
                    "window 4096, all inactive"),
        decode_case(gen, dev, [15, 16, 31, 4111, 255, 8191, 4096, 12], [True] * B, W,
                    "window 4096, page edges, all active"),
    ]
    ins = max(insert_case(gen, dev, 30, 72, "30 layers, 72 of 256 pages"),
              insert_case(gen, dev, 30, 0, "30 layers, no page allocated"))
    return {"paged_decode": max(errs), "paged_insert": ins}


# ---------------------------------------------------------------------------
# 4. serve the full model
# ---------------------------------------------------------------------------


def phase_serve(dev):
    t0 = time.perf_counter()
    model = build_model_by_name("starcoder2-3b", device=dev)
    cfg = model.config
    params = model.init(0)
    sync()
    n_params = sum(t.numel() for t in params.values())
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params {cfg.param_dtype}, "
          f"init {time.perf_counter() - t0:.1f} s")
    trace_kw = dict(rate=2.0, plen_choices=(128, 256, 512, 1024),
                    max_new_choices=(32, 64, 128), vocab_size=cfg.vocab_size, seed=0)
    reqs = poisson_trace(16, **trace_kw)
    loop = PagedServeLoop(model, params, device=dev, n_slots=B, page_size=PS,
                          cache_update="kernel")
    # warm-up on two short requests (cuBLAS handles, allocator), not counted
    loop.run(poisson_trace(2, rate=2.0, plen_choices=(128,), max_new_choices=(4,),
                           vocab_size=cfg.vocab_size, seed=1))
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    pa_ops.reset_launches()
    stats = loop.run(reqs)
    sync()
    launches = dict(pa_ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for r in reqs:
        require(r.failed is None, f"[serve] request {r.rid} failed: {r.failed}")
        require(len(r.out) == r.max_new, f"[serve] request {r.rid}: {len(r.out)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.out),
                f"[serve] request {r.rid}: token outside the vocabulary")
    require(launches["paged_decode"] == cfg.num_layers * stats["decode_dispatches"],
            f"[serve] decode launches {launches} vs {stats['decode_dispatches']} ticks")
    require(launches["paged_insert"] == stats["prefill_dispatches"] == len(reqs),
            f"[serve] insert launches {launches} vs {stats['prefill_dispatches']} admissions")
    require(launches["paged_decode"] > 0 and launches["paged_insert"] > 0,
            "[serve] a kernel of the path never launched")
    serve = dict(
        tokens=stats["tokens"], wall_s=stats["wall_s"], tok_s=stats["tok_s"],
        ticks=stats["decode_dispatches"],
        ms_per_tick=1e3 * stats["decode_s"] / stats["decode_dispatches"],
        prefill_ms=1e3 * stats["prefill_s"] / stats["prefill_dispatches"],
        peak_mem_gb=peak_gb, launches=launches, peak_pages=stats["peak_pages"],
        n_pages=stats["n_pages"])
    print(f"[serve] {json.dumps(serve)}")

    to_mid_trace(loop, reqs)
    require(int(loop.table.active.sum()) >= 2, "[serve] mid-trace state has < 2 live slots")
    state = mid_state(loop)
    step_check(model, params, loop, state)
    return model, params, loop, reqs, state, serve


def to_mid_trace(loop, reqs, n_ticks=24):
    """Replay the trace from a fresh slot table for ``n_ticks`` ticks; greedy
    and arrivals counted in ticks, so every replay reaches the same state."""
    loop.reset()
    loop.tick(RequestQueue([r.clone() for r in reqs]))
    for _ in range(n_ticks - 1):
        loop.tick()


def mid_state(loop):
    t = loop.table
    def dt(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=loop.device)
    return dict(page_table=dt(loop.page_table, torch.int32), tok=dt(t.last_tok, torch.int32),
                pos=dt(t.pos, torch.int32), active=dt(t.active, torch.bool))


def step_check(model, params, loop, st):
    """One decode step from one cache state, kernels vs plain versions."""
    base = loop.cache
    ck = type(base)(kv=type(base.kv)(base.kv.k.clone(), base.kv.v.clone()))
    cs = type(base)(kv=type(base.kv)(base.kv.k.clone(), base.kv.v.clone()))
    args = (st["page_table"], st["tok"], st["pos"])
    lk, _ = model.paged_decode_step(params, ck, *args, cache_update="kernel",
                                    active=st["active"])
    ls, _ = model.paged_decode_step(params, cs, *args, cache_update="scatter",
                                    active=st["active"])
    sync()
    act = st["active"]
    require(bool(torch.isfinite(lk[act]).all()), "[serve] non-finite kernel-path logits")
    err = (lk[act].float() - ls[act].float()).abs().max().item()
    agree = (lk[act].argmax(-1) == ls[act].argmax(-1)).float().mean().item()
    require(err <= STEP_LOGITS_ATOL, f"[serve] step logits max|kernel - plain| {err}")
    # the rows this step wrote: layer 0 got identical k_new on both paths,
    # deeper layers inherit the attention differences
    pos = st["pos"].long()
    idx = pos % W
    phys = st["page_table"].long().gather(1, (idx // PS)[:, None])[:, 0]
    wrote = act & (phys >= 0)
    rows = (phys[wrote], idx[wrote] % PS)
    for name, a, b in (("k", ck.kv.k, cs.kv.k), ("v", ck.kv.v, cs.kv.v)):
        require(torch.equal(a[0], b[0]), f"[serve] layer-0 {name} pool differs")
        new_a, new_b = a[:, rows[0], rows[1]].clone(), b[:, rows[0], rows[1]].clone()
        a[:, rows[0], rows[1]] = 0
        b[:, rows[0], rows[1]] = 0
        require(torch.equal(a, b), f"[serve] {name} pool differs outside this step's rows")
        d = (new_a.float() - new_b.float()).abs().max().item()
        print(f"[serve] step {name} pool: bitwise but for this step's rows at layers >= 1 "
              f"(max diff {d:.3e})")
    print(f"[serve] step logits: max|kernel - plain| {err:.3e} (tol {STEP_LOGITS_ATOL}), "
          f"argmax agreement {agree:.3f} over {int(act.sum())} live slots")


# ---------------------------------------------------------------------------
# 5. where a serving tick's time goes
# ---------------------------------------------------------------------------


def phase_profile(loop, reqs, n_ticks=8):
    """torch.profiler over ``n_ticks`` ticks from the mid-trace state: device
    time by kernel and the device's busy share. The profiler slows the host,
    so the same ticks, replayed from the same state, are also timed without
    it, and the busy share is given against both walls."""
    from torch.profiler import ProfilerActivity, profile

    to_mid_trace(loop, reqs)
    prefills = loop.prefill_dispatches
    sync()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        loop.tick()
    sync()
    plain_wall_us = 1e6 * (time.perf_counter() - t0)
    prefills_plain = loop.prefill_dispatches - prefills
    to_mid_trace(loop, reqs)
    prefills = loop.prefill_dispatches
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            loop.tick()
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel rows only: an operator's row repeats the time of its kernels
    by_kernel = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                       key=lambda r: -r[1])
    busy_us = sum(t for _, t, _ in by_kernel)
    out = dict(ticks=n_ticks, prefills=loop.prefill_dispatches - prefills,
               prefills_unprofiled=prefills_plain,
               wall_ms_per_tick=wall_us / n_ticks / 1e3,
               wall_ms_per_tick_unprofiled=plain_wall_us / n_ticks / 1e3,
               device_busy_ms_per_tick=busy_us / n_ticks / 1e3,
               device_busy_share=busy_us / wall_us if busy_us else None,
               device_busy_share_unprofiled=busy_us / plain_wall_us if busy_us else None,
               top=[(k[:60], round(t / n_ticks / 1e3, 4), c) for k, t, c in by_kernel[:10]])
    if busy_us == 0:  # a measurement, not a check: CUPTI may be unavailable
        print("[profile] the profiler recorded no device time; see [timing] instead")
    print(f"[profile] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# 6. timing
# ---------------------------------------------------------------------------


def time_ms(fn, n=50, warmup=5):
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each
    launch (in serving, a layer's weights pass through L2 between two
    launches of a kernel)."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    sync()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    sync()
    return sum(s.elapsed_time(e) for s, e in ev) / n


def phase_timing(model, loop, st, launches, errs):
    cfg, dev = model.config, loop.device
    pool_k, pool_v = loop.cache.kv.k[0], loop.cache.kv.v[0]
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(pool_k.dtype)

    q, kn, vn = rnd(B, HQ, HD), rnd(B, HKV, HD), rnd(B, HKV, HD)
    pt, pos, act = st["page_table"], st["pos"], st["active"]
    valid = pa_ref.slot_valid(pt, pos, PS, W)
    n_rows = int(valid.sum())
    n_write = int((act & (pt.long().gather(1, ((pos.long() % W) // PS)[:, None])[:, 0] >= 0)).sum())
    el = pool_k.element_size()
    dec_bytes = (2 * B * HQ * HD * el  # q in, o out
                 + 2 * B * HKV * HD * el  # k_new, v_new
                 + pt.numel() * 4 + 2 * B * 4  # page table, pos, active
                 + 2 * n_rows * HKV * HD * el  # K and V rows of valid entries
                 + 2 * n_write * HKV * HD * el)  # the written rows
    dec_ops = 2 * 2 * n_rows * HKV * (HQ // HKV) * HD  # q.k and p.v
    ker = lambda: pa_ops.paged_decode_attention(q, pool_k, pool_v, kn, vn, pt, pos,  # noqa: E731
                                                window=W, active=act)
    pln = lambda: pa_ref.paged_decode_attention(q, pool_k, pool_v, kn, vn, pt, pos,  # noqa: E731
                                                act, window=W)
    rows = []
    ms = time_ms(ker)
    plain = time_ms(pln)
    rows.append(dict(
        name="paged_decode", route="cuda", source=DECODE_SRC,
        replaces="src/repro/kernels/paged_attention/kernel.py:64",
        launches=launches["paged_decode"], max_abs_err=errs["paged_decode"],
        ms=ms, plain_ms=plain,
        bound_ms=1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_ops / BF16_OPS_PER_S),
        bound_by="bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_ops / BF16_OPS_PER_S
        else "operations",
        library_ms=None))
    print(f"[timing] paged_decode: {n_rows} valid rows over {B} slots, {n_write} writes, "
          f"{dec_bytes} bytes")

    # insert: one admission of the trace's largest request (plen 1024 +
    # max_new 128 - 1 rows = 72 pages) into the serve pool
    L = cfg.num_layers
    n_alloc = min(-(-(1024 + 128 - 1) // PS), P)
    ks, vs = rnd(L, P, PS, HKV, HD), rnd(L, P, PS, HKV, HD)
    ids = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ids[:n_alloc] = torch.randperm(loop.n_pages, generator=gen,
                                   device=dev)[:n_alloc].to(torch.int32)
    okm = ids >= 0
    ids_ok, ks_ok, vs_ok = ids[okm].long(), ks[:, okm].contiguous(), vs[:, okm].contiguous()
    pk, pv = loop.cache.kv.k, loop.cache.kv.v
    ins_bytes = 2 * 2 * n_alloc * L * PS * HKV * HD * el + P * 4
    rows.append(dict(
        name="paged_insert", route="cuda", source=DECODE_SRC,
        replaces="src/repro/kernels/paged_attention/kernel.py:210",
        launches=launches["paged_insert"], max_abs_err=errs["paged_insert"],
        ms=time_ms(lambda: pa_ops.paged_insert(pk, pv, ks, vs, ids)),
        plain_ms=time_ms(lambda: pa_ref.paged_insert(pk, pv, ks, vs, ids)),
        bound_ms=1e3 * ins_bytes / HBM_BYTES_PER_S, bound_by="bytes",
        library_ms=time_ms(lambda: (pk.index_copy_(1, ids_ok, ks_ok),
                                    pv.index_copy_(1, ids_ok, vs_ok)))))
    for r in rows:
        print(f"[timing] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    errs = phase_parity(dev)
    model, params, loop, reqs, state, serve = phase_serve(dev)
    prof = phase_profile(loop, reqs)
    rows = phase_timing(model, loop, state, serve["launches"], errs)
    print(json.dumps({"serve": serve, "profile": prof, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
