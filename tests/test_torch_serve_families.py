"""Serving every decoder family in the port against the JAX package on the
CPU: the contiguous ``ServeLoop``, ``SerialLoop`` and ``PagedServeLoop``
(dense full and SWA, MoE, hybrid, xLSTM, VLM), one ``decode_step`` a
family, recurrent prefill, the MoE chunk prefill, the serving gates, and
paged decode's plain versions at head dim 96 against the Pallas kernel in
interpret mode.

Tolerances: greedy streams and integer stats exactly; prefill and decode
logits and every cache leaf at tests/test_torch_model.py's bars (float32,
each framework with its own matmuls): logits 2e-4, caches atol 1e-5 /
rtol 1e-4, positions exactly; rows of inactive slots bit for bit
unchanged. The MoE copies take ``capacity_factor=100.0`` as the JAX
package's own parity tests do (capacity depends on which rows share a
step). The JAX loops run their default ``cache_update="mask"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.paged_attention import kernel as pa_kernel
from repro.kernels.paged_attention import ref as jref
from repro.models import transformer as jax_transformer
from repro.models.model import build_model as jax_build_model
from repro.models.model import build_model_by_name as jax_build
from repro.models.model import decode_capability as jax_decode_capability
from repro.serve import PagedServeLoop as JaxPagedServeLoop
from repro.serve import SerialLoop as JaxSerialLoop
from repro.serve import ServeLoop as JaxServeLoop
from repro.serve import ServeUnsupportedError as JaxServeUnsupportedError
from repro.serve import poisson_trace
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as tref
from repro_torch.models import transformer
from repro_torch.models.model import build_model, build_model_by_name, decode_capability
from repro_torch.serve import (PagedServeLoop, Request, SerialLoop, ServeLoop,
                               ServeUnsupportedError, serial_generate)

torch.set_num_threads(2)

# every stat of run() that is not a clock
TIMERS = ("wall_s", "tok_s", "decode_s", "prefill_s", "extend_s")
LOGITS_TOL = 2e-4


def _pair(arch):
    """The reduced config on both sides (MoE with capacity_factor 100), the
    JAX params and the same params bridged to the port."""
    if arch == "qwen2-moe-a2.7b":
        jm = jax_build_model(dataclasses.replace(jax_get_arch(arch).reduced(),
                                                 capacity_factor=100.0))
        tm = build_model(dataclasses.replace(get_arch(arch).reduced(), capacity_factor=100.0),
                         device="cpu")
    else:
        jm, tm = jax_build(arch, reduced=True), build_model_by_name(arch, reduced=True,
                                                                    device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


_PAIRS = {}


def _cached_pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = _pair(arch)
    return _PAIRS[arch]


def _trace(arch, cfg):
    """tests/test_serve_loop.py's trace; starcoder2-3b's prompts and budgets
    pass its reduced window of 64, so the ring wraps in decode; phi-3's
    requests carry seeded patches."""
    if arch == "starcoder2-3b":
        tr = poisson_trace(4, rate=1.0, plen_choices=(40, 60), max_new_choices=(8, 12),
                           vocab_size=cfg.vocab_size, seed=2)
    else:
        tr = poisson_trace(6, rate=1.0, plen_choices=(5, 9, 12, 16), max_new_choices=(2, 4, 6),
                           vocab_size=cfg.vocab_size, seed=1)
    if cfg.vision_dim:
        r = np.random.RandomState(4)
        for q in tr:
            q.patches = r.randn(cfg.num_patches, cfg.vision_dim).astype(np.float32)
    return tr


def _port_reqs(trace):
    return [Request(r.rid, r.tokens.copy(), r.max_new, r.eos_id, r.arrival,
                    None if r.patches is None else r.patches.copy()) for r in trace]


def _stats_equal(ours, theirs):
    keys = set(theirs) - set(TIMERS)
    assert keys <= set(ours)
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}


def _np(t):
    return t.detach().numpy()


def _close(t, j, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=atol, rtol=rtol)


FAMILIES = ["starcoder2-3b", "qwen1.5-32b", "hymba-1.5b", "xlstm-1.3b", "qwen2-moe-a2.7b",
            "phi-3-vision-4.2b"]
LOOP_KW = dict(n_slots=3, capacity=32, bucket=8)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_and_serial_loops_match_jax(arch):
    """The contiguous ``ServeLoop`` and ``SerialLoop`` against the JAX
    package's on one trace: greedy streams token for token, every integer
    stat exactly; the batched streams equal the serial ones."""
    jm, jp, tm, tp = _cached_pair(arch)
    trace = _trace(arch, jm.config)
    jreqs, jser = [r.clone() for r in trace], [r.clone() for r in trace]
    jstats = JaxServeLoop(jm, jp, **LOOP_KW).run(jreqs)
    # one capacity for every request: one JAX decode compile, not one a request
    jsstats = JaxSerialLoop(jm, jp, capacity=LOOP_KW["capacity"]).run(jser)
    treqs, tser = _port_reqs(trace), _port_reqs(trace)
    tstats = ServeLoop(tm, tp, device="cpu", **LOOP_KW).run(treqs)
    tsstats = serial_generate(tm, tp, tser, device="cpu", capacity=LOOP_KW["capacity"])
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [r.out for r in tser] == [r.out for r in jser]
    assert [r.out for r in treqs] == [r.out for r in tser]
    assert [len(r.out) for r in treqs] == [r.max_new for r in trace]
    _stats_equal(tstats, jstats)
    _stats_equal(tsstats, jsstats)


class _CheckedLoop(PagedServeLoop):
    """Audits refcount conservation after every tick."""

    def tick(self, queue=None):
        super().tick(queue)
        self.check_invariants()


PAGED_KW = dict(n_slots=3, capacity=32, page_size=8, bucket=8)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b", "phi-3-vision-4.2b"])
def test_paged_loop_matches_jax(arch):
    """``PagedServeLoop`` on the MoE, hybrid and VLM families against the
    JAX package's: streams, every integer stat, invariants every tick."""
    jm, jp, tm, tp = _cached_pair(arch)
    trace = _trace(arch, jm.config)
    jreqs, treqs = [r.clone() for r in trace], _port_reqs(trace)
    jstats = JaxPagedServeLoop(jm, jp, **PAGED_KW).run(jreqs)
    loop = _CheckedLoop(tm, tp, device="cpu", **PAGED_KW)
    tstats = loop.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    _stats_equal(tstats, jstats)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "starcoder2-3b"])
def test_preemption_parity_swa_and_hybrid(arch):
    """tests/test_serve_sched.py::test_preemption_parity_swa_and_hybrid's
    trace and pool (the largest request plus one page): the JAX loop and
    the port's preempt and restore alike, the hybrid's SSM row staged
    beside its pages, and the streams equal the serial oracle's."""
    jm, jp, tm, tp = _cached_pair(arch)
    trace = poisson_trace(5, rate=5.0, plen_choices=(5, 9, 12), max_new_choices=(4, 6),
                          vocab_size=jm.config.vocab_size, seed=2)
    probe = PagedServeLoop(tm, tp, device="cpu", **PAGED_KW)
    n_pages = max(probe.allocator.pages_for(probe._rows_needed(r)) for r in trace) + 1
    kw = dict(PAGED_KW, n_pages=n_pages, preempt=True, preempt_after=1)
    jreqs, treqs, sreqs = [r.clone() for r in trace], _port_reqs(trace), _port_reqs(trace)
    jstats = JaxPagedServeLoop(jm, jp, **kw).run(jreqs)
    loop = _CheckedLoop(tm, tp, device="cpu", **kw)
    tstats = loop.run(treqs)
    SerialLoop(tm, tp, device="cpu").run(sreqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs] == [r.out for r in sreqs]
    _stats_equal(tstats, jstats)
    assert tstats["preemptions"] >= 1 and tstats["restore_dispatches"] == tstats["preemptions"]


def _two_slot_caches(jm, jp, tm, tp, capacity=24):
    """A 3-slot contiguous cache on both sides with requests prefilled into
    slots 0 and 2 (slot 1 never filled) -> (jax cache, port cache, next
    tokens, positions)."""
    cfg = jm.config
    r = np.random.RandomState(3)
    jc, tc = jm.init_cache(3, capacity), tm.init_cache(3, capacity)
    toks, pos = np.zeros(3, np.int32), np.zeros(3, np.int32)
    pkw = {} if cfg.family == "ssm" else {"pad_to": capacity}
    for slot, plen in ((0, 7), (2, 11)):
        prompt = r.randint(0, cfg.vocab_size, (1, plen)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(prompt)}, {"tokens": torch.from_numpy(prompt)}
        if cfg.vision_dim:
            patches = r.randn(1, cfg.num_patches, cfg.vision_dim).astype(np.float32)
            jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
        jl, jone = jm.prefill(jp, jb, **pkw)
        tl, tone = tm.prefill(tp, tb, **pkw)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGITS_TOL, rtol=LOGITS_TOL)
        jc = jax_transformer.insert_cache_slot(jc, jone, jnp.int32(slot))
        transformer.insert_cache_slot(tc, tone, slot)
        toks[slot], pos[slot] = int(np.asarray(jl).argmax()), plen
    return jc, tc, toks, pos


def _leaves(cache):
    return [x for part in cache if part is not None for x in part]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_jax(arch):
    """One ``decode_step`` a family from the same prefilled slots, slot 1
    inactive: logits of the live rows and every cache leaf at the bars; in
    the port the inactive row keeps every leaf bit for bit, under "mask"
    and under the indexed write alike."""
    jm, jp, tm, tp = _cached_pair(arch)
    jc, tc, toks, pos = _two_slot_caches(jm, jp, tm, tp)
    act = np.array([True, False, True])
    before = [x.clone() for x in _leaves(tc)]
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                            active=jnp.asarray(act))
    outs = {}
    for cu in ("mask", "kernel"):
        c = type(tc)(*(None if part is None else type(part)(*(x.clone() for x in part))
                       for part in tc))
        tl, c = tm.decode_step(tp, c, torch.from_numpy(toks), torch.from_numpy(pos),
                               cache_update=cu, active=torch.from_numpy(act))
        outs[cu] = (tl, c)
        np.testing.assert_allclose(_np(tl)[act], np.asarray(jl)[act], atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        batch_axis = 2 if arch == "xlstm-1.3b" else 1
        for t, j, old in zip(_leaves(c), _leaves(jc), before):
            if t.dtype.is_floating_point:
                _close(t, j)
            else:
                np.testing.assert_array_equal(_np(t), np.asarray(j))
            assert torch.equal(t.select(batch_axis, 1), old.select(batch_axis, 1))
    for a, b in zip(_leaves(outs["mask"][1]), _leaves(outs["kernel"][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_recurrent_prefill_matches_jax(arch):
    """Prefill of the recurrent families: last-token logits and the states
    (the hybrid's SSM state beside its KV rows; xLSTM's blocks' states)."""
    jm, jp, tm, tp = _cached_pair(arch)
    toks = np.random.RandomState(5).randint(0, jm.config.vocab_size, (2, 13)).astype(np.int32)
    kw = {} if arch == "xlstm-1.3b" else {"pad_to": 24}
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, **kw)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, **kw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert [p is None for p in tc] == [p is None for p in jc]
    for t, j in zip(_leaves(tc), _leaves(jc)):
        if t.dtype.is_floating_point:
            _close(t, j)
        else:
            np.testing.assert_array_equal(_np(t), np.asarray(j))
    with pytest.raises(ValueError, match="exact prompt length"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, length=torch.tensor([13, 9]))


def test_moe_chunk_prefill_matches_jax():
    """``paged_prefill_chunk`` on the MoE family (the default capacity
    factor, so padding rows compete unless the live mask keeps them
    behind): two chunks of a 13-token prompt, the second padded, against
    the JAX package's; logits and the pool rows written."""
    jm = jax_build("qwen2-moe-a2.7b", reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model_by_name("qwen2-moe-a2.7b", reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    ps, C = 4, 8
    prompt = np.random.RandomState(6).randint(0, jm.config.vocab_size, 13).astype(np.int32)
    row = np.array([5, 2, 7, 0], np.int32)
    jc, tc = jm.init_paged_cache(1, 8, ps), tm.init_paged_cache(1, 8, ps)
    for start in (0, C):
        step = min(C, len(prompt) - start)
        toks = np.zeros((1, C), np.int32)
        toks[0, :step] = prompt[start:start + step]
        jl, jc = jm.paged_prefill_chunk(jp, jc, jnp.asarray(row), jnp.asarray(toks),
                                        jnp.int32(start), jnp.int32(step))
        tl, tc = tm.paged_prefill_chunk(tp, tc, torch.from_numpy(row), torch.from_numpy(toks),
                                        start, step, cache_update="scatter")
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGITS_TOL, rtol=LOGITS_TOL)
    _close(tc.kv.k, jc.kv.k)
    _close(tc.kv.v, jc.kv.v)


def test_serving_gates_match_jax():
    """The refusals, with the JAX package's words: VLM requests without
    patches or shorter than num_patches, xLSTM on the page pool, whisper's
    decode, and the prefix / chunk gate's three reasons (SWA, recurrent,
    VLM)."""
    jm, jp, tm, tp = _cached_pair("phi-3-vision-4.2b")
    cfg = tm.config
    r = np.random.RandomState(4)
    bare = Request(9, r.randint(0, cfg.vocab_size, 6), 2)
    short = Request(10, r.randint(0, cfg.vocab_size, cfg.num_patches - 1), 2,
                    patches=r.randn(cfg.num_patches, cfg.vision_dim).astype(np.float32))
    for loop in (ServeLoop(tm, tp, device="cpu", **LOOP_KW),
                 PagedServeLoop(tm, tp, device="cpu", **PAGED_KW),
                 SerialLoop(tm, tp, device="cpu")):
        with pytest.raises(ServeUnsupportedError, match="has no `patches`"):
            loop.run([Request(9, bare.tokens, 2)])
        with pytest.raises(ServeUnsupportedError, match="shorter than num_patches"):
            loop.run([short.clone()])

    xl = build_model_by_name("xlstm-1.3b", reduced=True, device="cpu")
    jxl = jax_build("xlstm-1.3b", reduced=True)
    with pytest.raises(ServeUnsupportedError, match="no KV cache to page") as ours:
        PagedServeLoop(xl, None, device="cpu")
    with pytest.raises(JaxServeUnsupportedError) as theirs:
        JaxPagedServeLoop(jxl, None)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="page") as ours:
        xl.init_paged_cache(2, 8, 8)
    with pytest.raises(ValueError) as theirs:
        jxl.init_paged_cache(2, 8, 8)
    assert str(ours.value) == str(theirs.value)

    whisper = build_model_by_name("whisper-medium", reduced=True, device="cpu")
    jw = jax_build("whisper-medium", reduced=True)
    assert decode_capability(whisper) == jax_decode_capability(jw)
    for loop_cls in (ServeLoop, PagedServeLoop, SerialLoop):
        with pytest.raises(ServeUnsupportedError, match="448-token"):
            loop_cls(whisper, None, device="cpu")
    for arch in FAMILIES:
        assert decode_capability(_cached_pair(arch)[2]) == (True, "")

    for arch in ("starcoder2-3b", "hymba-1.5b", "phi-3-vision-4.2b"):
        jm_, _, tm_, _ = _cached_pair(arch)
        for kw in (dict(prefix_cache=True), dict(prefill_chunk=8)):
            with pytest.raises(ServeUnsupportedError, match="full-attention text-only") as ours:
                PagedServeLoop(tm_, None, device="cpu", **kw)
            with pytest.raises(JaxServeUnsupportedError) as theirs:
                JaxPagedServeLoop(jm_, None, **kw)
            assert str(ours.value) == str(theirs.value)
    # the sanitizer lane is ported (tests/test_torch_sanitize.py runs it)
    assert ServeLoop(tm, tp, device="cpu", sanitize=True).sanitizer.label == "serve-loop"


def _hd96_inputs(seed, G, Hkv, holes=()):
    """numpy q, pools, new rows and a page table of distinct pages at head
    dim 96 (phi-3-vision's); each (slot, page) of ``holes`` is -1."""
    r = np.random.RandomState(seed)
    B, P, ps, hd = 3, 6, 8, 96
    N = B * P + 2
    q = r.randn(B, G * Hkv, hd).astype(np.float32)
    kp = r.randn(N, ps, Hkv, hd).astype(np.float32)
    vp = r.randn(N, ps, Hkv, hd).astype(np.float32)
    kn = r.randn(B, Hkv, hd).astype(np.float32)
    vn = r.randn(B, Hkv, hd).astype(np.float32)
    pt = r.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    for b, p in holes:
        pt[b, p] = -1
    return q, kp, vp, kn, vn, pt


@pytest.mark.parametrize("G,Hkv,window,splits", [(1, 4, 0, 1), (1, 4, 0, 3),
                                                 (4, 2, 16, 1), (4, 2, 16, 4)])
def test_decode_hd96_plain_and_split_match_pallas(G, Hkv, window, splits):
    """Paged decode at head dim 96, the shape the hd-96 CUDA instance
    serves: the plain version (``ops`` on CPU tensors) and the split
    kernel's plain mirror against the Pallas kernel in interpret mode and
    the jnp oracle. Pools bitwise; outputs within 1e-5 (plain) and 1e-6
    (mirror: test_torch_paged_split.py's bar). Slot 1 is inactive; slot 2
    has an unallocated page inside its live range; with the window the
    ring has wrapped for slot 2."""
    args = _hd96_inputs(10 * G + window + splits, G, Hkv, holes=((2, 1),))
    pos = np.array([5, 30, 40 if window else 47], np.int32)
    act = np.array([True, False, True])
    jargs = [jnp.asarray(a) for a in (*args, pos)]
    o_p, kk_p, vk_p = pa_kernel.paged_decode_attention_pallas(
        *jargs, jnp.asarray(act), window=window, interpret=True)
    o_r, kk_r, vk_r = jref.paged_decode_attention(*jargs, jnp.asarray(act), window=window)
    for fn, tol in ((lambda *t: pa_ops.paged_decode_attention(
            *t[:7], window=window, active=t[7]), 1e-5),
                    (lambda *t: tref.paged_decode_attention_split(
                        *t, window=window, splits=splits), 1e-6)):
        t = [torch.from_numpy(a.copy()) for a in (*args, pos)]
        o_t = fn(*t, torch.from_numpy(act))
        for kk, vk in ((kk_p, vk_p), (kk_r, vk_r)):
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(kk))
            np.testing.assert_array_equal(t[2].numpy(), np.asarray(vk))
        for o in (o_p, o_r):
            np.testing.assert_allclose(o_t.numpy()[act], np.asarray(o)[act], atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("arch,mode", [("xlstm-1.3b", "--check"), ("hymba-1.5b", "--serial"),
                                       ("phi-3-vision-4.2b", "--paged")])
def test_cli_modes(capsys, arch, mode):
    """``python -m repro_torch.serve``: no ``--paged`` serves through the
    contiguous ``ServeLoop``, ``--paged`` through ``PagedServeLoop``,
    ``--serial`` through ``SerialLoop``, and ``--check`` runs the batched
    loop and the serial one and exits 0 only with equal streams; VLM
    requests carry patches; the xLSTM family on the page pool exits 2
    naming the page, and the scheduler's flags need ``--paged``."""
    import json

    from repro_torch.serve.__main__ import main

    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--requests", "3", "--plens",
            "8,12", "--max-new", "3,5"]
    assert main(argv + [mode]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    want = {"--check": ["loop", "serial"], "--serial": ["serial"], "--paged": ["paged"]}[mode]
    assert [x["mode"] for x in lines if "mode" in x] == want
    assert all(x["tokens"] > 0 for x in lines if "mode" in x)
    if mode == "--check":
        assert lines[-1] == {"check": "streams equal", "requests": 3, "differing_rids": []}
    assert main(["--device", "cpu", "--reduced", "--arch", "xlstm-1.3b", "--paged"]) == 2
    assert "no KV cache to page" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(argv + ["--preempt"])
