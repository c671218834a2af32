"""The port's front-end scheduler (prefix caching, chunked prefill,
preemption), its "mask" write and its sampled decode, against the JAX
package on the CPU.

Tolerances: the chunk prefill's logits and the pool rows it writes at the
bars of tests/test_torch_model.py's prefill (atol 1e-5 / rtol 1e-4,
float32, each framework with its own matmuls); greedy streams, scheduler
stats, page tables and refcounts exactly; the three pool writes of the
port against each other bit for bit. Sampled streams cannot match
``jax.random`` across the frameworks, so the port's sampler is held to
its contract: greedy at temperature 0, streams independent of slot, batch
and schedule, top-k respected, and frequencies within a stated bound.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_transformer
from repro.models.model import build_model_by_name as jax_build
from repro.serve import PagedServeLoop as JaxPagedServeLoop
from repro.serve import ServeUnsupportedError as JaxServeUnsupportedError
from repro.serve import poisson_trace
from repro_torch import bridge
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.model import build_model_by_name as torch_build
from repro_torch.serve import PagedServeLoop, Request, SamplerConfig, ServeUnsupportedError
from repro_torch.serve.sampling import make_sample_fn, stream_bits, stream_uniforms

torch.set_num_threads(2)

# every stat of run() that is not a clock
TIMERS = ("wall_s", "tok_s", "decode_s", "prefill_s", "extend_s")


@pytest.fixture(scope="module")
def qwen():
    jm = jax_build("qwen1.5-32b", reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build("qwen1.5-32b", reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _family_trace(n=6, seed=1, max_new=(2, 4, 6), vocab=512):
    """Shared-prefix families (16 tokens = 2 pages at page_size 8) so the
    prefix cache hits, as tests/test_serve_sched.py's traces."""
    return poisson_trace(n, rate=1.0, plen_choices=(3, 5, 9), max_new_choices=max_new,
                         vocab_size=vocab, seed=seed, prefix_families=2, prefix_len=16)


def _port_reqs(trace):
    return [Request(r.rid, r.tokens.copy(), r.max_new, r.eos_id, r.arrival) for r in trace]


class _CheckedLoop(PagedServeLoop):
    """Audits refcount conservation after every tick."""

    def tick(self, queue=None):
        super().tick(queue)
        self.check_invariants()


def _run_port(tm, tp, trace, **kw):
    loop = _CheckedLoop(tm, tp, device="cpu", **kw)
    reqs = _port_reqs(trace)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", transformer.KernelExtendFallbackWarning)
        stats = loop.run(reqs)
    loop.check_invariants()
    return loop, reqs, stats


def _stats_equal(ours, theirs):
    keys = set(theirs) - set(TIMERS)
    assert keys <= set(ours)
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}


SLOT_KW = dict(n_slots=3, capacity=32, page_size=8, bucket=8)
VARIANTS = {
    "base": dict(),
    "prefix": dict(prefix_cache=True),
    "prefix_chunk4": dict(prefix_cache=True, prefill_chunk=4),
    "prefix_chunk16": dict(prefix_cache=True, prefill_chunk=16),
    # 9 pages for requests of up to 4: the trace only drains by preempting
    "full": dict(prefix_cache=True, prefill_chunk=4, n_pages=9, preempt=True,
                 preempt_after=1),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_scheduler_matches_jax(qwen, name):
    """Greedy streams token for token, every integer stat exactly, and the
    allocator's refcount audit after every tick (the port's loop under
    "kernel", plain on the CPU; the JAX loop under its default "mask",
    whose streams its own tests hold bit-identical to "kernel")."""
    jm, jp, tm, tp = qwen
    kw = {**SLOT_KW, **VARIANTS[name]}
    trace = _family_trace(n=8, seed=6, max_new=(2, 4, 8))
    jreqs = [r.clone() for r in trace]
    jstats = JaxPagedServeLoop(jm, jp, cache_update="mask", **kw).run(jreqs)
    loop, treqs, tstats = _run_port(tm, tp, trace, cache_update="kernel", **kw)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    _stats_equal(tstats, jstats)
    if name != "base":
        assert tstats["extend_write"] == "scatter"
        assert tstats["prefix_hit_tokens"] > 0
    if name == "full":
        assert tstats["preemptions"] >= 1
        assert tstats["restore_dispatches"] == tstats["preemptions"]
        assert loop.allocator.pages_in_use == len(loop.prefix.pages)


@pytest.mark.parametrize("cache_update", ["scatter", "mask"])
def test_forced_preemption_alone_matches_jax(qwen, cache_update):
    """Preemption without prefix caching: whole-prompt admission, staging
    and restore through ``insert_cache_pages``, under each plain write."""
    jm, jp, tm, tp = qwen
    kw = dict(SLOT_KW, n_pages=6, preempt=True, preempt_after=1)
    trace = _family_trace(seed=3, max_new=(4, 8))
    jreqs = [r.clone() for r in trace]
    jstats = JaxPagedServeLoop(jm, jp, cache_update="mask", **kw).run(jreqs)
    _, treqs, tstats = _run_port(tm, tp, trace, cache_update=cache_update, **kw)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    _stats_equal(tstats, jstats)
    assert tstats["preemptions"] >= 1


def test_preemption_alone_on_swa_matches_jax():
    """SWA ring pages stage and restore verbatim (starcoder2-3b, window 64
    reduced), as the JAX package's preemption test holds."""
    jm = jax_build("starcoder2-3b", reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build("starcoder2-3b", reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    trace = poisson_trace(5, rate=5.0, plen_choices=(5, 9, 12), max_new_choices=(4, 6),
                          vocab_size=jm.config.vocab_size, seed=2)
    probe = PagedServeLoop(tm, tp, device="cpu", **SLOT_KW)
    n_pages = max(probe.allocator.pages_for(probe._rows_needed(r)) for r in trace) + 1
    kw = dict(SLOT_KW, n_pages=n_pages, preempt=True, preempt_after=1)
    jreqs = [r.clone() for r in trace]
    jstats = JaxPagedServeLoop(jm, jp, **kw).run(jreqs)
    _, treqs, tstats = _run_port(tm, tp, trace, **kw)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    _stats_equal(tstats, jstats)
    assert tstats["preemptions"] >= 1


class _RestoreAudit(PagedServeLoop):
    """Checks after every restore that the pool pages hold the staged rows."""

    restores = 0

    def _restore(self, slot, ent):
        super()._restore(slot, ent)
        row = torch.from_numpy(self.page_table[slot][:ent.pages]).long()
        for pool, staged in ((self.cache.kv.k, ent.k), (self.cache.kv.v, ent.v)):
            got = pool[:, row]
            want = staged[:, :ent.pages]
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        self.restores += 1


@pytest.mark.parametrize("cache_update", ["kernel", "scatter", "mask"])
def test_preemption_round_trip_is_bitwise(qwen, cache_update):
    _, _, tm, tp = qwen
    loop = _RestoreAudit(tm, tp, device="cpu", cache_update=cache_update, n_pages=6,
                         preempt=True, preempt_after=1, **SLOT_KW)
    stats = loop.run(_port_reqs(_family_trace(seed=3, max_new=(4, 8))))
    assert loop.restores == stats["restore_dispatches"] >= 1


def _pool_pair(jm, tm, n_pages=10, ps=8):
    return jm.init_paged_cache(2, n_pages, ps), tm.init_paged_cache(2, n_pages, ps)


@pytest.mark.parametrize("cache_update", ["scatter", "mask"])
def test_paged_prefill_chunk_matches_jax(qwen, cache_update):
    """A 13-token prompt in two chunks (width 8: rows 0-7, then 8-12 with 3
    pad rows) into pages [3, 7, -1, -1]: each chunk's logits and the pool
    the JAX package writes, at the prefill bars."""
    jm, jp, tm, tp = qwen
    jc, tc = _pool_pair(jm, tm)
    row = np.array([3, 7, -1, -1], np.int32)
    toks = np.random.RandomState(0).randint(0, 512, 13).astype(np.int32)
    for start, length in ((0, 8), (8, 5)):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :length] = toks[start:start + length]
        jl, jc = jm.paged_prefill_chunk(jp, jc, jnp.asarray(row), jnp.asarray(chunk),
                                        jnp.int32(start), jnp.int32(length),
                                        cache_update=cache_update)
        tl, tc = tm.paged_prefill_chunk(tp, tc, torch.from_numpy(row), torch.from_numpy(chunk),
                                        start, length, cache_update=cache_update)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-4)
        for t, j in ((tc.kv.k, jc.kv.k), (tc.kv.v, jc.kv.v)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-4)
    # pad rows 13-15 of page 7 and every unallocated page stay zero
    k = tc.kv.k.numpy()
    assert (k[:, 7, 5:] == 0).all()
    assert (np.delete(k, [3, 7], axis=1) == 0).all()
    # the last chunk's logits are the whole prompt's last-position logits
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[None])})
    np.testing.assert_allclose(tl.numpy(), full.numpy(), atol=1e-5, rtol=1e-4)


def _bits(t):
    return t.view(torch.int32)


def test_three_writes_give_bitwise_equal_pools(qwen):
    """Decode steps, chunk prefills and whole-prompt inserts under "mask",
    "scatter" and "kernel" (plain on the CPU) write the same bits."""
    _, _, tm, tp = qwen
    ps, n_pages = 8, 12
    rs = np.random.RandomState(1)
    pt = np.array([[0, 5, -1, -1], [2, 9, 4, -1], [7, -1, -1, -1]], np.int32)
    prompt = torch.from_numpy(rs.randint(0, 512, (1, 20)).astype(np.int32))
    _, one = tm.prefill(tp, {"tokens": prompt}, pad_to=32)
    caches = {}
    for cu in ("mask", "scatter", "kernel"):
        cache = tm.init_paged_cache(3, n_pages, ps)
        # admission of slot 1 (pages 2, 9, 4), a chunk into slot 0, then
        # decode steps with an inactive slot 2
        transformer.insert_cache_pages(cache, one, 1, torch.from_numpy(pt[1]), cache_update=cu)
        chunk = torch.from_numpy(np.arange(1, 9, dtype=np.int32)[None])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", transformer.KernelExtendFallbackWarning)
            tm.paged_prefill_chunk(tp, cache, torch.from_numpy(pt[0]), chunk, 0, 6,
                                   cache_update=cu)
        pos = torch.tensor([6, 20, 31], dtype=torch.int32)
        for t in range(3):
            tm.paged_decode_step(tp, cache, torch.from_numpy(pt), torch.tensor([3, 4, 5]) + t,
                                 pos + t, cache_update=cu,
                                 active=torch.tensor([True, True, False]))
        caches[cu] = cache
    for cu in ("scatter", "kernel"):
        assert torch.equal(_bits(caches[cu].kv.k), _bits(caches["mask"].kv.k)), cu
        assert torch.equal(_bits(caches[cu].kv.v), _bits(caches["mask"].kv.v)), cu
    assert (caches["mask"].kv.k[:, 7] == 0).all()  # the inactive slot wrote nothing


def test_mask_write_keeps_negative_zero():
    """The mask write gathers each cell's writer: a -0.0 row lands as -0.0,
    bit for bit as the indexed write (a product with the selector would
    turn it into +0.0)."""
    from repro_torch.models.attention import _cell_selector, _select_write

    pool_a = torch.ones(4, 2, 1, 2)
    pool_b = pool_a.clone()
    rows = torch.tensor([[[-0.0, 1.5]], [[2.0, -0.0]]])
    phys, r = torch.tensor([3, 1]), torch.tensor([1, 0])
    _select_write(pool_a, _cell_selector(4, 2, phys, r, torch.tensor([True, True])), rows)
    pool_b[phys, r] = rows
    assert torch.equal(_bits(pool_a), _bits(pool_b))


def test_insert_mask_matches_jax_insert(qwen):
    """``insert_cache_pages(cache_update="mask")`` against the JAX package's
    on the same (bridged) prefill cache: bitwise, since both copy."""
    jm, jp, tm, tp = qwen
    toks = np.random.RandomState(2).randint(0, 512, (1, 11)).astype(np.int32)
    _, jone = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pad_to=32)
    tone = transformer.DecodeCache(kv=KVCache(
        torch.from_numpy(np.array(jone.kv.k)), torch.from_numpy(np.array(jone.kv.v)),
        torch.from_numpy(np.array(jone.kv.pos))))
    ids = np.array([4, -1, 0, 6], np.int32)
    jc, tc = _pool_pair(jm, tm)
    jc = jax_transformer.insert_cache_pages(jc, jone, jnp.int32(0), jnp.asarray(ids),
                                            cache_update="mask")
    transformer.insert_cache_pages(tc, tone, 0, torch.from_numpy(ids), cache_update="mask")
    np.testing.assert_array_equal(tc.kv.k.numpy(), np.asarray(jc.kv.k))
    np.testing.assert_array_equal(tc.kv.v.numpy(), np.asarray(jc.kv.v))


def test_inactive_slot_at_capacity_writes_nothing():
    """A retired slot keeps its last pos, which may be one past its last
    page (plen + max_new - 1 == capacity): the plain decode skips its write
    as the kernel does, instead of indexing past the page table."""
    ps, P = 4, 2
    k_pool, v_pool = torch.zeros(6, ps, 1, 8), torch.zeros(6, ps, 1, 8)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([P * ps, 3], dtype=torch.int32)
    args = (torch.randn(2, 2, 8), k_pool, v_pool, torch.ones(2, 1, 8), torch.ones(2, 1, 8),
            pt, pos, torch.tensor([False, True]))
    pa_ref.paged_decode_attention(*args)
    assert k_pool[3, 3].eq(1).all() and k_pool.sum() == 8  # only slot 1's row
    pa_ref.paged_decode_attention_split(*args, splits=2)


def test_extend_gates_match_jax(qwen):
    """tests/test_serve_sched.py::test_extend_gates on both packages, plus
    the port's own: sanitize names A19, the model function's gates (the
    MoE chunk itself is held against the JAX package in
    tests/test_torch_serve_families.py)."""
    jm, jp, tm, tp = qwen
    jswa = jax_build("starcoder2-3b", reduced=True)
    tswa = torch_build("starcoder2-3b", reduced=True, device="cpu")
    for loop_cls, swa, model, params, unsupported, dev in (
            (JaxPagedServeLoop, jswa, jm, jp, JaxServeUnsupportedError, {}),
            (PagedServeLoop, tswa, tm, tp, ServeUnsupportedError, {"device": "cpu"})):
        with pytest.raises(unsupported, match="full-attention"):
            loop_cls(swa, None, prefix_cache=True, **dev)
        with pytest.raises(unsupported, match="full-attention"):
            loop_cls(swa, None, prefill_chunk=8, **dev)
        with pytest.raises(ValueError, match="prefill_chunk"):
            loop_cls(model, params, prefill_chunk=0, **dev)
        loop_cls(swa, None, preempt=True, **dev)  # preemption alone stays available
    # the sanitizer lane is ported (tests/test_torch_sanitize.py runs it)
    assert PagedServeLoop(tm, tp, device="cpu", sanitize=True).sanitizer.label == "serve-loop"
    row, toks = torch.full((4,), -1, dtype=torch.int32), torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="full-attention only"):
        tswa.paged_prefill_chunk(None, None, row, toks, 0, 4)
    hymba = torch_build("hymba-1.5b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        hymba.paged_prefill_chunk(None, None, row, toks, 0, 4)
    xlstm = torch_build("xlstm-1.3b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="recurrent"):
        xlstm.paged_prefill_chunk(None, None, row, toks, 0, 4)
    with pytest.raises(ValueError, match="cache_update"):
        PagedServeLoop(tm, tp, device="cpu", cache_update="pallas")


def test_kernel_extend_lowering_warns_once(qwen, monkeypatch):
    """Under "kernel" the chunk writes take the named plain "scatter" path:
    one KernelExtendFallbackWarning a process, and the loop says so."""
    _, _, tm, tp = qwen
    monkeypatch.setattr(transformer, "_KERNEL_EXTEND_WARNED", False)

    def build():
        return PagedServeLoop(tm, tp, device="cpu", prefill_chunk=8, cache_update="kernel",
                              **SLOT_KW)

    with pytest.warns(transformer.KernelExtendFallbackWarning, match="'scatter' path"):
        loop = build()
    with warnings.catch_warnings():
        warnings.simplefilter("error", transformer.KernelExtendFallbackWarning)
        build()
        tm.paged_prefill_chunk(tp, tm.init_paged_cache(1, 4, 8),
                               torch.tensor([0, 1, -1, -1], dtype=torch.int32),
                               torch.ones(1, 8, dtype=torch.int32), 0, 8)
    assert loop.extend_write == "scatter"
    assert PagedServeLoop(tm, tp, device="cpu", prefill_chunk=8, cache_update="mask",
                          **SLOT_KW).extend_write == "mask"


# ---------------------------------------------------------------------------
# sampled decode
# ---------------------------------------------------------------------------


def test_temperature_zero_is_bitwise_greedy(qwen):
    logits = torch.randn(5, 97, generator=torch.Generator().manual_seed(0))
    rid, n = torch.arange(5, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    for s in (SamplerConfig(), SamplerConfig(temperature=0.0, top_k=3, seed=9)):
        assert torch.equal(make_sample_fn(s)(logits, rid, n), logits.argmax(-1).to(torch.int32))
    _, _, tm, tp = qwen
    trace = _family_trace(seed=4, max_new=(3, 5))
    outs = []
    for s in (None, SamplerConfig(temperature=0.0, top_k=3, seed=9)):
        reqs = _port_reqs(trace)
        PagedServeLoop(tm, tp, device="cpu", sampler=s, **SLOT_KW).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_sampler_config_errors_match_jax():
    from repro.serve import SamplerConfig as JaxSamplerConfig
    from repro.serve.sampling import make_sample_fn as jax_make_sample_fn

    for kw, match in ((dict(temperature=-0.5), "temperature"), (dict(temperature=1.0, top_k=-1),
                                                                 "top_k")):
        with pytest.raises(ValueError, match=match):
            jax_make_sample_fn(JaxSamplerConfig(**kw))
        with pytest.raises(ValueError, match=match):
            make_sample_fn(SamplerConfig(**kw))


def test_stream_depends_only_on_seed_rid_and_n():
    rid = torch.tensor([5, 5, 6, 5], dtype=torch.int32)
    n = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    bits = stream_bits(3, rid, n, 64)
    assert torch.equal(bits[0], bits[3])  # same (rid, n), other row
    assert not torch.equal(bits[0], bits[1]) and not torch.equal(bits[0], bits[2])
    assert not torch.equal(bits[0], stream_bits(4, rid, n, 64)[0])
    # a row alone gives the row's draws in a batch; the prefix of a longer
    # vocabulary is the shorter vocabulary's
    assert torch.equal(stream_bits(3, rid[2:3], n[2:3], 64)[0], bits[2])
    assert torch.equal(stream_bits(3, rid, n, 80)[:, :64], bits)
    u = stream_uniforms(3, rid, n, 64)
    assert u.dtype == torch.float64 and bool((u > 0).all() and (u < 1).all())
    assert torch.equal(u, (bits.double() + 0.5) / 2**32)
    assert int(bits.max()) < 2**32 and int(bits.min()) >= 0


def test_noise_is_finite_at_the_extreme_draws():
    """The largest and smallest 32-bit draws give finite Gumbel noise, so a
    masked entry (-1e30) can never win the argmax."""
    from repro_torch.serve.sampling import NEG_INF

    u = (torch.tensor([0.0, 2.0**32 - 1], dtype=torch.float64) + 0.5) * 2.0 ** -32
    g = (-torch.log(-torch.log(u))).float()
    assert bool(torch.isfinite(g).all())
    assert float(NEG_INF + g.max()) < -1e29


def test_top_k_never_draws_outside_the_top_k():
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(64, 200, generator=gen) * 3
    kth = logits.topk(7, dim=-1).values[:, -1:]
    sample = make_sample_fn(SamplerConfig(temperature=2.0, top_k=7, seed=0))
    for n in range(20):
        tok = sample(logits, torch.arange(64, dtype=torch.int32),
                     torch.full((64,), n, dtype=torch.int32)).long()
        assert bool((logits.gather(1, tok[:, None]) >= kth).all())
    # top_k > V keeps the whole vocabulary, as the JAX sampler clamps it
    wide = make_sample_fn(SamplerConfig(temperature=1.0, top_k=1000, seed=0))
    full = make_sample_fn(SamplerConfig(temperature=1.0, seed=0))
    rid, n0 = torch.arange(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32)
    assert torch.equal(wide(logits, rid, n0), full(logits, rid, n0))


def test_sampled_frequencies_follow_softmax():
    """20000 draws (distinct rids) of one 5-entry row at T 0.8: every
    empirical frequency within 0.02 of softmax(logits / T). A frequency's
    standard error is at most 0.0036 here, so the bound is over 5 of
    them."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0]])
    T, N = 0.8, 20000
    sample = make_sample_fn(SamplerConfig(temperature=T, seed=11))
    tok = sample(logits.expand(N, 5), torch.arange(N, dtype=torch.int32),
                 torch.zeros(N, dtype=torch.int32))
    freq = torch.bincount(tok.long(), minlength=5).double() / N
    want = torch.softmax(logits[0].double() / T, -1)
    assert float((freq - want).abs().max()) < 0.02


def test_sampled_streams_independent_of_schedule_and_batch(qwen):
    """One sampled trace through the four scheduler variants and at n_slots
    1 and 3 gives the same streams: draws depend on (seed, rid, n) alone."""
    _, _, tm, tp = qwen
    sampler = SamplerConfig(temperature=0.7, top_k=8, seed=5)
    trace = _family_trace(seed=4, max_new=(3, 5))
    outs = {}
    for name in ("base", "prefix", "prefix_chunk4", "full"):
        _, reqs, _ = _run_port(tm, tp, trace, sampler=sampler, **{**SLOT_KW, **VARIANTS[name]})
        outs[name] = [r.out for r in reqs]
    _, reqs, _ = _run_port(tm, tp, trace, sampler=sampler, **{**SLOT_KW, "n_slots": 1})
    outs["n_slots=1"] = [r.out for r in reqs]
    assert all(o == outs["base"] for o in outs.values()), outs
    greedy = _run_port(tm, tp, trace, **SLOT_KW)[1]
    assert [r.out for r in greedy] != outs["base"]  # the sampler did sample


def test_cli_runs_the_scheduler_and_sampler(capsys):
    import json

    from repro_torch.serve.__main__ import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", transformer.KernelExtendFallbackWarning)
        main(["--device", "cpu", "--reduced", "--arch", "qwen1.5-32b", "--paged", "--prefix-cache",
              "--prefill-chunk", "16", "--preempt", "--temperature", "0.7", "--top-k", "8",
              "--requests", "6", "--rate", "0.5", "--plens", "16,32", "--max-new", "4,8",
              "--prefix-families", "2", "--prefix-len", "32", "--burst-mult", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["failed"] == 0 and stats["tokens"] > 0
    assert stats["extend_write"] == "scatter" and stats["extend_dispatches"] > 0
    assert stats["prefix_hit_tokens"] > 0
