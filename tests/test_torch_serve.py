"""The port's serving path against the JAX package: host bookkeeping
behaves identically on the same seeds, and greedy token streams through
``PagedServeLoop(cache_update="kernel")`` are equal token for token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model_by_name as jax_build
from repro.serve import PagedServeLoop as JaxPagedServeLoop
from repro.serve import slots as jslots
from repro.serve import poisson_trace as jax_trace
from repro_torch import bridge
from repro_torch.models.model import build_model_by_name as torch_build
from repro_torch.serve import PagedServeLoop, Request, poisson_trace
from repro_torch.serve import slots as tslots

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(n_requests=16, rate=2.0, plen_choices=(128, 256, 512, 1024),
         max_new_choices=(32, 64, 128), vocab_size=49152, seed=0),
    dict(n_requests=9, rate=0.5, burst_mult=4.0, burst_period=3,
         prefix_families=2, prefix_len=8, seed=5),
])
def test_poisson_trace_matches_jax(kw):
    a, b = poisson_trace(**kw), jax_trace(**kw)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival, x.eos_id) == (y.rid, y.max_new, y.arrival, y.eos_id)
        np.testing.assert_array_equal(x.tokens, y.tokens)


def test_page_allocator_and_slot_table_match_jax():
    """One scripted churn of admits, shares and frees through both copies."""
    r = np.random.RandomState(0)
    ta, ja = tslots.PageAllocator(12, 4), jslots.PageAllocator(12, 4)
    tt, jt = tslots.SlotTable(3), jslots.SlotTable(3)
    held = []
    for step in range(40):
        op = r.randint(3)
        if op == 0 or not held:
            n = int(r.randint(1, 5))
            got_t, got_j = ta.alloc(n), ja.alloc(n)
            assert (got_t is None) == (got_j is None)
            if got_t is not None:
                np.testing.assert_array_equal(got_t, got_j)
                held.append(got_t)
        elif op == 1:
            ids = held[int(r.randint(len(held)))]
            ta.share(ids[:1])
            ja.share(ids[:1])
            held.append(ids[:1])
        else:
            ids = held.pop(int(r.randint(len(held))))
            ta.free(ids)
            ja.free(ids)
        assert (ta.free_pages, ta.pages_in_use, ta.peak_in_use) == \
            (ja.free_pages, ja.pages_in_use, ja.peak_in_use)
        ta.check(page_tables=held)
        ja.check(page_tables=held)
        free = tt.free_slots()
        assert free == jt.free_slots()
        if free and op == 0:
            toks = r.randint(0, 50, 5)
            tt.admit(free[0], tslots.Request(step, toks, 3), 7, step)
            jt.admit(free[0], jslots.Request(step, toks, 3), 7, step)
        for s in tt.live_slots():
            tt.append(s, step)
            jt.append(s, step)
            if tt.req[s].finished():
                assert tt.retire(s, step).out == jt.retire(s, step).out
        np.testing.assert_array_equal(tt.pos, jt.pos)
        np.testing.assert_array_equal(tt.active, jt.active)
        np.testing.assert_array_equal(tt.last_tok, jt.last_tok)


def _streams(arch, trace_kw, loop_kw):
    jm = jax_build(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(arch, reduced=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    trace = jax_trace(vocab_size=jm.config.vocab_size, **trace_kw)
    jreqs = [r.clone() for r in trace]
    JaxPagedServeLoop(jm, jp, cache_update="kernel", **loop_kw).run(jreqs)
    treqs = [Request(r.rid, r.tokens.copy(), r.max_new, r.eos_id, r.arrival) for r in trace]
    loop = PagedServeLoop(tm, tp, device="cpu", cache_update="kernel", **loop_kw)
    stats = loop.run(treqs)
    loop.check_invariants()
    assert stats["failed"] == 0
    return [r.out for r in treqs], [r.out for r in jreqs]


@pytest.mark.parametrize("arch,trace_kw,loop_kw", [
    # the two traces of tests/test_paged_kernel.py's stream-parity tests
    ("qwen1.5-32b", dict(n_requests=6, rate=4.0, plen_choices=(8, 12),
                         max_new_choices=(6, 10), seed=0),
     dict(n_slots=3, capacity=32, page_size=8, n_pages=12)),
    ("starcoder2-3b", dict(n_requests=6, rate=4.0, plen_choices=(8, 16),
                           max_new_choices=(6, 10), seed=1),
     dict(n_slots=3, capacity=32, page_size=8)),
    # plen + max_new > the reduced window (64): the SWA ring wraps in decode
    ("starcoder2-3b", dict(n_requests=3, rate=4.0, plen_choices=(40, 64),
                           max_new_choices=(30, 36), seed=2),
     dict(n_slots=2, capacity=64, page_size=16)),
])
def test_paged_serve_loop_greedy_streams_match_jax(arch, trace_kw, loop_kw):
    got, want = _streams(arch, trace_kw, loop_kw)
    assert got == want


def test_not_ported_parts_raise_naming_the_roadmap():
    from dataclasses import replace

    from repro_torch.models.model import build_model
    from repro_torch.serve import SamplerConfig, ServeLoop

    model = torch_build("starcoder2-3b", reduced=True, device="cpu")
    params = model.init(0)
    moe = replace(model.config, family="moe", num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(moe, device="cpu")
    for kw in (dict(prefix_cache=True), dict(prefill_chunk=8), dict(preempt=True),
               dict(cache_update="mask"), dict(sampler=SamplerConfig(temperature=0.7))):
        with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
            PagedServeLoop(model, params, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeLoop(model, params, device="cpu")
