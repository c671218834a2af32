"""The trace reduction on a hand-made timeline, and each per-layer reader
on it: busy time is the union of device intervals, the window runs from
the first to the last, gaps are named by the innermost host op running
when they begin, and a reader with nothing to read returns None."""
from types import SimpleNamespace

import pytest

from bench import devtrace, flops, manifest
from bench.tests import tiny

DEVICE = [("sm90_xmma_gemm_f32", 0.0, 40.0), ("vecavg_kernel", 30.0, 50.0),
          ("rmsnorm_kernel<float>", 60.0, 70.0), ("sm90_xmma_gemm_f32", 100.0, 140.0),
          ("Memcpy DtoH", 150.0, 160.0)]
HOST = [("aten::mm", 45.0, 65.0), ("cudaLaunchKernel", 52.0, 54.0),
        ("aten::item", 68.0, 155.0), ("cudaStreamSynchronize", 70.0, 150.0)]


def _trace():
    return devtrace.Trace(device=DEVICE, host=HOST, rounds=2, active_steps=6)


def test_busy_window_and_gaps():
    tr = _trace()
    assert tr.busy() == [(0.0, 50.0), (60.0, 70.0), (100.0, 140.0), (150.0, 160.0)]
    assert tr.window_s == pytest.approx(160e-6) and tr.busy_s == pytest.approx(110e-6)
    assert tr.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(30e-6)],
                              ["cudaStreamSynchronize", pytest.approx(10e-6)],
                              ["aten::mm", pytest.approx(10e-6)]]
    late = devtrace.Trace(device=DEVICE, host=HOST[:2], rounds=2, active_steps=6)
    assert late.idle_gaps(1) == [["after aten::mm", pytest.approx(30e-6)]]
    assert tr.top_ops(2) == [["sm90_xmma_gemm_f32", pytest.approx(80e-6)],
                             ["vecavg_kernel", pytest.approx(20e-6)]]


def _ctx(trace):
    cell = tiny.cell("qwen05-fedveca")
    return SimpleNamespace(window_s=2.0, rounds=4, host_blocked_s=0.5, dispatch_s=0.2,
                           active_steps=12, config=cell.config, traffic=cell.traffic,
                           params=flops.param_count(cell.config),
                           peaks=flops.peaks("NVIDIA H100 80GB HBM3"), trace=trace)


def test_readers_on_the_timeline():
    cell = tiny.cell("qwen05-fedveca")
    ctx = _ctx(_trace())
    got = {m["name"]: manifest.reader(m["name"])(ctx) for m in cell.per_layer}
    t = cell.traffic
    assert got["driver.host_blocked_share"] == pytest.approx(25.0)
    assert got["driver.dispatch_ms_per_round"] == pytest.approx(50.0)
    assert got["round.masked_trip_share"] == pytest.approx(
        100 * (1 - 12 / (4 * t["cohort"] * t["tau_max"])))
    assert got["model.gemm_ms_per_round"] == pytest.approx(80e-6 * 1e3 / 2)
    assert got["device.idle_share"] == pytest.approx(100 * (1 - 110 / 160))
    bw = ctx.peaks["hbm_bytes_per_s"]
    C, D = t["cohort"], ctx.params
    want = (flops.vecavg_bytes(C, D, True) + flops.vecavg_bytes(C, D, False)) / 2 / bw / 20e-6
    assert got["kernel.vecavg_roofline"] == pytest.approx(100 * want)
    assert got["kernel.rmsnorm_ms_per_round"] == pytest.approx(10e-6 * 1e3 / 2)
    useful = flops.window_flops(cell.config, t["seq"], 6 * t["batch"], 0)
    assert got["model.step_mfu"] == pytest.approx(100 * useful / 160e-6 / 67e12)


def test_readers_without_a_trace_read_nothing():
    cell = tiny.cell("qwen05-fedveca")
    ctx = _ctx(None)
    for m in cell.per_layer:
        v = manifest.reader(m["name"])(ctx)
        assert (v is None) == (m["source"] == "device_trace"), m["name"]
