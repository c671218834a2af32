"""The dry run (port of ``repro/launch/dryrun.py``): every (architecture x
input shape x mesh) step bundle run once on ``meta`` tensors, in one
process with no card, as rank 0 of a ``"fake"`` process group of the
mesh's world size (256 ranks for (data 16, model 16), 512 with
``--multi-pod``), whose collectives move nothing.

The JAX package lowers and compiles each bundle and reads XLA's cost
analysis. Eager torch has no compiled program to read, so the port runs
the bundle itself on ``meta`` tensors: shapes and dtypes flow through
every op, nothing is computed and nothing is allocated. What one rank
would do is counted as it happens:

  * FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (matrix
    products, convolutions and attention; elementwise work is not
    counted);
  * the collectives the rank issues, count and bytes by kind
    (``sharding.api.collectives`` and ``collective_bytes``);
  * the kernel launches the card would make (each wrapper's
    ``meta_launches``).

**Depth.** The recurrent families run one Python step a token, so a bundle
is run at depth 1 and depth 2 of its layer stack (xLSTM: one and two
super-blocks; whisper: the encoder and the decoder together) and the
counts are extrapolated to the full depth as the JAX package's two-point
correction does: ``a + (trip - 1) * max(b - a, 0)``. **Length.** xLSTM's
train and prefill bundles would take hours at the published lengths on
``meta`` (every elementwise op of its step loop goes through Python); its
counts are affine in the length, so they run at S 32 and 64 and are
extrapolated to the shape's S the same way, exactly (``LENGTHS``; the
record says so in ``length_note``).

**Bytes.** A rank's parameter bytes come from the full-depth
``params_struct`` cut by the port's layout (``sharding.partition``:
``exec_dim``, ``halves``), sharded and replicated apart; its input bytes
from the full-depth bundle's ``shard_inputs`` (batches, caches, pools,
scalars). No forward is needed for either.

**Roofline terms** are arithmetic against the H100 SXM datasheet, not
measurements: FLOPs over 989.4 TFLOP/s (bf16 steps) or 67 TFLOP/s (float32
steps, which run under ``strict_fp32()``), parameter plus input bytes over
3.35 TB/s (a floor: each byte read once), collective bytes over 450 GB/s
(one direction of NVLink 4). ``meta`` tensors have no allocator, so no
peak or temporary memory is reported.

A bundle that reaches ``.item()``, ``.cpu()`` or a shape that depends on
values fails on ``meta``; its record is ``FAIL`` naming the op, file and
line, never skipped. ``SKIP`` records carry ``shape_supported``'s reason.

    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]

One JSON a (arch, shape, mesh) under ``--out`` (default
``experiments/dryrun_torch/``); an existing record is kept unless
``--force``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_arch, get_shape, shape_supported
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.vecavg import ops as va_ops
from repro_torch.launch.mesh import MODEL_AXIS, build_mesh
from repro_torch.models.model import build_model, params_struct
from repro_torch.sharding import api, partition
from repro_torch.train.steps import build_bundle

# NVIDIA H100 SXM datasheet (dense figures): the roofline's denominators
H100_SXM = dict(
    basis="arithmetic against the NVIDIA H100 SXM datasheet, not a measurement",
    bf16_flops_per_s=989.4e12,
    fp32_flops_per_s=67e12,
    hbm_bytes_per_s=3.35e12,
    nvlink_bytes_per_s=450e9,  # NVLink 4, one direction
)
FLOPS_NOTE = ("FlopCounterMode: matrix products, convolutions and attention; elementwise "
              "work is not counted")
NO_ALLOCATOR = "meta tensors have no allocator"
KERNEL_OPS = (va_ops, rn_ops, fa_ops, pa_ops)
COLLECTIVES = ("all_reduce", "all_gather")

# mesh name -> (axes, extents), as the JAX package names its production meshes
MESHES = {
    "pod16x16": (("data", MODEL_AXIS), (16, 16)),
    "pod2x16x16": (("pod", "data", MODEL_AXIS), (2, 16, 16)),
}


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks (every collective returns at once and moves nothing), torn down
    on exit."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already set up")
    # registers the "fake" backend with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    hook = sys.excepthook  # init_process_group wraps it with a rank prefix
    dist.init_process_group("fake", rank=0, world_size=world, store=dist.HashStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


# ---------------------------------------------------------------------------
# depth
# ---------------------------------------------------------------------------


def depth_unit(cfg) -> int:
    """Layers of one step of the depth extrapolation: an xLSTM super-block,
    else one layer."""
    return len(cfg.xlstm_pattern) if cfg.family == "ssm" else 1


def scan_trip_count(cfg) -> int:
    """The extrapolation's multiplier: the layer stack's depth in units of
    ``depth_unit`` (the JAX package's outer scan trip count; 1 for the toy
    models, which are run whole)."""
    if cfg.family == "toy":
        return 1
    return cfg.num_layers // depth_unit(cfg)


def at_depth(cfg, k: int):
    """``cfg`` cut to ``k`` units of depth (the encoder-decoder's encoder
    with its decoder)."""
    if cfg.family == "toy":
        return cfg
    kw = dict(num_layers=k * depth_unit(cfg))
    if cfg.encoder_layers:
        if cfg.encoder_layers != cfg.num_layers:
            raise ValueError(f"{cfg.name}: the extrapolation takes encoder and decoder "
                             f"stacks of one depth, got {cfg.encoder_layers} and "
                             f"{cfg.num_layers}")
        kw["encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# one measurement
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    api.reset_collectives()
    for ops in KERNEL_OPS:
        ops.reset_launches()


def counts() -> dict:
    """The collectives issued and the launches the card would make since
    ``reset_counts``: {"collectives": {kind: {"count", "bytes"}},
    "launches": {kernel: n}}."""
    launches = {}
    for ops in KERNEL_OPS:
        launches.update(ops.meta_launches)
    return dict(collectives={k: dict(count=api.collectives[k], bytes=api.collective_bytes[k])
                             for k in COLLECTIVES},
                launches=launches)


def measure(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` once under ``FlopCounterMode``: its FLOPs, the
    collectives it issued, the launches the card would make, its seconds."""
    reset_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return dict(flops=int(fc.get_total_flops()), seconds=time.perf_counter() - t0, **counts())


def _corr(a, b, trip: int):
    """The two-point extrapolation over nested dicts of numbers."""
    if isinstance(a, dict):
        return {k: _corr(a[k], b[k], trip) for k in a}
    return a + (trip - 1) * max(b - a, 0)


def predict(cfg, axes: Sequence[str], extents: Sequence[int],
            make_call: Callable) -> dict:
    """Counts of one rank of the mesh ``axes``/``extents`` for the call
    ``make_call(cfg_at_depth, mesh) -> (fn, args)`` builds on ``meta``:
    run at depth 1 and 2 and extrapolated to ``cfg``'s depth (the toy
    models once). -> {"flops", "collectives", "launches"} at full depth,
    "raw" (each depth's measurement) and "scan_trip"."""
    trip = scan_trip_count(cfg)
    with fake_world(math.prod(extents)):
        mesh = build_mesh(axes, extents, device="meta")
        raw = {}
        for k in ((1,) if trip == 1 else (1, 2)):
            fn, args = make_call(at_depth(cfg, k), mesh)
            raw[k] = measure(fn, *args)
    a = raw[1]
    full = a if trip == 1 else {k: _corr(a[k], raw[2][k], trip)
                                for k in ("flops", "collectives", "launches")}
    return dict(flops=full["flops"], collectives=full["collectives"],
                launches=full["launches"], raw=raw, scan_trip=trip)


# The lengths at which the xLSTM family's train and prefill bundles run: its
# step loop takes one Python step a token, and each elementwise op on meta
# goes through Python (~0.75 s a token at depth 1 of a train bundle on a CPU
# core), so the published lengths would take hours. With no attention its
# counts are affine in the length (products and collectives scale with the
# tokens, the loop's count of steps with the length), so two lengths give
# the published one exactly by the same two-point correction.
LENGTHS = (32, 64)
COUNTED = ("flops", "collectives", "launches")


def by_length(cfg, shape) -> bool:
    return cfg.family == "ssm" and shape.kind in ("train", "prefill") \
        and shape.seq_len > LENGTHS[1]


def predict_shape(cfg, axes, extents, shape, **bundle_kw) -> dict:
    """``predict`` of the bundle of ``shape``; for ``by_length`` configs
    run at ``LENGTHS`` and extrapolated to ``shape.seq_len`` (each depth's
    raw counts too), with each length's counts under "lengths"."""
    if not by_length(cfg, shape):
        return predict(cfg, axes, extents, bundle_call(shape, **bundle_kw))
    s1, s2 = LENGTHS
    k, rem = divmod(shape.seq_len - s1, s2 - s1)
    if rem:
        raise ValueError(f"S {shape.seq_len} is not {s1} plus a multiple of {s2 - s1}")
    runs = {L: predict(cfg, axes, extents,
                       bundle_call(dataclasses.replace(shape, seq_len=L), **bundle_kw))
            for L in LENGTHS}
    a, b = runs[s1], runs[s2]
    out = {key: _corr(a[key], b[key], k + 1) for key in COUNTED}
    out["raw"] = {d: {key: _corr(a["raw"][d][key], b["raw"][d][key], k + 1) for key in COUNTED}
                  for d in a["raw"]}
    out["scan_trip"] = a["scan_trip"]
    out["lengths"] = {L: dict({key: r[key] for key in COUNTED},
                              seconds=sum(v["seconds"] for v in r["raw"].values()))
                      for L, r in runs.items()}
    return out


def bundle_call(shape, **bundle_kw) -> Callable:
    """``make_call`` of a step bundle: the bundle's global ``meta`` inputs
    cut to the rank's pieces."""
    def make(cfg, mesh):
        b = build_bundle(build_model(cfg, device="meta", mesh=mesh), mesh, shape, **bundle_kw)
        return b.fn, b.shard_inputs(*b.make_inputs())
    return make


# ---------------------------------------------------------------------------
# bytes and model FLOPs, from shapes
# ---------------------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def param_bytes(cfg, m: int, rank: int = 0) -> dict:
    """Bytes of ``cfg``'s parameters: the whole tree (``unsharded``) and
    model rank ``rank``'s of an axis of ``m``: its pieces of the leaves the
    layout shards (``sharded``) and the replicated leaves
    (``replicated``)."""
    lay = partition.layout(cfg, m)
    out = dict(unsharded=0, sharded=0, replicated=0)
    for k, v in params_struct(build_model(cfg, device="meta")).items():
        out["unsharded"] += _nbytes(v)
        d = partition.exec_dim(k, v.dim(), lay)
        if d is None:
            out["replicated"] += _nbytes(v)
        else:
            out["sharded"] += _nbytes(partition.piece(v, d, partition.halves(k), rank, m))
    out["total"] = out["sharded"] + out["replicated"]
    return out


def input_bytes(cfg, axes, extents, shape, **bundle_kw):
    """(The full-depth bundle's name, the bytes of a rank's pieces of its
    inputs other than the parameters: batches, caches and pools, scalars.)"""
    with fake_world(math.prod(extents)):
        mesh = build_mesh(axes, extents, device="meta")
        b = build_bundle(build_model(cfg, device="meta", mesh=mesh), mesh, shape, **bundle_kw)
        args = b.shard_inputs(*b.make_inputs())
    return b.name, sum(_nbytes(t) for t in _tensors(args[1:]))


def model_flops(cfg, shape, tau_max: int, n_total: Optional[int] = None) -> float:
    """The JAX package's MODEL_FLOPS: 6 N D for a train step (N the active
    parameters, D the tokens of the round's tau_max steps), 2 N a token
    for prefill and decode; routed experts counted at ``experts_per_token``
    of ``num_experts + num_experts_pad``. ``n_total`` defaults to the
    initializers' shapes (ROADMAP.md R6: ``param_count()`` leaves out the
    biases, the norms' biases and the final norm of every config, whisper's
    decoder positions, and half of xLSTM)."""
    if n_total is None:
        n_total = sum(v.numel() for v in params_struct(build_model(cfg, device="meta")).values())
    n_active = n_total
    if cfg.is_moe:
        nm = 3 if cfg.mlp_act == "swiglu" else 2
        per = nm * cfg.d_model * cfg.moe_d_ff * cfg.num_layers
        n_active = n_total - (cfg.num_experts + cfg.num_experts_pad) * per \
            + cfg.experts_per_token * per
    if shape.kind == "train":
        return 6.0 * n_active * (shape.global_batch * shape.seq_len * tau_max)
    if shape.kind == "prefill":
        return 2.0 * n_active * (shape.global_batch * shape.seq_len)
    return 2.0 * n_active * shape.global_batch


def step_dtype(cfg) -> str:
    """The type of a step's products: float32 for the toy models and
    float32 configs (both run under ``strict_fp32()``), else bf16."""
    return "float32" if cfg.family == "toy" or cfg.compute_dtype == "float32" else "bfloat16"


def roofline(cfg, flops: float, mem_bytes: int, coll_bytes: int) -> dict:
    peak = H100_SXM["fp32_flops_per_s" if step_dtype(cfg) == "float32" else "bf16_flops_per_s"]
    r = dict(compute_s=flops / peak, memory_s=mem_bytes / H100_SXM["hbm_bytes_per_s"],
             collective_s=coll_bytes / H100_SXM["nvlink_bytes_per_s"])
    return dict(r, basis=H100_SXM["basis"], peak_flops_per_s=peak,
                memory_note="a floor: parameter and input bytes a rank, each read once")


# ---------------------------------------------------------------------------
# a record
# ---------------------------------------------------------------------------


def _failure(e: BaseException) -> dict:
    """FAIL's fields: the error, the op it names (or the source line that
    raised), and the innermost file and line of the port."""
    frames = traceback.extract_tb(e.__traceback__)
    mine = [f for f in frames if f"{os.sep}repro_torch{os.sep}" in f.filename] or frames
    fr = mine[-1]
    m = re.search(r"aten[.:]+[A-Za-z_]\w*(\.\w+)?", str(e))
    where = fr.filename.split(f"{os.sep}src{os.sep}")[-1]
    return dict(error=f"{type(e).__name__}: {e}", op=m.group(0) if m else fr.line,
                where=f"{where}:{fr.lineno} ({fr.name})",
                trace=traceback.format_exc()[-4000:])


def bundle_kwargs(shape, tau_max: int, extra: Optional[dict] = None) -> dict:
    kw = dict(tau_max=tau_max) if shape.kind == "train" else {}
    kw.update(extra or {})
    return kw


def measure_record(cfg, shape, mesh_name: str, *, tau_max: int = 2,
                   extra: Optional[dict] = None) -> dict:
    """The measured fields of one (config, shape, mesh) record."""
    axes, extents = MESHES[mesh_name]
    m = dict(zip(axes, extents)).get(MODEL_AXIS, 1)
    kw = bundle_kwargs(shape, tau_max, extra)
    t0 = time.perf_counter()
    pred = predict_shape(cfg, axes, extents, shape, **kw)
    pb = param_bytes(cfg, m)
    name, ib = input_bytes(cfg, axes, extents, shape, **kw)
    coll = pred["collectives"]
    coll_total = dict(count=sum(c["count"] for c in coll.values()),
                      bytes=sum(c["bytes"] for c in coll.values()))
    chips = math.prod(extents)
    flops = pred["flops"]
    mf = model_flops(cfg, shape, tau_max)
    rec = dict(
        step=name, chips=chips, tau_max=tau_max if shape.kind == "train" else None,
        scan_trip=pred["scan_trip"], depth_unit=depth_unit(cfg) if cfg.family != "toy" else None,
        flops_per_rank=flops, flops_per_rank_raw=pred["raw"][1]["flops"], flops_note=FLOPS_NOTE,
        collectives_per_rank=dict(coll, total=coll_total),
        param_bytes_per_rank=pb, input_bytes_per_rank=ib,
        kernel_launches_per_rank=pred["launches"],
        model_flops=mf, model_flops_per_rank=mf / chips,
        useful_flops_ratio=(mf / chips) / flops if flops else None,
        roofline=roofline(cfg, flops, pb["total"] + ib, coll_total["bytes"]),
        memory=dict(peak_bytes=None, temp_bytes=None, reason=NO_ALLOCATOR),
        depth_runs={str(k): dict(flops=v["flops"], collectives=v["collectives"],
                                 launches=v["launches"], seconds=v.get("seconds"))
                    for k, v in pred["raw"].items()},
    )
    if "lengths" in pred:
        rec["length_runs"] = {str(L): v for L, v in pred["lengths"].items()}
        rec["length_note"] = (f"run at S {LENGTHS[0]} and {LENGTHS[1]} and extrapolated "
                              f"linearly to S {shape.seq_len}: exact, the counts being affine "
                              "in the length (no attention)")
    r = rec["roofline"]
    rec["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=r.get)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = "experiments/dryrun_torch", tau_max: int = 2,
            force: bool = False) -> dict:
    """One record, written to ``out_dir`` (an existing one is returned as
    it is unless ``force``)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg, shape = get_arch(arch), get_shape(shape_name)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, tag=tag)
    ok, why = shape_supported(cfg, shape)
    t0 = time.perf_counter()
    if not ok:
        rec.update(status="SKIP", reason=why)
    else:
        try:
            rec.update(status="OK", **measure_record(cfg, shape, mesh_name, tau_max=tau_max))
        except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
            rec.update(status="FAIL", **_failure(e))
    rec.setdefault("seconds", time.perf_counter() - t0)
    _write(path, rec)
    return rec


def summary_line(rec: dict) -> str:
    head = f"{rec['tag']:56s} {rec['status']:4s} {rec.get('seconds', 0.0):8.1f}s "
    if rec["status"] == "OK":
        r, c = rec["roofline"], rec["collectives_per_rank"]["total"]
        return head + (f"bottleneck={rec['bottleneck']:12s} flops={rec['flops_per_rank']:.3e} "
                       f"coll={c['count']}x/{c['bytes']:.3e}B compute={r['compute_s']:.3e}s "
                       f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s")
    if rec["status"] == "SKIP":
        return head + rec["reason"]
    return head + f"{rec['error'][:160]} at {rec['where']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tau-max", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    results: Dict[str, int] = {"OK": 0, "SKIP": 0, "FAIL": 0}
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_one(a, s, multi_pod=mp, out_dir=args.out, tau_max=args.tau_max,
                              force=args.force)
                print(summary_line(rec), flush=True)
                results[rec["status"]] += 1
    print(f"\ndone: {results['OK']} OK, {results['SKIP']} SKIP (documented), "
          f"{results['FAIL']} FAIL in {time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if results["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
