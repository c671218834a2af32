"""The port's dry run and perf driver (``repro_torch/launch/dryrun.py``,
``perf.py``) against the JAX package's, on the CPU.

  * ``shape_supported``: the same SKIP set as the JAX package's for all 13
    configs x 4 shapes (the 8 pairs tests/test_artifacts.py names);
  * ``model_flops`` equal to the JAX package's for every assigned pair but
    xLSTM's (ROADMAP.md R6: its ``param_count()`` is rough). The JAX values
    come from a subprocess: importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` at import, which would reach the JAX tests of this
    worker;
  * every config at full width: the port's ``params_struct`` leaves equal
    ``jax.eval_shape(model.init)``'s (shape, dtype); their bytes equal the
    dry run's unsharded bytes; at model extent 2 and 16 the sharded pieces
    summed over the model group, plus the replicated leaves once, equal
    them exactly;
  * reduced configs of each family: FLOPs and collectives counted on
    ``meta`` equal those counted on real CPU tensors in the same fake
    group, and the launches the card would make are counted on ``meta``
    only;
  * the CLIs write records (a toy pair OK, a SKIP pair, one perf pair's
    variants, the moot ones equal to their reference); a bundle that reads
    a value on ``meta`` is a FAIL naming the op, file and line.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as jax_configs
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, ShapeConfig, get_arch, shape_supported
from repro_torch.configs.base import list_archs
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.model import build_model, params_struct
from repro_torch.train.steps import build_bundle

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SKIPS = {("whisper-medium", "decode_32k"), ("whisper-medium", "long_500k"),
         ("qwen1.5-32b", "long_500k"), ("deepseek-coder-33b", "long_500k"),
         ("phi-3-vision-4.2b", "long_500k"), ("qwen2-moe-a2.7b", "long_500k"),
         ("granite-moe-1b-a400m", "long_500k"), ("nemotron-4-15b", "long_500k")}
RECORD_FIELDS = ("step", "chips", "tau_max", "scan_trip", "seconds", "flops_per_rank",
                 "flops_per_rank_raw", "collectives_per_rank", "param_bytes_per_rank",
                 "input_bytes_per_rank", "kernel_launches_per_rank", "model_flops",
                 "useful_flops_ratio", "roofline", "bottleneck", "memory")


def test_shape_supported_skips_what_the_jax_package_skips():
    assert ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert sorted(list_archs()) == sorted(jax_configs.list_archs())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    skips = set()
    for arch in list_archs():
        for s in SHAPES:
            ours = shape_supported(get_arch(arch), SHAPES[s])
            assert ours == jax_configs.shape_supported(jax_configs.get_arch(arch),
                                                       jax_configs.SHAPES[s]), (arch, s)
            if not ours[0] and arch in ASSIGNED_ARCHS:
                skips.add((arch, s))
    assert skips == SKIPS


_JAX_MODEL_FLOPS = """
import json, sys
from repro.configs import ASSIGNED_ARCHS, SHAPES, get_arch, shape_supported
from repro.launch.dryrun import model_flops
out = {}
for a in ASSIGNED_ARCHS:
    for s, shape in SHAPES.items():
        if shape_supported(get_arch(a), shape)[0]:
            out[a + "__" + s] = model_flops(get_arch(a), shape, 2)
json.dump(out, sys.stdout)
"""


def test_model_flops_equal_the_jax_packages_arithmetic():
    """The same arithmetic: given the JAX package's parameter count
    (``param_count()``) the port's ``model_flops`` is the JAX value exactly,
    for every pair. By default the port counts the initializers' shapes,
    which ``param_count()`` undercounts for every config (ROADMAP.md R6):
    the two then differ by exactly that ratio, within 5% (whisper's decoder
    positions) for all but xLSTM, whose count the initializers double."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               REPRO_XLA_FLAGS="--xla_force_host_platform_device_count=1")
    res = subprocess.run([sys.executable, "-c", _JAX_MODEL_FLOPS], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = json.loads(res.stdout)
    assert len(want) == 10 * 4 - len(SKIPS)
    for pair, v in want.items():
        arch, s = pair.split("__")
        cfg = get_arch(arch)
        assert dr.model_flops(cfg, SHAPES[s], 2, n_total=cfg.param_count()) == v, pair
        got = dr.model_flops(cfg, SHAPES[s], 2)
        n_shapes = sum(t.numel() for t in params_struct(build_model(cfg, device="meta")).values())
        active_gap = (n_shapes - cfg.param_count()) * (
            6.0 * SHAPES[s].global_batch * SHAPES[s].seq_len * 2 if s == "train_4k" else
            2.0 * SHAPES[s].global_batch * (SHAPES[s].seq_len if s == "prefill_32k" else 1))
        assert got - v == pytest.approx(active_gap, rel=1e-9), pair
        if arch == "xlstm-1.3b":  # the initializers make 3.43 B, param_count() 1.71 B
            assert got > 1.9 * v, pair
        else:
            assert v < got < 1.05 * v, pair


def _struct(arch):
    jm = jax_build_model(jax_configs.get_arch(arch))
    if jm.config.family == "toy":  # their init takes no abstract key: run it
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            jm.init(jax.random.PRNGKey(0)))
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))


def _path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@pytest.mark.parametrize("arch", sorted(jax_configs.list_archs()))
def test_param_bytes_identity(arch):
    cfg = get_arch(arch)
    tp = params_struct(build_model(cfg, device="meta"))
    jp = {_path(kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(_struct(arch))[0]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tp.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    unsharded = sum(v.numel() * v.element_size() for v in tp.values())
    for m in (2, 16):
        ranks = [dr.param_bytes(cfg, m, rank=r) for r in range(m)]
        assert all(r["unsharded"] == unsharded for r in ranks)
        assert all(r["replicated"] == ranks[0]["replicated"] for r in ranks)
        assert sum(r["sharded"] for r in ranks) + ranks[0]["replicated"] == unsharded, m
        if cfg.family != "toy":
            assert ranks[0]["sharded"] > 0, m


# ---------------------------------------------------------------------------
# meta against real CPU tensors in the same fake group
# ---------------------------------------------------------------------------

FAMILIES = {"starcoder2-3b": ("train", "prefill", "decode"),
            "granite-moe-1b-a400m": ("train", "prefill", "decode"),
            "hymba-1.5b": ("train", "prefill", "decode"),
            "xlstm-1.3b": ("train", "decode"),
            "phi-3-vision-4.2b": ("train", "prefill"),
            "whisper-medium": ("train", "prefill"),
            "cnn-mnist": ("train",)}


def _real(x):
    """A real CPU tensor for a meta input: floats 0.01, integers 1, bools
    True (counts do not depend on values)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _real(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_real(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if x.dtype == torch.bool:
        return torch.ones(x.shape, dtype=torch.bool)
    if x.is_floating_point():
        return torch.full(x.shape, 0.01, dtype=x.dtype)
    return torch.ones(x.shape, dtype=x.dtype)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_meta_counts_equal_real_cpu_counts(arch):
    cfg = get_arch(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    full = build_model(cfg, device="cpu").init(0)
    with dr.fake_world(4):
        mesh_meta = build_mesh(("data", "model"), (2, 2), device="meta")
        mesh_cpu = build_mesh(("data", "model"), (2, 2), device="cpu")
        for kind in FAMILIES[arch]:
            shape = ShapeConfig(kind, 16, 4, kind)
            kw = dict(tau_max=2) if kind == "train" else {}
            bm = build_bundle(build_model(cfg, device="meta", mesh=mesh_meta), mesh_meta, shape,
                              **kw)
            meta = dr.measure(bm.fn, *bm.shard_inputs(*bm.make_inputs()))
            bc = build_bundle(build_model(cfg, device="cpu", mesh=mesh_cpu), mesh_cpu, shape,
                              **kw)
            ins = bc.make_inputs()
            real = dr.measure(bc.fn, *bc.shard_inputs(full, *(_real(x) for x in ins[1:])))
            assert meta["flops"] == real["flops"] > 0, (arch, kind)
            assert meta["collectives"] == real["collectives"], (arch, kind)
            if cfg.family != "toy":
                assert meta["collectives"]["all_reduce"]["count"] > 0, (arch, kind)
            assert all(v == 0 for v in real["launches"].values())  # CPU: plain versions
            if kind == "train" and cfg.family != "toy":
                assert meta["launches"]["vecavg"] == 4, arch  # sharded and replicated, twice
            if cfg.norm == "rmsnorm" and cfg.family != "toy":
                assert meta["launches"]["rmsnorm"] > 0, (arch, kind)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_dryrun_cli_writes_ok_and_skip_records(tmp_path):
    assert dr.main(["--arch", "cnn-mnist", "--shape", "train_4k", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "cnn-mnist__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "OK" and rec["step"] == "train_step[sgd]" and rec["chips"] == 256
    for k in RECORD_FIELDS:
        assert k in rec, k
    assert rec["flops_per_rank"] > 0 and rec["flops_per_rank"] == rec["flops_per_rank_raw"]
    assert rec["memory"] == dict(peak_bytes=None, temp_bytes=None,
                                 reason="meta tensors have no allocator")
    assert "datasheet" in rec["roofline"]["basis"]
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["collectives_per_rank"]["all_reduce"]["count"] == 2  # gradients, loss
    assert rec["param_bytes_per_rank"]["sharded"] == 0  # the toy models replicate
    assert dr.main(["--arch", "qwen1.5-32b", "--shape", "long_500k", "--multi-pod",
                    "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "qwen1.5-32b__long_500k__pod2x16x16.json").read_text())
    assert skip["status"] == "SKIP" and "quadratic" in skip["reason"]


def test_extrapolation_over_depth_is_exact():
    """A dense config's counts at depth 4 extrapolated from depths 1 and 2
    equal the counts measured at depth 4."""
    cfg = dataclasses.replace(get_arch("starcoder2-3b").reduced(), num_layers=4)
    shape = ShapeConfig("p", 16, 4, "prefill")
    pred = dr.predict(cfg, ("data", "model"), (2, 2), dr.bundle_call(shape))
    got = dr.predict(dataclasses.replace(cfg, num_layers=1), ("data", "model"), (2, 2),
                     lambda c, mesh: dr.bundle_call(shape)(cfg, mesh))
    assert pred["scan_trip"] == 4
    assert {k: pred[k] for k in ("flops", "collectives", "launches")} == \
        {k: got["raw"][1][k] for k in ("flops", "collectives", "launches")}


def test_value_read_on_meta_is_a_fail_naming_op_file_and_line():
    """The chunk prefill bundle reads its start and length (``int()``): on
    ``meta`` that is a FAIL with the op, file and line, never a skip."""
    cfg = get_arch("qwen1.5-32b").reduced()
    with pytest.raises(Exception) as err:
        dr.predict(cfg, ("data", "model"), (1, 2),
                   dr.bundle_call(ShapeConfig("c", 64, 2, "prefill"), paged=True))
    fail = dr._failure(err.value)
    assert "meta" in fail["error"] and fail["where"].startswith("repro_torch/")
    assert ":" in fail["where"] and fail["op"]


def test_perf_cli_writes_every_variant_and_moot_ones_equal_their_reference(tmp_path):
    out, base = tmp_path / "opt", tmp_path / "base"
    assert perf.main(["--pair", "qwen1.5-32b__decode_32k", "--out", str(out),
                      "--baseline-dir", str(base)]) == 0
    assert (base / "qwen1.5-32b__decode_32k__pod16x16.json").exists()
    names = [v[0] for v in perf.VARIANTS["qwen1.5-32b__decode_32k"]]
    for name in names:
        rec = json.loads((out / f"qwen1.5-32b__decode_32k__{name}.json").read_text())
        assert rec["status"] == "OK" and rec["equals"] == "baseline"
        assert rec["matches_reference"] is True
        assert rec["delta"]["flops_per_rank"]["change"] == 0
        assert "TB" not in rec["hypothesis"] and "GB/dev" not in rec["hypothesis"]
    for pair, variants in perf.VARIANTS.items():
        for name, _, bkw, equals, hyp in variants:
            if bkw and set(bkw) <= {"fed_batch_rules", "kv_seq_shard", "cache_update"}:
                assert equals is not None, (pair, name)  # moot: must equal its reference
            assert "TB/" not in hyp and "GB/dev" not in hyp


def test_rope_freqs_is_bitwise_unchanged_and_runs_under_grad_on_meta():
    """ROADMAP.md C10: the float32 theta is made by ``torch.full`` (a
    ``torch.tensor`` copy of a Python number raised inside ``torch.func``
    on ``meta``); the frequencies keep their bits."""
    from repro_torch.models.layers import apply_rope, rope_freqs

    for hd, theta in ((32, 1e4), (64, 5e5), (96, 1e4), (128, 1e6)):
        exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
        old = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
        assert torch.equal(rope_freqs(hd, theta, "cpu"), old), (hd, theta)
    x = torch.empty(2, 4, 2, 32, device="meta")
    g = torch.func.grad(lambda t: apply_rope(t, torch.arange(4, device="meta"), 1e4).sum())(x)
    assert g.is_meta and g.shape == x.shape


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_length_extrapolation_is_exact(kind, monkeypatch):
    """xLSTM's counts are affine in the length, so the record's run at two
    short lengths extrapolated to S equals the run at S (here 8 and 16 to
    40 on the reduced config)."""
    monkeypatch.setattr(dr, "LENGTHS", (8, 16))
    cfg = get_arch("xlstm-1.3b").reduced()
    kw = dict(tau_max=2) if kind == "train" else {}
    shape = ShapeConfig(kind, 40, 4, kind)
    assert dr.by_length(cfg, shape)
    got = dr.predict_shape(cfg, ("data", "model"), (2, 2), shape, **kw)
    want = dr.predict(cfg, ("data", "model"), (2, 2), dr.bundle_call(shape, **kw))
    assert sorted(got["lengths"]) == [8, 16]
    assert got["flops"] > got["lengths"][16]["flops"] > 0
    for key in dr.COUNTED:
        assert got[key] == want[key], key
        assert got["raw"][1][key] == want["raw"][1][key], key
