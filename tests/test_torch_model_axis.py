"""The port's model axis (ROADMAP.md A18b) on 8 gloo ranks (CPU), mesh
(data 4, model 2), against the JAX package's step bundles on 8 forced host
devices and against the port unsharded.

How it runs: the JAX package runs in ONE subprocess for the module
(``tests/_jax_model_axis_ref.py`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), writing an npz;
the port's scenarios (``tests/_torch_model_axis_ranks.py``) run on 8 gloo
ranks spawned once, and again unsharded in this process. Both packages
start from ``_model_axis_setup``'s numpy params.

Bars:
  * the round bundle of reduced granite-moe-1b-a400m against JAX's
    ``build_bundle`` round: the JAX test's (atol 5e-5, rtol 5e-4), on the
    params and the statistics; against the port unsharded the same bar
    (printed: the observed maxima); tau_k rtol 1e-6;
  * the SGD step (reduced Qwen1.5-32B, vocab-parallel head) against JAX's
    and the port unsharded: params atol 1e-5, loss rtol 1e-5;
  * forward/loss/grad at model 2 against model 1: logits 2e-5, loss rtol
    1e-6, gradients 1e-5 of each leaf's largest entry; remat "dots"
    gradients bitwise equal to remat True on every rank;
  * the serving bundles against the port unsharded: greedy tokens exact,
    logits 2e-4, the gathered caches and pools atol 1e-5 / rtol 1e-4
    (tests/test_torch_serve_families.py's bars), positions exactly;
  * every rank issues the same collectives; model-sized outputs are
    bitwise equal on the ranks of one model group and across client
    shards.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _model_axis_setup as S
import _torch_model_axis_ranks as R
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import FederatedMesh, spawn
from repro_torch.models.model import build_model
from repro_torch.train.steps import build_bundle

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_BAR = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    npz = tmp / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    jax_run = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_model_axis_ref.py"),
                                str(npz)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        inits = (S.init_params(S.ROUND["arch"], 0), S.init_params(S.SGD["arch"], 0))
        ranks = spawn(R.rank_main, S.DATA * S.MODEL, "gloo", *inits, timeout_s=400)
        ref = R.unsharded(*inits)
        out, _ = jax_run.communicate(timeout=400)
        assert jax_run.returncode == 0, out
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    with np.load(npz) as z:
        jax = dict(z)
    return dict(ranks=ranks, ref=ref, jax=jax)


def _jtree(jax, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in jax.items() if k.startswith(prefix + "/")}


def _worst(a, b, atol, rtol):
    """The largest |a - b| / (atol + rtol |b|) over a tree: <= 1 passes."""
    return max(float((np.abs(a[k] - b[k]) / (atol + rtol * np.abs(b[k]))).max()) for k in b)


def _shard0(ranks):
    """Rank 0 of each client shard, in data order."""
    return [o for o in ranks if o["coords"]["model"] == 0]


def test_round_bundle_matches_jax_and_unsharded(runs):
    ranks, jax, ref = runs["ranks"], runs["jax"], runs["ref"]["round"]
    mine = ranks[0]["round"]
    for o in ranks[1:]:
        for k, v in o["round"]["params"].items():
            np.testing.assert_array_equal(v, mine["params"][k], err_msg=f"rank {o['rank']} {k}")
    jp = _jtree(jax, "round/params")
    assert set(jp) == set(mine["params"])
    w_jax, w_ref = _worst(mine["params"], jp, **JAX_BAR), _worst(mine["params"],
                                                                 ref["params"], **JAX_BAR)
    d_jax = max(float(np.abs(mine["params"][k] - jp[k]).max()) for k in jp)
    d_ref = max(float(np.abs(mine["params"][k] - ref["params"][k]).max()) for k in jp)
    print(f"round params: max|port sharded - JAX| {d_jax:.3e} ({w_jax:.3f} of the bar), "
          f"max|port sharded - port unsharded| {d_ref:.3e} ({w_ref:.3f} of the bar)")
    assert w_jax <= 1 and w_ref <= 1
    for name in S.STATS:
        got = np.concatenate([o["round"][name] for o in _shard0(ranks)])
        np.testing.assert_allclose(got, jax[f"round/{name}"], **JAX_BAR, err_msg=name)
        np.testing.assert_allclose(got, ref[name], **JAX_BAR, err_msg=name)
        for o in ranks:  # the model ranks of a client shard agree bit for bit
            np.testing.assert_array_equal(
                o["round"][name], ranks[2 * o["coords"]["data"]]["round"][name])
    np.testing.assert_allclose(mine["tau_k"], jax["round/tau_k"], rtol=1e-6)
    np.testing.assert_allclose(mine["tau_k"], ref["tau_k"], rtol=1e-6)


def test_sgd_bundle_matches_jax_and_unsharded(runs):
    ranks, jax, ref = runs["ranks"], runs["jax"], runs["ref"]["sgd"]
    mine = ranks[0]["sgd"]
    for o in ranks[1:]:
        for k, v in o["sgd"]["params"].items():
            np.testing.assert_array_equal(v, mine["params"][k])
    jp = _jtree(jax, "sgd/params")
    for k in jp:
        np.testing.assert_allclose(mine["params"][k], jp[k], atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(mine["params"][k], ref["params"][k], atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(mine["loss"], float(jax["sgd/loss"]), rtol=1e-5)
    np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("arch", R.FWD)
def test_forward_loss_grad_at_model_2_match_model_1(runs, arch):
    ranks, ref = runs["ranks"], runs["ref"]["fwd"][arch]
    for o in ranks:
        f = o["fwd"][arch]
        for impl in ("auto", "pallas"):
            np.testing.assert_allclose(f[f"logits_{impl}"], ref[f"logits_{impl}"], atol=2e-5,
                                       rtol=0, err_msg=impl)
        np.testing.assert_allclose(f["loss"], ref["loss"], rtol=1e-6)
        if "grad_True" not in f:
            continue
        for k, g in ref["grad_True"].items():
            scale = float(np.abs(g).max()) or 1.0
            np.testing.assert_allclose(f["grad_True"][k], g, atol=1e-5 * scale, rtol=0,
                                       err_msg=k)
            np.testing.assert_array_equal(f["grad_dots"][k], f["grad_True"][k], err_msg=k)


def _assemble(ranks, key, shard_rows):
    """A serving bundle's full cache from the ranks' pieces: kv heads over
    the model coordinate (dim 3 of k/v), rows over the data coordinate
    (dim 1) where ``shard_rows``."""
    out = []
    for i in range(len(ranks[0]["serve"][key]["cache"])):
        rows = []
        for d in range(S.DATA if shard_rows else 1):
            pieces = [o["serve"][key]["cache"][i] for o in ranks if o["coords"]["data"] == d]
            rows.append(pieces[0] if pieces[0].ndim < 5 else np.concatenate(pieces, axis=3))
        out.append(np.concatenate(rows, axis=1) if shard_rows else rows[0])
    return out


@pytest.mark.parametrize("key", [f"{a}/{n}" for a, names in R.SERVE.items() for n in names])
def test_serving_bundles_at_model_2_match_unsharded(runs, key):
    ranks, ref = runs["ranks"], runs["ref"]["serve"][key]
    name = key.split("/")[1]
    shard_rows = name in ("prefill", "decode", "slots")  # the paged pools stay whole
    logits = (np.concatenate([o["serve"][key]["logits"] for o in _shard0(ranks)])
              if shard_rows else ranks[0]["serve"][key]["logits"])
    act = slice(None)
    if name in ("slots", "paged"):  # inactive rows' logits are garbage
        act = R.serve_inputs(R.fwd_config(key.split("/")[0]), name)[-1]
    np.testing.assert_array_equal(logits[act].argmax(-1), ref["logits"][act].argmax(-1))
    np.testing.assert_allclose(logits[act], ref["logits"][act], atol=2e-4, rtol=2e-4)
    for got, want in zip(_assemble(ranks, key, shard_rows), ref["cache"], strict=True):
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_every_rank_issues_the_same_collectives(runs):
    ranks = runs["ranks"]

    def counts(o):
        return [o["round"]["collectives"], o["sgd"]["collectives"],
                *(f["collectives"] for f in o["fwd"].values()),
                *(s["collectives"] for s in o["serve"].values())]

    first = counts(ranks[0])
    assert first[0]["all_reduce"] > 0 and first[1]["all_reduce"] > 0
    for o in ranks[1:]:
        assert counts(o) == first, o["rank"]


def _meta_desc(ins):
    out = []

    def walk(x):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
        else:
            out.append(f"{tuple(x.shape)}:{str(x.dtype).split('.')[-1]}")

    walk(ins)
    return ";".join(out)


def _hand_mesh(data, model):
    return FederatedMesh(("data", "model"), (data, model), rank=0, device=torch.device("cpu"),
                         group=None)


@pytest.mark.parametrize("arch", [S.ROUND["arch"], S.SGD["arch"]])
def test_make_inputs_equal_the_jax_bundles(runs, arch):
    import _jax_model_axis_ref as J  # the bundle table only; no JAX computation here

    jax = runs["jax"]
    model = build_model(get_arch(arch).reduced(), device="cpu")
    for name, (kind, kw) in J.BUNDLES.items():
        b = build_bundle(model, _hand_mesh(S.DATA, S.MODEL), ShapeConfig("s", 32, 8, kind),
                         tau_max=2, **dict(kw))
        assert _meta_desc(b.make_inputs()) == str(jax[f"inputs/{arch}/{name}"]), name
        assert all(t.is_meta for t in _leaves(b.make_inputs()))


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [x]


@pytest.mark.parametrize("module", ["dryrun", "perf"])
def test_dryrun_and_perf_raise_naming_a18c(module, tmp_path):
    """The dry run and the perf driver (once A18d, ported) write their
    records: a toy pair's, and the Qwen1.5-32B decode pair's variants."""
    from repro_torch.launch import dryrun, perf

    if module == "dryrun":
        assert dryrun.main(["--arch", "cnn-mnist", "--shape", "train_4k",
                            "--out", str(tmp_path)]) == 0
        assert len(list(tmp_path.glob("cnn-mnist__train_4k__pod16x16.json"))) == 1
    else:
        assert perf.main(["--pair", "qwen1.5-32b__decode_32k", "--out", str(tmp_path / "opt"),
                          "--baseline-dir", str(tmp_path / "base")]) == 0
        assert len(list((tmp_path / "opt").glob("*.json"))) == 3


def _meta_predictions():
    """The dry run's counts (``meta`` tensors, a fake group of 8 ranks on
    (data 4, model 2), rank 0) of the ranks' round, SGD, forward and
    serving scenarios."""
    from repro_torch.launch import dryrun

    out = {}
    with dryrun.fake_world(S.DATA * S.MODEL):
        from repro_torch.launch.mesh import build_mesh

        mesh = build_mesh(("data", "model"), (S.DATA, S.MODEL), device="meta")

        def count(fn, *args):
            return dryrun.measure(fn, *args)["collectives"]

        cfg = get_arch(S.ROUND["arch"]).reduced()
        b = build_bundle(build_model(cfg, device="meta", mesh=mesh), mesh,
                         ShapeConfig("t", S.ROUND["seq"], S.ROUND["batch"], "train"),
                         tau_max=S.ROUND["tau_max"], eta=S.ROUND["eta"])
        out["round"] = count(b.fn, *b.shard_inputs(*b.make_inputs()))
        cfg = get_arch(S.SGD["arch"]).reduced()
        b = build_bundle(build_model(cfg, device="meta"), mesh,
                         ShapeConfig("t", S.SGD["seq"], S.SGD["batch"], "train"), plain_sgd=True,
                         eta=S.SGD["eta"])
        out["sgd"] = count(b.fn, *b.shard_inputs(*b.make_inputs()))
        for name in R.FWD:
            cfg = R.fwd_config(name)
            model = build_model(cfg, device="meta", mesh=mesh)
            params = model.init(0)
            batch = {k: torch.empty((2, 16), dtype=torch.int32, device="meta")
                     for k in ("tokens", "targets")}

            def run():
                for impl in ("auto", "pallas"):
                    model.forward(params, batch, impl=impl)
                model.loss(params, batch)
                for remat in (True, "dots"):
                    torch.func.grad(lambda p: model.loss(p, batch, remat=remat)[0])(params)

            out[f"fwd/{name}"] = count(run)
        for arch, names in R.SERVE.items():
            cfg = R.fwd_config(arch)
            for name in names:
                kind, kw = R.BUNDLE_KW[name]
                b = build_bundle(build_model(cfg, device="meta"), mesh,
                                 ShapeConfig("s", R.CAP, R.B, kind), **kw)
                # the scenario's own inputs (its prompt is shorter than CAP; the
                # chunk's start and length are host ints), moved to meta
                state = [R._torch_state(x) for x in R.serve_inputs(cfg, name)]
                ins = b.shard_inputs(b.make_inputs()[0], *state)
                out[f"serve/{arch}/{name}"] = count(b.fn, *ins)
    return out


def test_dryrun_collectives_equal_the_gloo_ranks(runs):
    """ROADMAP.md A18d's gate: the collectives the dry run counts on
    ``meta`` (count and bytes, all-reduce and all-gather) are the ones each
    gloo rank issued for the round, SGD, forward and serving scenarios."""
    pred = _meta_predictions()
    for o in runs["ranks"]:
        got = {"round": o["round"]["collectives"], "sgd": o["sgd"]["collectives"],
               **{f"fwd/{n}": f["collectives"] for n, f in o["fwd"].items()},
               **{f"serve/{n}": s["collectives"] for n, s in o["serve"].items()}}
        assert set(got) == set(pred)
        for k, c in got.items():
            want = pred[k]
            assert (c["all_reduce"], c["all_gather"]) == \
                (want["all_reduce"]["count"], want["all_gather"]["count"]), (o["rank"], k)
            assert c["bytes"] == want["all_reduce"]["bytes"] + want["all_gather"]["bytes"], \
                (o["rank"], k)
        assert sum(c["all_reduce"] for c in got.values()) > 0
