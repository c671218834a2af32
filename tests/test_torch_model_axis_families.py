"""The model axis for the hybrid, xLSTM, audio and VLM families (ROADMAP.md
A18c) on 8 gloo ranks (CPU), mesh (data 4, model 2), against the JAX
package's round bundles on 8 forced host devices and against the port
unsharded.

How it runs: the JAX package runs in ONE subprocess for the module
(``tests/_jax_model_axis_families_ref.py`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), writing an npz;
the port's scenarios (``tests/_torch_model_axis_families_ranks.py``) run
on 8 gloo ranks spawned once, and again unsharded in this process. Both
packages start from ``_model_axis_setup``'s numpy params.

Bars:
  * the round bundles of reduced Hymba-1.5B and xLSTM-1.3B against JAX's
    ``build_bundle`` round and against the port unsharded: the JAX test's
    (atol 5e-5, rtol 5e-4), on the params and the statistics; tau_k rtol
    1e-6;
  * forward/loss/grad of reduced Hymba, xLSTM, whisper and phi-3-vision at
    model 2 against model 1: logits 2e-5, loss rtol 1e-6, gradients 1e-5
    of each leaf's largest entry plus 1e-8 (the key biases' gradients are
    zero but for rounding: softmax ignores a shift shared by every key);
    remat "dots" gradients bitwise equal to remat True on every rank;
  * the serving bundles against the port unsharded: greedy tokens exact,
    logits 2e-4, the gathered caches (KV rows, SSM rows, xLSTM states)
    atol 1e-5 / rtol 1e-4, positions exactly;
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
import _torch_model_axis_families_ranks as R
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import FederatedMesh, spawn
from repro_torch.models.model import build_model, params_struct
from repro_torch.sharding import partition
from repro_torch.train.steps import build_bundle

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_BAR = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_families")
    npz = tmp / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    jax_run = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_model_axis_families_ref.py"), str(npz)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        inits = {a: S.init_params(a, 0) for a in S.FAMILY_ROUNDS}
        ranks = spawn(R.rank_main, S.DATA * S.MODEL, "gloo", inits, timeout_s=400)
        ref = R.unsharded(inits)
        out, _ = jax_run.communicate(timeout=400)
        assert jax_run.returncode == 0, out
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    with np.load(npz) as z:
        jax = dict(z)
    return dict(ranks=ranks, ref=ref, jax=jax)


def _worst(a, b, atol, rtol):
    """The largest |a - b| / (atol + rtol |b|) over a tree: <= 1 passes."""
    return max(float((np.abs(a[k] - b[k]) / (atol + rtol * np.abs(b[k]))).max()) for k in b)


def _shard0(ranks):
    """Rank 0 of each client shard, in data order."""
    return [o for o in ranks if o["coords"]["model"] == 0]


@pytest.mark.parametrize("arch", S.FAMILY_ROUNDS)
def test_round_bundle_matches_jax_and_unsharded(runs, arch):
    ranks, jax, ref = runs["ranks"], runs["jax"], runs["ref"]["round"][arch]
    mine = ranks[0]["round"][arch]
    for o in ranks[1:]:
        for k, v in o["round"][arch]["params"].items():
            np.testing.assert_array_equal(v, mine["params"][k], err_msg=f"rank {o['rank']} {k}")
    n = len(arch) + len("/params/")
    jp = {k[n:]: v for k, v in jax.items() if k.startswith(f"{arch}/params/")}
    assert set(jp) == set(mine["params"])
    w_jax = _worst(mine["params"], jp, **JAX_BAR)
    w_ref = _worst(mine["params"], ref["params"], **JAX_BAR)
    print(f"{arch} round params: {w_jax:.3f} of the bar from JAX, {w_ref:.3f} from the port "
          "unsharded")
    assert w_jax <= 1 and w_ref <= 1
    for name in S.STATS:
        got = np.concatenate([o["round"][arch][name] for o in _shard0(ranks)])
        np.testing.assert_allclose(got, jax[f"{arch}/{name}"], **JAX_BAR, err_msg=name)
        np.testing.assert_allclose(got, ref[name], **JAX_BAR, err_msg=name)
        for o in ranks:  # the model ranks of a client shard agree bit for bit
            np.testing.assert_array_equal(
                o["round"][arch][name], ranks[2 * o["coords"]["data"]]["round"][arch][name])
    np.testing.assert_allclose(mine["tau_k"], jax[f"{arch}/tau_k"], rtol=1e-6)
    np.testing.assert_allclose(mine["tau_k"], ref["tau_k"], rtol=1e-6)


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
            np.testing.assert_allclose(f["grad_True"][k], g,
                                       atol=1e-5 * float(np.abs(g).max()) + 1e-8, rtol=0,
                                       err_msg=k)
            np.testing.assert_array_equal(f["grad_dots"][k], f["grad_True"][k], err_msg=k)


@pytest.mark.parametrize("key", [f"{a}/{n}" for a, names in R.SERVE.items() for n in names])
def test_serving_bundles_at_model_2_match_unsharded(runs, key):
    ranks, ref = runs["ranks"], runs["ref"]["serve"][key]
    arch, name = key.split("/")
    shard_rows = name in ("prefill", "decode", "slots")  # the paged pools stay whole
    logits = (np.concatenate([o["serve"][key]["logits"] for o in _shard0(ranks)])
              if shard_rows else ranks[0]["serve"][key]["logits"])
    act = slice(None)
    if name in ("slots", "paged"):  # inactive rows' logits are garbage
        act = R.serve_inputs(R.config(arch), name, _metas(arch, name))[-1]
    np.testing.assert_array_equal(logits[act].argmax(-1), ref["logits"][act].argmax(-1))
    np.testing.assert_allclose(logits[act], ref["logits"][act], atol=2e-4, rtol=2e-4)
    for leaf, want in ref["cache"].items():
        row = ranks[0]["serve"][key]["rows"][leaf]
        for o in ranks:  # the model ranks of a client shard gather the same leaf
            mate = ranks[o["rank"] - o["coords"]["model"]]["serve"][key]["cache"][leaf]
            np.testing.assert_array_equal(o["serve"][key]["cache"][leaf], mate, err_msg=leaf)
        got = (np.concatenate([o["serve"][key]["cache"][leaf] for o in _shard0(ranks)], row)
               if row is not None else ranks[0]["serve"][key]["cache"][leaf])
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=leaf)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=leaf)


def _metas(arch, name):
    """A serving bundle's ``make_inputs`` (the params left out)."""
    kind, kw = R.BUNDLE_KW[name]
    mesh = FederatedMesh(("data", "model"), (1, 1), rank=0, device=torch.device("cpu"),
                         group=None)
    b = build_bundle(build_model(R.config(arch), device="cpu"), mesh,
                     ShapeConfig("s", R.CAP, R.B, kind), **kw)
    return b.make_inputs()[1:]


def test_every_rank_issues_the_same_collectives(runs):
    ranks = runs["ranks"]

    def counts(o):
        return [*(r["collectives"] for r in o["round"].values()),
                *(f["collectives"] for f in o["fwd"].values()),
                *(s["collectives"] for s in o["serve"].values())]

    first = counts(ranks[0])
    assert all(c["all_reduce"] > 0 for c in first[:len(S.FAMILY_ROUNDS)])
    for o in ranks[1:]:
        assert counts(o) == first, o["rank"]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b", "whisper-medium",
                                  "phi-3-vision-4.2b"])
def test_the_four_families_lay_out_at_model_2(arch):
    for cfg in (get_arch(arch), get_arch(arch).reduced()):
        lay = partition.layout(cfg, 2)
        keys = partition.sharded_keys(params_struct(build_model(cfg, device="meta")), lay)
        assert keys and lay.embed
        if arch == "hymba-1.5b":  # the SSM on d_in; 25 heads stay whole at full width
            assert lay.ssm and lay.ssm_channels == cfg.ssm_expand * cfg.d_model // 2
            assert lay.attn == (cfg.num_heads % 2 == 0 and cfg.num_kv_heads % 2 == 0)
        if arch == "xlstm-1.3b":
            assert lay.xlstm and lay.xlstm_heads == cfg.num_heads // 2 and not lay.attn
        if arch == "whisper-medium":
            assert lay.attn and lay.mlp and "enc_pos" in keys and "frame_proj" not in keys
        if arch == "phi-3-vision-4.2b":
            assert lay.attn and lay.vocab and "vision_proj" not in keys
