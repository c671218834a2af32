"""Wire codecs and buffered commits under a model axis (ROADMAP.md A18c) on
4 gloo ranks (CPU), mesh (data 2, model 2), against the port unsharded.

How it runs: ``tests/_torch_model_axis_wire_ranks.py``'s scenarios on 4
gloo ranks spawned once for the module, and again unsharded in this
process. The reference is the port unsharded throughout: its codecs and
its engine's wire stage and buffered engine are held to the JAX package's
in ``tests/test_torch_prototype.py``, ``tests/test_torch_wire_engine.py``
and ``tests/test_torch_buffered.py``; the JAX engine runs its client axes
under ``shard_map`` and takes no model axis to compare with.

Bars:
  * the codecs: each rank's decoded pieces bitwise the unsharded codec's
    decoded rows, sliced (``partition.piece``), for int8 and top-k below,
    between and past a piece's and the leaf's sizes, on leaves cut on
    their first, last and a middle dim and one of two halves, with equal
    magnitudes across a shard boundary; one collective a call;
  * a wire round (int8, top-k), teacher-forced from the same params and
    zero residual rows: the gathered residual rows equal the unsharded
    round's up to float32 rounding but for entries whose operand sat on a
    codec boundary (the sharded products differ from the unsharded in the
    last bits), at most 1e-4 of the entries; the params equal to what the
    residual differences imply, within 1e-6
    (``tests/test_torch_wire_engine.py``'s rule); the params within the
    model-axis bar (atol 5e-5, rtol 5e-4); the wire bytes a client the
    unsharded engine's;
  * 2 buffered commits: the params within atol 5e-5 / rtol 5e-4, the
    commits' rows (loss rtol 1e-5; taus, ages and simulated time exactly);
  * the ranks of a model group agree bit for bit, and every rank issues
    the same collectives; a buffered run whose model ranks draw their
    latencies from different seeds is refused.
"""
import numpy as np
import pytest
import torch

import _torch_model_axis_wire_ranks as W
from repro_torch.configs import get_arch
from repro_torch.core.buffered import BufferedRoundEngine
from repro_torch.core.controller import ControllerConfig, ControllerCore
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.wire import make_codec, roundtrip_rows
from repro_torch.data.device import DeviceShards
from repro_torch.data.synthetic import make_classification
from repro_torch.launch.mesh import FederatedMesh, spawn
from repro_torch.models.model import build_model
from repro_torch.sharding import partition

torch.set_num_threads(2)

BAR = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(scope="module")
def runs():
    ranks = spawn(W.rank_main, W.DATA * W.MODEL, "gloo", timeout_s=400)
    return dict(ranks=ranks, ref=W.unsharded())


@pytest.mark.parametrize("spec", W.CODECS)
def test_codec_pieces_are_the_unsharded_codec_sliced(runs, spec):
    whole = {k: torch.from_numpy(v) for k, v in W.codec_rows().items()}
    want = roundtrip_rows(make_codec(spec), whole)
    for o in runs["ranks"]:
        got = o["codecs"][spec]
        for path, _, dim, halves in W.LEAVES:
            piece = partition.piece(want[path], dim + 1, halves, o["coords"]["model"], W.MODEL)
            np.testing.assert_array_equal(got["decoded"][path], piece.numpy(),
                                          err_msg=f"{spec} {path} rank {o['rank']}")
        sent_whole = spec == "topk:200"  # every leaf has at most 200 entries
        n = 0 if sent_whole else 1
        assert got["collectives"]["all_reduce"] == (n if spec == "int8" else 0)
        assert got["collectives"]["all_gather"] == (0 if spec == "int8" else n)
    # the ties matter: top-3 of a leaf picks one of two equal magnitudes
    # on the two sides of a boundary, int8's scale is the tie's
    assert all(float(np.abs(v).max()) == W.TIE for v in W.codec_rows().values())


@pytest.mark.parametrize("spec", W.WIRES)
def test_wire_round_matches_unsharded(runs, spec):
    ranks, ref = runs["ranks"], runs["ref"]["wire"][spec]
    mine = ranks[0]["wire"][spec]
    for o in ranks[1:]:
        for part in ("params", "residual"):
            for k, v in o["wire"][spec][part].items():
                np.testing.assert_array_equal(v, mine[part][k], err_msg=f"{o['rank']} {k}")
        assert o["wire"][spec]["collectives"] == mine["collectives"]
    assert mine["bytes_per_client"] == ref["bytes_per_client"]
    pw = np.full(W.C, 1.0 / W.C)
    tau = W.TAUS.astype(np.float64)
    tau_k = float((pw * tau).sum())
    flips = total = 0
    for k, want in ref["residual"].items():
        got = mine["residual"][k]
        assert got.shape == want.shape and want.shape[0] == W.C
        scale = np.abs(want).reshape(W.C, -1).max(1).reshape((W.C,) + (1,) * (want.ndim - 1))
        flips += int((np.abs(got - want) > 1e-6 + 1e-3 * scale).sum())
        total += want.size
        implied = sum(W.ETA * tau_k * pw[c] * (got[c] - want[c]).astype(np.float64) / tau[c]
                      for c in range(W.C))
        d = mine["params"][k].astype(np.float64) - ref["params"][k]
        np.testing.assert_allclose(d, implied, atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(mine["params"][k], ref["params"][k], **BAR, err_msg=k)
    print(f"{spec}: {flips} of {total} residual entries on a codec boundary")
    assert flips <= 1e-4 * total


def test_buffered_commits_match_unsharded(runs):
    ranks, ref = runs["ranks"], runs["ref"]["buffered"]
    mine = ranks[0]["buffered"]
    for o in ranks[1:]:
        for k, v in o["buffered"]["params"].items():
            np.testing.assert_array_equal(v, mine["params"][k], err_msg=f"{o['rank']} {k}")
        assert o["buffered"]["collectives"] == mine["collectives"]
    for k, v in ref["params"].items():
        np.testing.assert_allclose(mine["params"][k], v, **BAR, err_msg=k)
    assert mine["waves"] == ref["waves"] and len(mine["rows"]) == len(ref["rows"]) == 2
    for got, want in zip(mine["rows"], ref["rows"]):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
        for f in ("tau", "tau_k", "mean_age", "max_age", "sim_time"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_buffered_engine_checks_its_model_group_draws_alike(runs):
    """Waves, cohorts and latency draws are host state that every rank of a
    model group must draw alike; a run whose ranks seed them differently is
    refused at its first dispatch, on every rank."""
    for o in runs["ranks"]:
        assert o["diverged"] is not None and "model group" in o["diverged"], o["rank"]


def _hand_mesh(data, model):
    return FederatedMesh(("data", "model"), (data, model), rank=0, device=torch.device("cpu"),
                         group=None)


def test_model_axis_engine_needs_the_model_and_its_controller():
    """The engine refuses a model-axis mesh without the model built for it,
    and a controller without the model's axis (its L estimate would read a
    rank's pieces); with both it builds, under a lossy codec and under the
    buffered engine, and counts the whole leaves' wire bytes."""
    cfg = get_arch(W.ARCH).reduced()
    mesh = _hand_mesh(1, 2)
    model = build_model(cfg, device="cpu", mesh=mesh)
    orig = make_classification(16, (4,), 2, seed=0)
    shards = DeviceShards.from_datasets([orig, orig], device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="model_axis"):
        RoundEngine(model.loss, EngineConfig(), num_clients=2, mesh=mesh)
    with pytest.raises(ValueError, match="model_axis"):
        RoundEngine(model.loss, EngineConfig(), num_clients=2, mesh=mesh, shards=shards,
                    controller=ControllerCore(ControllerConfig(eta=0.01), 2, mesh=mesh),
                    model_axis=model.model_axis)
    ctl = ControllerCore(ControllerConfig(eta=0.01, tau_max=2), 2, mesh=mesh,
                         model_axis=model.model_axis)
    kw = dict(num_clients=2, controller=ctl, mesh=mesh, shards=shards,
              model_axis=model.model_axis)
    eng = RoundEngine(model.loss, EngineConfig(wire="int8"), **kw)
    unsharded = RoundEngine(build_model(cfg, device="cpu").loss, EngineConfig(wire="int8"),
                            num_clients=2)
    full = build_model(cfg, device="cpu").init(0)
    pieces = partition.shard_params(full, mesh, cfg)  # rank 0's
    assert eng.wire_active
    assert eng.wire_bytes_per_client(pieces) == unsharded.wire_bytes_per_client(full)
    BufferedRoundEngine(RoundEngine(model.loss, EngineConfig(), **kw),
                        np.full(2, 0.5, np.float32))
