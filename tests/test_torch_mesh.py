"""The port's federated mesh and client axis (``launch/mesh.py``,
``sharding/api.py``): the builders in this process (a world of one rank)
and in spawned gloo worlds on the CPU, the data path's rank rows, the
refusals (strict mesh, indivisible C, nccl without a card a rank, the
production mesh in a small world, the launcher's flags), the model axis'
coordinates and process groups, a failed rank stopping its world,
``fed.simulator.run_on_ranks`` against the unsharded simulator, and the
launcher's ``--data-axis 2 --model-axis 2`` on 4 ranks against the
launcher unsharded."""
import numpy as np
import pytest
import torch

from repro_torch.data import synthetic as tsyn
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.mesh import (
    CLIENT_AXES,
    FederatedMesh,
    RankFailed,
    build_mesh,
    init_ranks,
    make_federated_mesh,
    make_host_mesh,
    make_production_mesh,
    num_clients,
    spawn,
)
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import parse_args
from repro_torch.sharding import api

torch.set_num_threads(2)

C = 16


def _datasets(n=C):
    orig = tsyn.make_classification(n * 4, (6,), 10, seed=0)
    return [tsyn.Dataset(orig.x[i::n], orig.y[i::n]) for i in range(n)]


def _hand_mesh(data, pod=1, rank=0):
    """A client-axis mesh made by hand, without a process group."""
    return FederatedMesh(CLIENT_AXES, (pod, data), rank=rank, device=torch.device("cpu"),
                         group=None)


# ---------------------------------------------------------------------------
# in this process: a world of one rank
# ---------------------------------------------------------------------------


def test_build_mesh_strict_raises_with_hint():
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 4"):
        build_mesh(("data",), (4,), device="cpu")
    with pytest.raises(RuntimeError, match="--mesh data=2"):
        make_federated_mesh(2, device="cpu")


def test_build_mesh_shrink_fits_a_world_of_one():
    m = build_mesh(CLIENT_AXES, (2, 8), shrink=True, device="cpu")
    assert m.shape == {"pod": 1, "data": 1} and m.size == 1 and m.group is None
    h = make_host_mesh(2, device="cpu")
    assert h.shape == {"data": 1, "model": 1} and num_clients(h) == 1
    f = make_federated_mesh(device="cpu")
    assert f.shape == {"pod": 1, "data": 1} and f.coords == {"pod": 0, "data": 0}
    assert f.device == torch.device("cpu") and api.client_group(f) is None


def test_build_mesh_validates_shape():
    with pytest.raises(ValueError, match="mismatch"):
        build_mesh(("data",), (1, 1), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        build_mesh(("data",), (0,), device="cpu")


def test_federated_mesh_pod_divisibility():
    with pytest.raises(ValueError, match="pod"):
        make_federated_mesh(3, pod=2, device="cpu")


def test_model_axis_and_production_mesh_raise_naming_a18b(world):
    """The model axis: its coordinates and process groups in a spawned
    world of 8 (mesh (data 4, model 2): ranks 2s and 2s + 1 share client
    shard s); the production mesh strict in a small world (the start
    hint), shrunk with ``smoke=True``; only the client axes and 'model'
    may exceed 1."""
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 256"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    m = make_production_mesh(smoke=True, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.model_size == 1 and m.model_group is None
    assert make_production_mesh(multi_pod=True, smoke=True, device="cpu").shape == {
        "pod": 1, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="may exceed 1"):
        build_mesh(("data", "seq"), (1, 2), device="cpu")
    with pytest.raises(RuntimeError, match="--model-axis M"):
        build_mesh(("data", "model"), (1, 2), device="cpu")
    assert make_host_mesh(1, 2, device="cpu").shape == {"data": 1, "model": 1}
    for r, o in enumerate(world):
        d, j = divmod(r, 2)
        assert o["model_coords"] == {"data": d, "model": j}
        assert o["model_rows"] == [d]  # a client shard's ranks hold the same clients
        # the model group sums the two ranks of the rank's client shard; the
        # client group the four ranks that share its model coordinate
        np.testing.assert_array_equal(o["model_sum"], [4.0 * d + 1.0])
        np.testing.assert_array_equal(o["client_sum"], [sum(2.0 * s + j for s in range(4))])


def _launch(flags):
    return train_main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                       "--rounds", "3", "--seq", "16", "--batch-per-client", "2"] + flags)


@pytest.mark.parametrize("flags,item", [(["--production-mesh"], "256"),
                                        (["--model-axis", "2"], None),
                                        (["--sanitize"], "A19")])
def test_launcher_flags_not_ported_raise(flags, item):
    """``--sanitize`` (once A19, ported) gives the rows of the plain run bit
    for bit; ``--production-mesh`` raises in a
    world smaller than its 256 ranks, with the start hint; ``--data-axis 2
    --model-axis 2`` runs on 4 spawned CPU ranks (C = the data extent, 2
    clients) and gives the rows of the launcher unsharded on the same 2
    clients: tau traces exactly, losses to float32 noise."""
    if flags == ["--sanitize"]:
        assert parse_args(["--arch", "starcoder2-3b", "--reduced"] + flags).sanitize
        rows, ref = _launch(flags), _launch([])
        assert len(rows) == len(ref) == 3
        for a, b in zip(rows, ref):
            np.testing.assert_array_equal(a["tau"], b["tau"])
            assert a["train_loss"] == b["train_loss"]
        return
    if flags == ["--production-mesh"]:
        with pytest.raises(RuntimeError, match=f"nproc-per-node {item}"):
            _launch(flags)
        return
    rows = _launch(["--data-axis", "2", "--model-axis", "2"])
    ref = _launch(["--mesh", "data=1", "--clients-per-shard", "2"])
    assert len(rows) == len(ref) == 3
    for a, b in zip(rows, ref):
        np.testing.assert_array_equal(a["tau"], b["tau"])
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(a["tau_k"], b["tau_k"], rtol=1e-6)
    with pytest.raises(SystemExit):
        parse_args(["--arch", "starcoder2-3b", "--mesh", "data=2", "--model-axis", "2"])


def test_launcher_mesh_flag_parses():
    a = parse_args(["--arch", "starcoder2-3b", "--mesh", "pod=2,data=4"])
    assert (a.pod, a.data, a.backend, a.device) == (2, 4, "gloo", None)
    with pytest.raises(SystemExit):
        parse_args(["--arch", "starcoder2-3b", "--mesh", "model=2"])


def test_validate_client_count_divides_evenly():
    m = _hand_mesh(8, pod=1)
    assert api.validate_client_count(None, 7) == 1
    assert api.validate_client_count(m, 16) == 8
    with pytest.raises(ValueError, match="divide evenly"):
        api.validate_client_count(m, 10)
    with pytest.raises(ValueError, match="divide evenly"):
        from repro_torch.data.device import DeviceShards

        DeviceShards.from_datasets(_datasets(10), device="cpu", mesh=m)


def test_client_rows_and_coords_of_a_two_axis_mesh():
    for r in range(8):
        m = _hand_mesh(4, pod=2, rank=r)
        assert m.coords == {"pod": r // 4, "data": r % 4}
        assert api.shard_index(m) == r
        assert api.client_rows(m, C) == range(2 * r, 2 * r + 2)
    assert api.client_axes(build_mesh(("data", "model"), (1, 1), device="cpu")) == ("data",)


def test_nccl_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="backend='gloo'"):
        init_ranks("nccl", rank=0, world=torch.cuda.device_count() + 1,
                   init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="backend"):
        init_ranks("mpi", rank=0, world=1)


def test_gloo_rank_without_a_card_raises(monkeypatch):
    """A rank asked for the card (the default) raises without one; nothing
    drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_federated_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        lmesh.rank_device(None)


# ---------------------------------------------------------------------------
# spawned gloo worlds
# ---------------------------------------------------------------------------


def _world_rank(datasets):
    m = make_federated_mesh(device="cpu")
    m2 = make_federated_mesh(8, pod=2, device="cpu")
    from repro_torch.data.device import DeviceShards

    shards = DeviceShards.from_datasets(datasets, mesh=m)
    out = dict(rank=m.rank, shape=m.shape, shape2=m2.shape, coords2=m2.coords,
               clients=num_clients(m2), rows=list(shards.rows), x=shards.x.numpy(),
               sizes=shards.sizes, device=str(shards.device))
    try:
        DeviceShards.from_datasets(datasets[:10], mesh=m)
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        make_federated_mesh(4, device="cpu")
    except RuntimeError as e:
        out["part_of_world"] = str(e)
    g = api.client_group(m)
    s = torch.full((3,), float(m.rank + 1))
    mx = torch.tensor([float(m.rank)])
    out["sum"], out["max"] = [t.numpy() for t in api.all_reduce([s, mx], g)]
    out["max_op"] = api.all_reduce([mx], g, op="max")[0].numpy()
    out["gather"] = api.all_gather(torch.tensor([[m.rank, 10 * m.rank]]), g).numpy()
    out["collectives"] = dict(api.collectives)
    mm = make_host_mesh(4, 2, device="cpu")
    one = torch.tensor([float(mm.rank)])
    out.update(model_coords=mm.coords, model_rows=list(api.client_rows(mm, 4)),
               model_sum=api.all_reduce([one], mm.model_group)[0].numpy(),
               client_sum=api.all_reduce([one], mm.group)[0].numpy())
    return out


@pytest.fixture(scope="module")
def world():
    return spawn(_world_rank, 8, "gloo", _datasets(), timeout_s=240)


def test_spawned_world_meshes_shards_and_collectives(world):
    ds, outs = _datasets(), world
    for s, o in enumerate(outs):
        assert o["rank"] == s and o["device"] == "cpu"
        assert o["shape"] == {"pod": 1, "data": 8}
        assert o["shape2"] == {"pod": 2, "data": 4} and o["clients"] == 8
        assert o["coords2"] == {"pod": s // 4, "data": s % 4}
        # rank s holds exactly the rows [2s, 2s + 2) of the 16 clients
        assert o["rows"] == [2 * s, 2 * s + 1]
        for j, i in enumerate(o["rows"]):
            np.testing.assert_array_equal(o["x"][j, : len(ds[i])], ds[i].x)
            assert o["sizes"][j] == len(ds[i])
        assert "divide evenly" in o["indivisible"]
        assert "covers 4 of the 8 ranks" in o["part_of_world"]
        np.testing.assert_array_equal(o["sum"], np.full(3, 36.0))  # 1 + ... + 8
        np.testing.assert_array_equal(o["max"], [28.0])  # the sum of the ranks
        np.testing.assert_array_equal(o["max_op"], [7.0])
        np.testing.assert_array_equal(o["gather"], [[r, 10 * r] for r in range(8)])
        # one all-reduce a dtype (the two float32 tensors travel together)
        assert o["collectives"]["all_reduce"] == 2 and o["collectives"]["all_gather"] == 1


def _fail_on_rank1():
    m = make_federated_mesh(device="cpu")
    if m.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    api.all_reduce([torch.ones(1)], m.group)  # rank 0 waits here until it is stopped
    return m.rank


def test_a_failed_rank_fails_the_world():
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        spawn(_fail_on_rank1, 2, "gloo", timeout_s=120)


def test_run_on_ranks_matches_the_unsharded_simulator():
    """``fed.simulator.run_on_ranks``: 2 gloo ranks of the SVM simulator,
    one round of host batches from one state, then 2 rounds of the device
    data path (one world), against the simulator in this process."""
    from repro_torch.fed.simulator import FederatedSimulator, FedSimConfig, run_on_ranks
    from repro_torch.models.model import build_model_by_name

    orig = tsyn.make_classification(C * 30, (784,), 10, seed=0)
    train = tsyn.binarize_even_odd(orig)
    ds = [tsyn.Dataset(train.x[i::4], train.y[i::4]) for i in range(4)]
    arch = build_model_by_name("svm-mnist", device="cpu").config
    model = build_model_by_name("svm-mnist", device="cpu")
    params = model.init(3)
    cfgs = [FedSimConfig(rounds=rounds, tau_max=4, batch_size=8, eta=0.05,
                         data_path=data_path) for data_path, rounds in (("host", 1),
                                                                          ("device", 2))]
    outs = run_on_ranks(2, "gloo", arch, ds, cfgs, device="cpu", params=params)
    for i, cfg in enumerate(cfgs):
        ref = FederatedSimulator(model, ds, cfg).run(params={k: v.clone()
                                                             for k, v in params.items()})
        assert len(outs[0][i]["rows"]) == cfg.rounds and outs[1][i]["rows"] == []
        for o in (outs[0][i], outs[1][i]):
            for k in params:
                np.testing.assert_allclose(o["params"][k].numpy(), ref.params[k].numpy(),
                                           atol=1e-6, rtol=0)
            for k, v in ref.controller_state.vals.items():
                np.testing.assert_allclose(o["vals"][k], v.numpy(), rtol=1e-5, atol=1e-6)
            assert o["launches"]["vecavg"] == 0  # the CPU takes the plain version
            assert o["collectives"]["all_reduce"] > 0 and o["ms_per_round"] > 0
            assert o["all_reduce_ms"] > 0
        for a, b in zip(outs[0][i]["rows"], ref.rows, strict=True):
            np.testing.assert_array_equal(a["tau"], b["tau"])
