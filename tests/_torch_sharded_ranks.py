"""The port's side of ``tests/test_torch_sharded_round.py``: each scenario
runs with a federated mesh on every rank of a spawned gloo world, and with
``mesh=None`` in the test process (the unsharded port); torch only.

Results are numpy. Per-client fields are the rank's rows (the test
concatenates them in rank order); everything model-sized is the same on
every rank.
"""
import warnings

import numpy as np
import torch

import _sharded_setup as S
from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel
from repro_torch.core.controller import ControllerConfig, ControllerCore
from repro_torch.core.driver import TrainDriver
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.data.device import DeviceShards, round_key
from repro_torch.fed.simulator import FederatedSimulator, FedSimConfig
from repro_torch.launch.mesh import make_federated_mesh
from repro_torch.models.model import build_model_by_name

STATS = ("loss0", "beta", "delta", "g0_sqnorm")
WIRES = ("int8", "topk:50")
WIRE_ROUNDS = 5


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def engine(model, ds, mesh, mode="fedveca", agg="fallback", cohort=None, controller=False,
           wire="none"):
    ctl = (ControllerCore(ControllerConfig(eta=S.ETA, tau_max=S.TAU_MAX), S.C, mesh=mesh)
           if controller else None)
    return RoundEngine(
        model.loss,
        EngineConfig(mode=mode, eta=S.ETA, tau_max=S.TAU_MAX, batch_size=S.BATCH,
                     cohort_size=cohort, aggregator=agg, mu=S.MU, wire=wire),
        shards=DeviceShards.from_datasets(ds, device="cpu", mesh=mesh),
        num_clients=S.C, controller=ctl, mesh=mesh)


def _round_out(newp, st, scaf=None):
    out = dict(params=_np(newp), tau_k=float(st.tau_k), global_grad=_np(st.global_grad),
               **{k: getattr(st, k).numpy() for k in STATS})
    if scaf is not None:
        out.update(c=_np(scaf.c), c_i=_np(scaf.c_i))
    return out


def one_rounds(model, ds, params, mesh):
    """One round of every mode and aggregator, and a balanced and an
    imbalanced cohort round, on host batches."""
    p, tau, b = S.weights(), S.taus(), _t(S.batches())
    out = {}
    for mode in S.MODES:
        for agg in S.AGGS:
            out[f"{mode}/{agg}"] = _round_out(*engine(model, ds, mesh, mode, agg).run_round(
                params, tau, p, S.GPREV, batches=b))
    for name, cohort in (("balanced", S.BALANCED), ("imbalanced", S.IMBALANCED)):
        newp, st, _ = engine(model, ds, mesh).run_round(params, tau, p, S.GPREV, batches=b,
                                                        cohort=cohort)
        out[name] = _round_out(newp, st)
    return out


def trajectories(model, ds, params, mesh):
    """6 fused rounds on real-data host batches, all clients and 8 a
    round (the stratified cohorts a sharded engine draws from
    ``default_rng(0)``, given to the unsharded engine too)."""
    out = {}
    for name, m in (("all", None), ("eight", 8)):
        eng = engine(model, ds, mesh, cohort=m, controller=True)
        cohorts = S.trajectory_cohorts() if m else [None] * S.ROUNDS
        if mesh is not None and m:
            rng = np.random.default_rng(0)
            cohorts = [eng.sample_cohort(rng) for _ in range(S.ROUNDS)]
        prm = params
        cstate = eng.init_controller_state(prm, np.full(S.C, 2, np.int32))
        taus = []
        for k in range(S.ROUNDS):
            prm, cstate, _, diag = eng.run_fused(prm, cstate, S.weights(),
                                                 batches=_t(S.data_batches(100 + k)),
                                                 cohort=cohorts[k])
            taus.append(diag["tau_next"].numpy().copy())
        out[name] = dict(taus=np.stack(taus), params=_np(prm),
                         cohorts=None if m is None else np.stack(cohorts),
                         vals={k: v.numpy() for k, v in cstate.vals.items()})
    return out


def device_path(model, ds, params, mesh):
    """The device data path: this process's minibatches for key 7, and a
    round drawn from them (all clients, and the imbalanced cohort)."""
    eng = engine(model, ds, mesh)
    newp, st, _ = eng.run_round(params, S.taus(), S.weights(), S.GPREV, key=7)
    newc, stc, _ = eng.run_round(params, S.taus(), S.weights(), S.GPREV, key=7,
                                 cohort=S.IMBALANCED)
    return dict(sample=_np(eng.shards.sample(7, S.TAU_MAX, S.BATCH)),
                rows=np.array(eng.shards.rows), round=_round_out(newp, st),
                imbalanced=_round_out(newc, stc))


def _rows(log):
    return [dict(round=r["round"], tau=np.asarray(r["tau"]), train_loss=r["train_loss"],
                 cohort=r["cohort"], tau_k=r["tau_k"]) for r in log.rows]


def driver_runs(model, ds, params, mesh):
    """TrainDriver over the engine, sync (overlap 0) and overlapped (2),
    8 of 16 clients a round on the device data path, and with every
    client; then the buffered engine in its parity mode and a real
    buffered run."""
    out = {}
    for name, m, ov in (("overlap0", 8, 0), ("overlap2", 8, 2), ("full", None, 1)):
        log = TrainDriver(engine(model, ds, mesh, cohort=m, controller=True), S.weights(),
                          overlap=ov, seed=0).run(params, 5, np.full(S.C, 2, np.int32))
        out[name] = dict(rows=_rows(log), params=_np(log.params))
    log = BufferedRoundEngine(
        engine(model, ds, mesh, cohort=8, controller=True), S.weights(),
        BufferedConfig(waves=1, grad_decay=1.0, latency=LatencyModel("instant"), seed=0),
    ).run(params, 5, np.full(S.C, 2, np.int32))
    out["buffered_parity"] = dict(rows=_rows_buf(log), params=_np(log.params))
    buf = BufferedRoundEngine(
        engine(model, ds, mesh, cohort=8, controller=True), S.weights(),
        BufferedConfig(waves=2, grad_decay=0.5, latency=LatencyModel("exp", scale=1.0, seed=1),
                       seed=0))
    log = buf.run(params, 5, np.full(S.C, 2, np.int32))
    out["buffered_async"] = dict(rows=_rows_buf(log), params=_np(log.params),
                                 slots=int(buf._buf["loss0"].shape[0]))
    try:
        BufferedRoundEngine(engine(model, ds, mesh, cohort=6, controller=True), S.weights())
        out["indivisible_buffer"] = None
    except ValueError as e:
        out["indivisible_buffer"] = str(e)
    return out


def _rows_buf(log):
    return [dict(round=r["round"], tau=np.asarray(r["tau"]), train_loss=r["train_loss"],
                 cohort=r["cohort"], mean_age=r["mean_age"], max_age=r["max_age"])
            for r in log.rows]


def simulator_run(model, ds, params, mesh):
    """FedSimConfig(mesh=) end to end: 4 rounds of every client, with the
    test set evaluated (rank 0)."""
    cfg = FedSimConfig(mode="fedveca", rounds=4, tau_max=S.TAU_MAX, batch_size=S.BATCH,
                       eta=S.ETA, mesh=mesh)
    log = FederatedSimulator(model, ds, cfg, test_data=ds[0]).run(
        params={k: v.clone() for k, v in params.items()})
    return dict(rows=[dict(r, tau=np.asarray(r["tau"])) for r in log.rows],
                params=_np(log.params))


def wire_runs(model, ds, params, mesh):
    """Fused rounds under each lossy codec, the stratified cohorts of 8 on
    the device data path; the residual rows this process holds after
    them."""
    out = {}
    cohorts = S.trajectory_cohorts(WIRE_ROUNDS)
    for wire in WIRES:
        eng = engine(model, ds, mesh, controller=True, wire=wire)
        prm = params
        cstate = eng.init_controller_state(prm, np.full(S.C, 2, np.int32))
        taus = []
        for k in range(WIRE_ROUNDS):
            prm, cstate, _, diag = eng.run_fused(prm, cstate, S.weights(), key=round_key(0, k),
                                                 cohort=cohorts[k])
            taus.append(diag["tau_next"].numpy().copy())
        res = _np(eng._wire_res)
        eng.reset_wire()
        out[wire] = dict(taus=np.stack(taus), params=_np(prm), residual=res,
                         reset=eng._wire_res is None)
    return out


def run_all(init, mesh, mesh2):
    """Every scenario; ``mesh``/``mesh2`` the (pod 1) and (pod 2) meshes,
    or None for the unsharded port."""
    model = build_model_by_name("svm-mnist", device="cpu")
    ds = S.datasets()
    params = _t(init)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # nothing warns on these balanced draws
        return dict(one=one_rounds(model, ds, params, mesh),
                    traj=trajectories(model, ds, params, mesh2),
                    device=device_path(model, ds, params, mesh),
                    device_pod2=device_path(model, ds, params, mesh2),
                    driver=driver_runs(model, ds, params, mesh),
                    sim=simulator_run(model, ds, params, mesh),
                    wire=wire_runs(model, ds, params, mesh))


def rank_main(init):
    """One rank of the spawned world."""
    mesh = make_federated_mesh(device="cpu")
    mesh2 = make_federated_mesh(pod=2, device="cpu")
    out = run_all(init, mesh, mesh2)
    out.update(rank=mesh.rank, shape=mesh.shape, shape2=mesh2.shape, coords2=mesh2.coords,
               rank_device=str(mesh.device))
    return out


def unsharded(init):
    return run_all(init, None, None)

