"""The JAX package's sharded round on 8 forced host devices, written to an
npz for ``tests/test_torch_sharded_round.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_jax_sharded_ref.py OUT.npz

The params are ``_sharded_setup.init_params()``. Host batches throughout (the device data path draws with ``jax.random``,
which the port cannot reproduce); the Pallas reduce runs in interpret
mode, as the JAX package's own tests run it on the CPU. Keys:
``round/<mode>/<agg>/*`` one round of every mode and
aggregator; ``cohort/<name>/*`` a balanced and an imbalanced cohort
round; ``traj/<cohort>/*`` 6 fused rounds on a (pod 2, data 4) mesh.
"""
import sys

import jax
import numpy as np

import _sharded_setup as S
from repro.core.controller import ControllerConfig, ControllerCore
from repro.core.engine import EngineConfig, RoundEngine
from repro.launch.mesh import make_federated_mesh
from repro.models.model import build_model_by_name


def _engine(model, mesh, mode="fedveca", agg="fallback", cohort=None, controller=None):
    return RoundEngine(
        model.loss,
        EngineConfig(mode=mode, eta=S.ETA, tau_max=S.TAU_MAX, batch_size=S.BATCH,
                     cohort_size=cohort, aggregator=agg, donate=False, mu=S.MU),
        num_clients=S.C, controller=controller, mesh=mesh)


def _put(out, prefix, params, stats=None, scaffold=None):
    for k, v in params.items():
        out[f"{prefix}/params/{k}"] = np.asarray(v)
    if stats is not None:
        for name in ("loss0", "beta", "delta", "g0_sqnorm", "tau_k"):
            out[f"{prefix}/{name}"] = np.asarray(getattr(stats, name))
        for k, v in stats.global_grad.items():
            out[f"{prefix}/global_grad/{k}"] = np.asarray(v)
    if scaffold is not None:
        for k, v in scaffold.c.items():
            out[f"{prefix}/c/{k}"] = np.asarray(v)
        for k, v in scaffold.c_i.items():
            out[f"{prefix}/c_i/{k}"] = np.asarray(v)


def main(path):
    assert len(jax.devices()) >= S.K, jax.devices()
    model = build_model_by_name("svm-mnist")
    mesh = make_federated_mesh(S.K)
    params = S.init_params()
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        np.shape, model.init(jax.random.PRNGKey(0)))
    out = {}
    p, tau, b = S.weights(), S.taus(), S.batches()
    for mode in S.MODES:
        for agg in S.AGGS:
            newp, st, scaf = _engine(model, mesh, mode, agg).run_round(
                params, tau, p, S.GPREV, batches=b)
            _put(out, f"round/{mode}/{agg}", newp, st, scaf)
    for name, cohort in (("balanced", S.BALANCED), ("imbalanced", S.IMBALANCED)):
        newp, st, _ = _engine(model, mesh).run_round(params, tau, p, S.GPREV, batches=b,
                                                     cohort=cohort)
        _put(out, f"cohort/{name}", newp, st)
    mesh2 = make_federated_mesh(S.K, pod=2)
    for cname, cohort in (("all", None), ("eight", 8)):
        ctl = ControllerCore(ControllerConfig(eta=S.ETA, tau_max=S.TAU_MAX), S.C, mesh=mesh2)
        eng = _engine(model, mesh2, cohort=cohort, controller=ctl)
        cohorts = S.trajectory_cohorts() if cohort else [None] * S.ROUNDS
        prm = params
        cstate = eng.init_controller_state(prm, np.full(S.C, 2, np.int32))
        taus = []
        for k in range(S.ROUNDS):
            prm, cstate, _, diag = eng.run_fused(prm, cstate, p, batches=S.data_batches(100 + k),
                                                 cohort=cohorts[k])
            taus.append(np.asarray(diag["tau_next"]))
        out[f"traj/{cname}/taus"] = np.stack(taus)
        _put(out, f"traj/{cname}", prm)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
