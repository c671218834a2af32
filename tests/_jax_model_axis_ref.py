"""The JAX package's step bundles on a (data 4, model 2) mesh of 8 forced
host devices, written to an npz for ``tests/test_torch_model_axis.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_jax_model_axis_ref.py OUT.npz

Keys: ``round/params/<k>`` and ``round/<stat>`` (the round bundle of
``_model_axis_setup.ROUND`` from its numpy params and host batches),
``sgd/params/<k>`` and ``sgd/loss`` (the SGD bundle), and
``inputs/<arch>/<bundle>`` (each bundle's ``make_inputs`` as a string of
shapes and dtypes in call order, for the two reduced configs).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _model_axis_setup as S
from repro.configs.base import ShapeConfig
from repro.models.model import build_model_by_name
from repro.train.steps import build_bundle
from repro_torch.bridge import unflatten

BUNDLES = dict(round=("train", {}), sgd=("train", dict(plain_sgd=True)), prefill=("prefill", {}),
               decode=("decode", {}), slots=("decode", dict(slot_masked=True)),
               paged=("decode", dict(paged=True, cache_update="kernel")),
               chunk=("prefill", dict(paged=True)))


def describe(ins) -> str:
    leaves = jax.tree.leaves(ins, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return ";".join(f"{tuple(l.shape)}:{jnp.dtype(l.dtype).name}" for l in leaves)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def main(path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(S.DATA, S.MODEL), ("data", "model"))
    out = {}
    model = build_model_by_name(S.ROUND["arch"], reduced=True)
    shape = ShapeConfig("t", S.ROUND["seq"], S.ROUND["batch"], "train")
    b = build_bundle(model, mesh, shape, tau_max=S.ROUND["tau_max"], eta=S.ROUND["eta"])
    batches, tau, p, g = S.round_inputs()
    params = jax.tree.map(jnp.asarray, unflatten(S.init_params(S.ROUND["arch"], 0)))
    new_p, stats = b.fn(params, jax.tree.map(jnp.asarray, batches), jnp.asarray(tau),
                        jnp.asarray(p), jnp.asarray(g))
    for k, v in _flat(new_p).items():
        out[f"round/params/{k}"] = v
    for name in S.STATS + ("tau_k",):
        out[f"round/{name}"] = np.asarray(getattr(stats, name))

    model = build_model_by_name(S.SGD["arch"], reduced=True)
    shape = ShapeConfig("t", S.SGD["seq"], S.SGD["batch"], "train")
    b = build_bundle(model, mesh, shape, plain_sgd=True, eta=S.SGD["eta"])
    params = jax.tree.map(jnp.asarray, unflatten(S.init_params(S.SGD["arch"], 0)))
    new_p, loss = b.fn(params, jax.tree.map(jnp.asarray, S.sgd_batch()))
    for k, v in _flat(new_p).items():
        out[f"sgd/params/{k}"] = v
    out["sgd/loss"] = np.asarray(loss)

    for arch in (S.ROUND["arch"], S.SGD["arch"]):
        model = build_model_by_name(arch, reduced=True)
        for name, (kind, kw) in BUNDLES.items():
            shape = ShapeConfig("s", 32, 8, kind)
            out[f"inputs/{arch}/{name}"] = np.array(
                describe(build_bundle(model, mesh, shape, tau_max=2, **kw).make_inputs()))
    np.savez(path, **out)


if __name__ == "__main__":
    assert len(jax.devices()) >= 8, jax.devices()
    main(sys.argv[1])
