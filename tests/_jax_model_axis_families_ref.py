"""The JAX package's round bundles of reduced Hymba-1.5B and xLSTM-1.3B on
a (data 4, model 2) mesh of 8 forced host devices, written to an npz for
``tests/test_torch_model_axis_families.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_jax_model_axis_families_ref.py OUT.npz

Keys: ``<arch>/params/<k>`` and ``<arch>/<stat>`` (the round bundle at
``_model_axis_setup.ROUND``'s sizes from the numpy params of
``init_params(arch, 0)`` and ``round_inputs(arch)``).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import _model_axis_setup as S
from _jax_model_axis_ref import _flat
from repro.configs.base import ShapeConfig
from repro.models.model import build_model_by_name
from repro.train.steps import build_bundle
from repro_torch.bridge import unflatten


def main(path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(S.DATA, S.MODEL), ("data", "model"))
    out = {}
    for arch in S.FAMILY_ROUNDS:
        model = build_model_by_name(arch, reduced=True)
        shape = ShapeConfig("t", S.ROUND["seq"], S.ROUND["batch"], "train")
        b = build_bundle(model, mesh, shape, tau_max=S.ROUND["tau_max"], eta=S.ROUND["eta"])
        batches, tau, p, g = S.round_inputs(arch)
        params = jax.tree.map(jnp.asarray, unflatten(S.init_params(arch, 0)))
        new_p, stats = b.fn(params, jax.tree.map(jnp.asarray, batches), jnp.asarray(tau),
                            jnp.asarray(p), jnp.asarray(g))
        for k, v in _flat(new_p).items():
            out[f"{arch}/params/{k}"] = v
        for name in S.STATS + ("tau_k",):
            out[f"{arch}/{name}"] = np.asarray(getattr(stats, name))
    np.savez(path, **out)


if __name__ == "__main__":
    assert len(jax.devices()) >= 8, jax.devices()
    main(sys.argv[1])
