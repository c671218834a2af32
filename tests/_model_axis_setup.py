"""The model-axis setting shared by the port's ranks and the JAX package's
reference run (imported by ``tests/test_torch_model_axis.py``,
``tests/_torch_model_axis_ranks.py`` and ``tests/_jax_model_axis_ref.py``).

tests/test_sharding.py's round: reduced granite-moe-1b-a400m on a (data 4,
model 2) mesh, C 4, tau_max 2, eta 0.01, seq 32, global batch 16; and an
SGD step of reduced Qwen1.5-32B (dense, untied vocab-parallel head) on the
same mesh. Both packages start from the numpy params made here, so the
two runs overlap in time.
"""
import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models.model import build_model, params_struct

DATA, MODEL = 4, 2
ROUND = dict(arch="granite-moe-1b-a400m", seq=32, batch=16, tau_max=2, eta=0.01)
TAUS = np.array([2, 2, 1, 2], np.int32)
GPREV = 0.05
SGD = dict(arch="qwen1.5-32b", seq=16, batch=8, eta=0.01)
STATS = ("loss0", "beta", "delta", "g0_sqnorm")
# the hybrid and xLSTM families' round bundles (tests/test_torch_model_axis_families.py)
FAMILY_ROUNDS = ("hymba-1.5b", "xlstm-1.3b")


def init_params(arch: str, seed: int):
    """Flat numpy params of the reduced ``arch`` (the port's keys and
    shapes): weights N(0, 1/fan_in), embeddings N(0, 0.02^2), norm scales
    and biases N(0, 0.1^2) so that they matter."""
    cfg = get_arch(arch).reduced()
    r = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(params_struct(build_model(cfg, device="meta")).items()):
        name = k.split("/")[-1]
        shape = tuple(v.shape)
        if name in ("scale", "bias") or name.startswith("b_"):
            a = 0.1 * r.randn(*shape)
        elif name in ("embed", "pos_embed", "router"):
            a = 0.02 * r.randn(*shape)
        else:
            a = r.randn(*shape) / np.sqrt(shape[-2])
        out[k] = a.astype(np.float32)
    return out


def round_inputs(arch=None):
    """Host batches [C, tau_max, b, S], taus, weights, ||grad F(w_{k-1})||^2
    (of ``ROUND``'s arch, or of ``arch`` at ``ROUND``'s sizes)."""
    vocab = get_arch(arch or ROUND["arch"]).reduced().vocab_size
    C, b = DATA, ROUND["batch"] // DATA
    r = np.random.RandomState(1)
    shp = (C, ROUND["tau_max"], b, ROUND["seq"])
    batches = dict(tokens=r.randint(0, vocab, shp).astype(np.int32),
                   targets=r.randint(0, vocab, shp).astype(np.int32))
    return batches, TAUS, np.full(C, 1.0 / C, np.float32), np.float32(GPREV)


def sgd_batch():
    vocab = get_arch(SGD["arch"]).reduced().vocab_size
    r = np.random.RandomState(2)
    shp = (SGD["batch"], SGD["seq"])
    return dict(tokens=r.randint(0, vocab, shp).astype(np.int32),
                targets=r.randint(0, vocab, shp).astype(np.int32))
