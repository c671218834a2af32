"""The sharded-round setting shared by the port's ranks and the JAX
package's reference run (numpy only; imported by
``tests/test_torch_sharded_round.py``, ``tests/_torch_sharded_ranks.py``
and ``tests/_jax_sharded_ref.py``).

tests/test_sharded_round.py's setup: svm-mnist, C 16, tau_max 4, batch
16, tau [4, 2, 3, 1] x 4, eta 0.05, 8 client-axis shards.
"""
import numpy as np

from repro_torch.data import synthetic as syn

C, TAU_MAX, BATCH, ETA, K = 16, 4, 16, 0.05, 8
MODES = ("fedveca", "fednova", "fedavg", "fedprox", "scaffold")
AGGS = ("fallback", "pallas")
MU = 0.01  # fedprox's proximal coefficient
BALANCED = np.array([1, 2, 5, 7, 8, 10, 13, 14], np.int32)  # one client a shard
IMBALANCED = np.arange(8, dtype=np.int32)  # two on each of shards 0-3, none on 4-7
ROUNDS = 6  # the fused trajectory
GPREV = 0.05


def init_params():
    """The round's params (numpy, the SVM's layout), made here so that the
    two packages start from the same bits without waiting on each other."""
    r = np.random.RandomState(3)
    return dict(w=(0.01 * r.randn(784, 1)).astype(np.float32), b=np.zeros(1, np.float32))


def datasets():
    orig = syn.make_classification(C * 40, (784,), 10, seed=0)
    train = syn.binarize_even_odd(orig)
    return [syn.Dataset(train.x[i::C], train.y[i::C]) for i in range(C)]


def weights():
    return np.full(C, 1.0 / C, np.float32)


def taus():
    return np.array([4, 2, 3, 1] * (C // 4), np.int32)


def batches(seed: int = 0):
    """Host batches, leaves [C, tau_max, batch, ...] (numpy)."""
    r = np.random.RandomState(seed)
    return dict(x=r.randn(C, TAU_MAX, BATCH, 784).astype(np.float32),
                y=r.randint(0, 2, (C, TAU_MAX, BATCH)).astype(np.int32))


def data_batches(seed: int):
    """Host batches drawn from the clients' own data (numpy), leaves
    [C, tau_max, batch, ...]: a fused trajectory's round, whose
    controller then sees the statistics of real minibatches."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for d in datasets():
        idx = rng.integers(0, len(d), size=(TAU_MAX, BATCH))
        xs.append(d.x[idx])
        ys.append(d.y[idx])
    return dict(x=np.stack(xs).astype(np.float32), y=np.stack(ys).astype(np.int32))


def trajectory_cohorts(rounds: int = ROUNDS):
    """Stratified cohorts of 8 (one a shard), drawn as a sharded engine's
    ``sample_cohort`` draws them from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    C_loc = C // K
    return [np.concatenate([s * C_loc + np.sort(rng.choice(C_loc, size=1, replace=False))
                            for s in range(K)]).astype(np.int32) for _ in range(rounds)]
