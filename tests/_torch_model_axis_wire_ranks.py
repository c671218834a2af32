"""The port's side of ``tests/test_torch_model_axis_wire.py``: the wire
codecs, a wire round and buffered commits under a model axis on each rank
of a spawned gloo world of 4 ranks, mesh (data 2, model 2), and the same
runs unsharded in the test process. Torch only; results are numpy.

  * ``codecs``: int8 and top-k (k inside a piece, between a piece's size
    and the leaf's, and past the leaf's) over ``LEAVES``, leaves cut on
    their first, last and a middle dim and one whose cut dim holds two
    halves, with equal magnitudes across a shard boundary: the rank's
    decoded pieces of every client row, from the whole rows made here;
  * ``wire/<codec>``: one teacher-forced ``RoundEngine.run_round`` of
    reduced Hymba-1.5B (C 2, host batches) from the seed's params with
    zero residual rows: the new params and residual rows, gathered;
  * ``buffered``: 2 buffered commits (2 waves in flight, exponential
    latency, decay 0.9) of the same model and clients: the params
    gathered, the commits' rows;
  * ``diverged``: a buffered run whose model ranks seed their latencies
    differently: the error its first dispatch raises.
"""
import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel
from repro_torch.core.controller import ControllerConfig, ControllerCore
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.wire import make_codec
from repro_torch.data.device import DeviceShards
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import api, partition

DATA, MODEL = 2, 2
ARCH = "hymba-1.5b"
C, SEQ, BATCH, TAU_MAX, ETA = 2, 16, 2, 2, 0.01
TAUS = np.array([2, 1], np.int32)
# (path, shape, cut dim, halves): first, last, a middle dim, two halves
LEAVES = (("a/w", (8, 6), 0, 1), ("b/w", (5, 12), 1, 1), ("c/w", (3, 8, 5), 1, 1),
          ("ssm/w_in", (4, 16), 1, 2))
CODECS = ("int8", "topk:3", "topk:30", "topk:200")
WIRES = ("int8", "topk:40")
ROWS = 3
TIE = 8.0  # above every N(0, 1) draw here


def codec_rows():
    """Whole client rows [ROWS, ...] of every ``LEAVES`` leaf, from a seed,
    with equal magnitudes on both sides of each shard boundary: the row's
    largest |x| (int8's scale) and a tie at top-k's cut."""
    r = np.random.RandomState(11)
    out = {}
    for path, shape, dim, halves in LEAVES:
        x = r.randn(ROWS, *shape).astype(np.float32)
        n = shape[dim] // (halves * MODEL)
        lo = [slice(None)] * (len(shape) + 1)
        hi = list(lo)
        lo[dim + 1], hi[dim + 1] = n - 1, n  # the last entry of piece 0, the first of piece 1
        x[tuple(lo)] = TIE
        x[tuple(hi)] = -TIE
        out[path] = x
    return out


def _axis(mesh):
    cuts = {p: partition.Cut(d - len(s), h, s) for p, s, d, h in LEAVES}
    return partition.ModelAxis(mesh.model_group, cuts, mesh.model_size, mesh.coords["model"])


def codecs(mesh):
    axis = _axis(mesh)
    whole = {k: torch.from_numpy(v) for k, v in codec_rows().items()}
    pieces = {p: partition.piece(whole[p], d + 1, h, axis.rank, axis.size).contiguous()
              for p, _, d, h in LEAVES}
    out = {}
    for spec in CODECS:
        api.reset_collectives()
        dec = make_codec(spec).roundtrip_pieces(pieces, axis)
        out[spec] = dict(decoded={k: v.numpy() for k, v in dec.items()},
                         collectives=dict(api.collectives))
    return out


def lm_clients(cfg):
    return [make_lm_tokens(16, SEQ, cfg.vocab_size, topic=i, seed=0) for i in range(C)]


def _engine(model, mesh, wire, cohort=None):
    return RoundEngine(
        model.loss,
        EngineConfig(eta=ETA, tau_max=TAU_MAX, batch_size=BATCH, cohort_size=cohort, wire=wire),
        shards=DeviceShards.from_datasets(lm_clients(model.config), device="cpu", mesh=mesh),
        num_clients=C,
        controller=ControllerCore(ControllerConfig(eta=ETA, tau_max=TAU_MAX), C, mesh=mesh,
                                  model_axis=model.model_axis),
        mesh=mesh, model_axis=model.model_axis)


def round_batches(cfg):
    r = np.random.RandomState(5)
    shp = (C, TAU_MAX, BATCH, SEQ)
    return dict(tokens=torch.from_numpy(r.randint(0, cfg.vocab_size, shp).astype(np.int32)),
                targets=torch.from_numpy(r.randint(0, cfg.vocab_size, shp).astype(np.int32)))


def _gathered(mesh, cfg, tree, lead=0):
    if mesh is None:
        return {k: v.numpy() for k, v in tree.items()}
    return {k: v.numpy() for k, v in
            partition.gather_params(tree, mesh, cfg, lead=lead).items()}


def _rows_all(mesh, tree):
    """[C, ...] rows of every client from the ranks' [C/K, ...] rows."""
    if mesh is None:
        return tree
    return {k: api.all_gather(v, mesh.group) for k, v in tree.items()}


def wire(mesh, spec):
    """One teacher-forced round under ``spec``: (params, residual rows)."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu", mesh=mesh)
    eng = _engine(model, mesh, spec)
    params = model.init(0)
    api.reset_collectives()
    new, _, _ = eng.run_round(params, TAUS, np.full(C, 1.0 / C, np.float32), 0.05,
                              batches=round_batches(cfg))
    coll = dict(api.collectives)
    return dict(params=_gathered(mesh, cfg, new),
                residual=_gathered(mesh, cfg, _rows_all(mesh, eng._wire_res), lead=1),
                bytes_per_client=eng.wire_bytes_per_client(params), collectives=coll)


def buffered(mesh):
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu", mesh=mesh)
    eng = _engine(model, mesh, "none")
    runner = BufferedRoundEngine(
        eng, np.full(C, 1.0 / C, np.float32),
        BufferedConfig(waves=2, grad_decay=0.9, latency=LatencyModel("exp", seed=0), seed=0))
    api.reset_collectives()
    log = runner.run(model.init(0), 2, TAUS)
    coll = dict(api.collectives)
    rows = [{k: np.asarray(r[k]) for k in ("train_loss", "tau", "tau_k", "mean_age",
                                           "max_age", "sim_time")} for r in log.rows]
    return dict(params=_gathered(mesh, cfg, log.params), rows=rows, collectives=coll,
                waves=runner.wave_dispatches)


def diverged(mesh):
    """A buffered run whose model ranks draw latencies from different seeds:
    the first dispatch's check must refuse it on every rank. -> the error."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu", mesh=mesh)
    runner = BufferedRoundEngine(
        _engine(model, mesh, "none"), np.full(C, 1.0 / C, np.float32),
        BufferedConfig(latency=LatencyModel("exp", seed=mesh.coords["model"]), seed=0))
    try:
        runner.run(model.init(0), 1, TAUS)
    except RuntimeError as e:
        return str(e)
    return None


def rank_main():
    mesh = make_host_mesh(DATA, MODEL, device="cpu")
    return dict(rank=mesh.rank, coords=mesh.coords, codecs=codecs(mesh),
                wire={s: wire(mesh, s) for s in WIRES}, buffered=buffered(mesh),
                diverged=diverged(mesh))


def unsharded():
    return dict(wire={s: wire(None, s) for s in WIRES}, buffered=buffered(None))
