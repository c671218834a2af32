"""Training launcher (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch starcoder2-3b --reduced \\
        --rounds 3 --seq 64 --batch-per-client 2

Runs FedVeca rounds of the selected architecture (parameters from the
port's own ``init(seed)``) through ``core/driver.TrainDriver``: the
controller fused into the round, round k+1 dispatched while round k's
diagnostics are still in flight (``--overlap``; 0 = sync). Data:
synthetic Non-IID topic streams (one topic a client) held on the device
and sampled there (``--host-data``: host-built batches each round).
``--cohort m`` samples m participating clients a round; ``--buffered``
hands the run to ``core/buffered.BufferedRoundEngine``.

``--mesh data=K[,pod=J]`` shards the round over the client axis (DESIGN.md
§11): K*J ranks, each holding ``--clients-per-shard`` clients, reduce
their clients through the vecavg kernel and complete the reduce with one
all-reduce. Started alone, the launcher spawns the ranks itself; started
by ``python -m torch.distributed.run --nproc-per-node N``, it joins the
ranks that started it. ``--backend gloo`` (the default) puts every rank on
``--device`` (K ranks may share one card); ``--backend nccl`` needs a card
a rank. The run is on the card unless ``--device cpu`` is given.

``--data-axis D --model-axis M`` (M > 1) runs on D*M ranks, spawned or
joined as under ``--mesh``: C = D clients (one a client shard, as the JAX
launcher takes C = the data extent), each rank holding its model-axis
pieces of the parameters (``sharding/partition.py``; every family, with
``--wire`` and ``--buffered`` too). ``--production-mesh`` builds the (data 16, model 16) mesh,
which needs 256 ranks (started by ``torch.distributed.run``): a smaller
world raises with the start hint. ``--sanitize`` runs the driver (or the
buffered engine) inside ``analysis.sanitize.Sanitizer``: round 0 the
warm-up, then no library build and no new allocator segment.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="fedveca")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tau-max", type=int, default=2)
    ap.add_argument("--eta", type=float, default=0.01)
    ap.add_argument("--alpha", type=float, default=0.95)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--cohort", type=int, default=None,
                    help="participating clients per round (default: all)")
    ap.add_argument("--aggregator", default="auto", choices=("auto", "pallas", "fallback"))
    ap.add_argument("--wire", default="none", metavar="none|int8|topk:K",
                    help="client->server update codec with error feedback (core/wire.py)")
    ap.add_argument("--host-data", action="store_true",
                    help="build batches on the host and upload them each round")
    ap.add_argument("--overlap", type=int, default=1,
                    help="rounds in flight before host sync (0 = sync mode)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (data 16, model 16) pod mesh: 256 ranks")
    ap.add_argument("--mesh", default=None, metavar="data=K[,pod=J]",
                    help="client-axis sharding over K*J ranks (DESIGN.md §11)")
    ap.add_argument("--clients-per-shard", type=int, default=2,
                    help="clients per client-axis shard under --mesh")
    ap.add_argument("--data-axis", type=int, default=2,
                    help="clients (one a client shard); with --model-axis M > 1, D*M ranks")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks that partition each client's parameters")
    ap.add_argument("--buffered", action="store_true",
                    help="buffered asynchronous rounds (core/buffered.py)")
    ap.add_argument("--buffer-waves", type=int, default=2)
    ap.add_argument("--grad-decay", type=float, default=0.9)
    ap.add_argument("--latency", default="exp", choices=("instant", "uniform", "exp", "hetero"))
    ap.add_argument("--latency-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed: init, per-client data topics, round keys")
    ap.add_argument("--sanitize", action="store_true",
                    help="run under the sanitizer lane (analysis/sanitize.py): NaN "
                         "trapped, no build or new allocator segment after round 0")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of the ranks under --mesh")
    ap.add_argument("--device", default=None,
                    help="each rank's device under gloo, and the run's without --mesh "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh and args.model_axis > 1:
        ap.error("--mesh shards the client axis alone; a model axis is "
                 "--data-axis D --model-axis M")
    if args.buffered and args.host_data:
        ap.error("--buffered needs the device data path (drop --host-data)")
    args.pod, args.data = 1, None
    if args.mesh:
        try:
            spec = dict(kv.split("=") for kv in args.mesh.split(","))
            args.pod, args.data = int(spec.get("pod", 1)), int(spec["data"])
        except (KeyError, ValueError):
            ap.error(f"--mesh {args.mesh!r}: expected data=K or pod=J,data=K")
    return args


def run(args: argparse.Namespace) -> list:
    """One rank's run (the whole run without --mesh). -> the rows (rank
    0's; none on the other ranks)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.controller import ControllerConfig, ControllerCore
    from repro_torch.core.driver import TrainDriver
    from repro_torch.core.engine import EngineConfig, RoundEngine
    from repro_torch.data.device import DeviceShards, host_stacked_batches
    from repro_torch.data.synthetic import make_lm_tokens
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.vecavg import ops as va_ops
    from repro_torch.launch.mesh import (make_federated_mesh, make_host_mesh,
                                         make_production_mesh, num_clients)
    from repro_torch.metrics.logger import format_bytes
    from repro_torch.models.model import build_model

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    fed_mesh = None
    if args.mesh:
        mesh = fed_mesh = make_federated_mesh(args.pod * args.data, pod=args.pod,
                                              device=args.device)
        C = num_clients(mesh) * args.clients_per_shard
    elif args.production_mesh:
        mesh = fed_mesh = make_production_mesh(device=args.device)
        C = num_clients(mesh)
    else:
        mesh = make_host_mesh(args.data_axis, args.model_axis, device=args.device)
        fed_mesh = mesh if mesh.model_size > 1 else None
        C = num_clients(mesh)
    lead = mesh.rank == 0
    model = build_model(cfg, device=mesh.device, mesh=fed_mesh)
    if lead:
        print(f"arch={cfg.name} mesh={mesh.shape} clients={C} "
              f"global_batch={C * args.batch_per_client} seq={args.seq} "
              f"sharded={fed_mesh is not None and mesh.size > 1} device={mesh.device} "
              f"data={'host' if args.host_data else 'device'} cohort={args.cohort or C} "
              f"overlap={args.overlap} wire={args.wire}", flush=True)

    datasets = [make_lm_tokens(64, args.seq, cfg.vocab_size, topic=i, seed=args.seed)
                for i in range(C)]
    engine = RoundEngine(
        model.loss,
        EngineConfig(mode=args.mode, eta=args.eta, tau_max=args.tau_max,
                     batch_size=args.batch_per_client, cohort_size=args.cohort,
                     aggregator=args.aggregator, wire=args.wire),
        shards=(None if args.host_data
                else DeviceShards.from_datasets(datasets, device=mesh.device, mesh=fed_mesh)),
        num_clients=C,
        controller=ControllerCore(
            ControllerConfig(eta=args.eta, alpha=args.alpha, tau_max=args.tau_max), C,
            adapt=(args.mode == "fedveca"), mesh=fed_mesh, model_axis=model.model_axis),
        mesh=fed_mesh,
        model_axis=model.model_axis,
    )
    params = model.init(args.seed)
    taus = np.full(C, 2, np.int32)
    p = np.full((C,), 1.0 / C, np.float32)
    t_last = [time.time()]

    def on_row(row):
        now = time.time()
        wire = ""
        if row.get("wire", "identity") != "identity":
            wire = f" wire[{row['wire']}]={format_bytes(row['wire_bytes'])}/round"
        print(f"round {row['round']}: loss={row['train_loss']:.4f} tau_k={row['tau_k']:.2f} "
              f"tau_next={np.asarray(row['tau']).tolist()} ({now - t_last[0]:.1f}s){wire}",
              flush=True)
        t_last[0] = now

    va_ops.reset_launches()
    rn_ops.reset_launches()
    if args.buffered:
        from repro_torch.core.buffered import BufferedConfig, BufferedRoundEngine, LatencyModel

        runner = BufferedRoundEngine(
            engine, p,
            BufferedConfig(waves=args.buffer_waves, grad_decay=args.grad_decay,
                           latency=LatencyModel(args.latency, scale=args.latency_scale),
                           seed=args.seed, overlap=max(args.overlap, 1)),
            mode=args.mode, on_row=on_row, sanitize=args.sanitize)
        log = runner.run(params, args.rounds, taus)
        summary = (f"sim_time {runner.sim_time:.1f} ticks over {args.rounds} buffered steps "
                   f"({runner.wave_dispatches} waves, {runner.fold_dispatches} folds)")
    else:
        runner = TrainDriver(
            engine, p, overlap=args.overlap, seed=args.seed, mode=args.mode,
            batches_fn=((lambda rng: host_stacked_batches(datasets, rng, args.tau_max,
                                                          args.batch_per_client,
                                                          device=mesh.device))
                        if args.host_data else None),
            on_row=on_row, sanitize=args.sanitize)
        log = runner.run(params, args.rounds, taus)
        summary = f"{args.rounds} rounds"
    launches = dict(va_ops.launches, **rn_ops.launches)
    # one write, so that the ranks' lines do not interleave
    sys.stdout.write(f"rank {mesh.rank}: done. host-blocked {runner.host_blocked_s:.2f}s over "
                     f"{summary}; vecavg {launches['vecavg']} launches, rmsnorm "
                     f"{launches['rmsnorm']} (this rank)\n")
    sys.stdout.flush()
    return log.rows


def main(argv=None) -> list:
    """Parse, start or join the ranks (``launch.mesh.launch``), run;
    returns rank 0's rows (this rank's under ``torch.distributed.run``)."""
    from repro_torch.launch.mesh import launch

    args = parse_args(argv)
    if args.production_mesh:
        # 256 ranks are started by torch.distributed.run, never spawned here:
        # in a smaller world the mesh raises with the start hint
        world = int(os.environ.get("WORLD_SIZE", 1))
    elif args.mesh:
        world = args.pod * args.data
    else:
        world = args.data_axis * args.model_axis if args.model_axis > 1 else 1
    return launch(run, world, args.backend, args)


if __name__ == "__main__":
    main()
