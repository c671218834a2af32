"""FedVeca vs FedAvg/FedNova on Non-IID data (the port's counterpart of
``examples/quickstart.py``, with the same flags plus ``--device`` and
``--model``).

    python -m repro_torch.fed [--rounds 30] [--case 3]
    python -m repro_torch.fed --device cpu --rounds 3
    python -m repro_torch.fed --model cnn-cifar10 --tau-max 50 --eta 0.01

    python -m repro_torch.fed --mesh data=4 --clients 8 --device cpu

Runs on the card by default and raises without one; the round runs in
full float32 (``repro_torch.strict_fp32``: no TF32 convolutions).
``--mesh data=K[,pod=J]`` shards each run's clients over K*J ranks
(``--backend gloo``: every rank on ``--device``, so K ranks may share one
card; ``nccl``: a card a rank), started here or by ``python -m
torch.distributed.run``; rank 0 prints, and runs the centralized
baseline. The SVM
is trained on the even/odd labels of MNIST-shaped synthetic data; the
CNNs on the 10-class synthetic data of their input shape (no downloads).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.partition import partition_by_label, partition_case3, partition_iid
from repro_torch.launch.mesh import launch, make_federated_mesh
from repro_torch.data.synthetic import Dataset, binarize_even_odd, make_classification
from repro_torch.fed.simulator import (FederatedSimulator, FedSimConfig, centralized_sgd,
                                       fair_fixed_tau)
from repro_torch.models.model import build_model_by_name


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fed")
    ap.add_argument("--model", default="svm-mnist",
                    choices=("svm-mnist", "cnn-mnist", "cnn-cifar10"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--case", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--tau-max", type=int, default=20)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--cohort", type=int, default=None,
                    help="participating clients per round (default: all)")
    ap.add_argument("--aggregator", default="auto", choices=("auto", "pallas", "fallback"),
                    help="server reduce: the vecavg kernel (auto, pallas) or the "
                    "plain per-leaf tree path (fallback)")
    ap.add_argument("--data-path", default="device", choices=("device", "host"),
                    help="device-resident shards vs numpy host-built batches")
    ap.add_argument("--overlap", type=int, default=1,
                    help="rounds in flight before host sync (0 = sync mode)")
    ap.add_argument("--mesh", default=None, metavar="data=K[,pod=J]",
                    help="shard the clients over K*J ranks (the client axis)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of the ranks under --mesh")
    args = ap.parse_args(argv)
    args.pod, args.data = 1, 1
    if args.mesh:
        try:
            spec = dict(kv.split("=") for kv in args.mesh.split(","))
            args.pod, args.data = int(spec.get("pod", 1)), int(spec["data"])
        except (KeyError, ValueError):
            ap.error(f"--mesh {args.mesh!r}: expected data=K or pod=J,data=K")
    # the ranks find ``run`` by its module's name, not as ``__main__``'s
    from repro_torch.fed import __main__ as cli

    launch(cli.run, args.pod * args.data, args.backend, args)


def run(args) -> None:
    """The comparison on this rank (the whole of it without --mesh)."""
    mesh = (make_federated_mesh(args.pod * args.data, pod=args.pod, device=args.device)
            if args.mesh else None)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    model = build_model_by_name(args.model,
                                device=args.device if mesh is None else mesh.device)
    shape = model.config.input_shape
    say(f"== FedVeca ({model.device}{'' if mesh is None else f', mesh {mesh.shape}'}): "
        f"{args.model} / Case {args.case} / {args.clients} clients ==")
    orig = make_classification(4000, shape, 10, seed=0)
    test = make_classification(1000, shape, 10, seed=1)
    train = orig
    if args.model == "svm-mnist":
        train, test = binarize_even_odd(orig), binarize_even_odd(test)
    parts = {1: lambda: partition_iid(len(train.y), args.clients),
             2: lambda: partition_by_label(orig.y, args.clients),
             3: lambda: partition_case3(orig.y, args.clients)}[args.case]()
    clients = [Dataset(train.x[s], train.y[s]) for s in parts]
    say("client sizes:", [len(c) for c in clients])

    common = dict(rounds=args.rounds, tau_max=args.tau_max, batch_size=16, eta=args.eta,
                  cohort_size=args.cohort, aggregator=args.aggregator,
                  data_path=args.data_path, overlap=args.overlap, mesh=mesh)
    t0 = time.perf_counter()
    veca = FederatedSimulator(model, clients, FedSimConfig(mode="fedveca", **common),
                              test).run()
    veca_s = time.perf_counter() - t0
    sizes = np.array([len(c) for c in clients], float)
    ft = np.minimum(fair_fixed_tau(veca.tau_all, args.rounds, 16, sizes), args.tau_max)
    baselines = {mode: FederatedSimulator(model, clients,
                                          FedSimConfig(mode=mode, fixed_tau=ft, **common),
                                          test).run()
                 for mode in ("fedavg", "fednova")}  # every rank: the rounds are sharded
    if not lead:
        return
    print("\nround  loss    acc    tau (adaptive)            eta*tau_k*L")
    for r in veca.rows[:: max(1, args.rounds // 10)]:
        prem = r.get("premise")
        print(f"{r['round']:5d}  {r['test_loss']:.4f}  {r.get('test_acc', 0):.3f}  "
              f"{str(r['tau']):24s}  {prem if prem is None else f'{prem:.2f}'}")
    print(f"fedveca: {1e3 * veca_s / args.rounds:.1f} ms a round (evaluation included)")

    results = {"fedveca": veca.rows[-1], **{m: log.rows[-1] for m, log in baselines.items()}}
    pooled = Dataset(np.concatenate([c.x for c in clients]),
                     np.concatenate([c.y for c in clients]))
    _, cent = centralized_sgd(model, pooled, veca.tau_all, 16, args.eta, test)

    print(f"\n== final (rounds={args.rounds}, total local iters={veca.tau_all}) ==")
    for name, row in results.items():
        print(f"{name:12s} loss={row['test_loss']:.4f} acc={row.get('test_acc', 0):.3f}")
    print(f"{'centralized':12s} loss={cent['test_loss']:.4f} acc={cent.get('test_acc', 0):.3f}")


if __name__ == "__main__":
    main()
