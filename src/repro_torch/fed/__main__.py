"""FedVeca vs FedAvg/FedNova on Non-IID data (the port's counterpart of
``examples/quickstart.py``, with the same flags plus ``--device`` and
``--model``).

    python -m repro_torch.fed [--rounds 30] [--case 3]
    python -m repro_torch.fed --device cpu --rounds 3
    python -m repro_torch.fed --model cnn-cifar10 --tau-max 50 --eta 0.01

Runs on the card by default and raises without one; the round runs in
full float32 (``repro_torch.strict_fp32``: no TF32 convolutions). The SVM
is trained on the even/odd labels of MNIST-shaped synthetic data; the
CNNs on the 10-class synthetic data of their input shape (no downloads).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.partition import partition_by_label, partition_case3, partition_iid
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
    args = ap.parse_args(argv)

    model = build_model_by_name(args.model, device=args.device)
    shape = model.config.input_shape
    print(f"== FedVeca ({model.device}): {args.model} / Case {args.case} / "
          f"{args.clients} clients ==")
    orig = make_classification(4000, shape, 10, seed=0)
    test = make_classification(1000, shape, 10, seed=1)
    train = orig
    if args.model == "svm-mnist":
        train, test = binarize_even_odd(orig), binarize_even_odd(test)
    parts = {1: lambda: partition_iid(len(train.y), args.clients),
             2: lambda: partition_by_label(orig.y, args.clients),
             3: lambda: partition_case3(orig.y, args.clients)}[args.case]()
    clients = [Dataset(train.x[s], train.y[s]) for s in parts]
    print("client sizes:", [len(c) for c in clients])

    common = dict(rounds=args.rounds, tau_max=args.tau_max, batch_size=16, eta=args.eta,
                  cohort_size=args.cohort, aggregator=args.aggregator,
                  data_path=args.data_path, overlap=args.overlap)
    t0 = time.perf_counter()
    veca = FederatedSimulator(model, clients, FedSimConfig(mode="fedveca", **common),
                              test).run()
    veca_s = time.perf_counter() - t0
    print("\nround  loss    acc    tau (adaptive)            eta*tau_k*L")
    for r in veca.rows[:: max(1, args.rounds // 10)]:
        prem = r.get("premise")
        print(f"{r['round']:5d}  {r['test_loss']:.4f}  {r.get('test_acc', 0):.3f}  "
              f"{str(r['tau']):24s}  {prem if prem is None else f'{prem:.2f}'}")
    print(f"fedveca: {1e3 * veca_s / args.rounds:.1f} ms a round (evaluation included)")

    sizes = np.array([len(c) for c in clients], float)
    ft = np.minimum(fair_fixed_tau(veca.tau_all, args.rounds, 16, sizes), args.tau_max)
    results = {"fedveca": veca.rows[-1]}
    for mode in ("fedavg", "fednova"):
        bcfg = FedSimConfig(mode=mode, fixed_tau=ft, **common)
        results[mode] = FederatedSimulator(model, clients, bcfg, test).run().rows[-1]
    pooled = Dataset(np.concatenate([c.x for c in clients]),
                     np.concatenate([c.y for c in clients]))
    _, cent = centralized_sgd(model, pooled, veca.tau_all, 16, args.eta, test)

    print(f"\n== final (rounds={args.rounds}, total local iters={veca.tau_all}) ==")
    for name, row in results.items():
        print(f"{name:12s} loss={row['test_loss']:.4f} acc={row.get('test_acc', 0):.3f}")
    print(f"{'centralized':12s} loss={cent['test_loss']:.4f} acc={cent.get('test_acc', 0):.3f}")


if __name__ == "__main__":
    main()
