"""Federated training of a decoder LM with FedVeca on Non-IID synthetic
token data, with checkpoints and metrics (the port's counterpart of
``examples/train_lm_federated.py``, with the same flags plus ``--device``).

    python -m repro_torch.fed.train_lm --preset 100m --rounds 200 --ckpt-dir ckpt
    python -m repro_torch.fed.train_lm --device cpu --preset tiny --rounds 2

The model is a StarCoder2-family decoder (GQA, RoPE, sliding window,
layernorm): ``--preset tiny`` (4 layers, d_model 256) or ``100m`` (12
layers, d_model 768, the real driver). Non-IID-ness: each client draws
from a distinct topic's unigram distribution. Runs on the card by default
and raises without one; the round runs in full float32
(``repro_torch.strict_fp32``). Checkpoints use the JAX package's format
(``repro_torch.checkpoint.io``), so either package resumes the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from repro_torch.checkpoint.io import restore, save
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.fed.simulator import FederatedSimulator, FedSimConfig
from repro_torch.models.model import build_model


def lm_config(preset: str):
    base = get_arch("starcoder2-3b")
    if preset == "100m":
        return dataclasses.replace(
            base, name="starcoder2-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072,
            vocab_size=8192, sliding_window=256,
            param_dtype="float32", compute_dtype="float32",
        )
    return dataclasses.replace(
        base, name="starcoder2-10m", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048,
        sliding_window=128, param_dtype="float32", compute_dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fed.train_lm")
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tau-max", type=int, default=4)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--mode", default="fedveca")
    ap.add_argument("--cohort", type=int, default=None,
                    help="participating clients per round (default: all)")
    ap.add_argument("--data-path", default="device", choices=("device", "host"),
                    help="device-resident shards vs numpy host-built batches")
    ap.add_argument("--overlap", type=int, default=1,
                    help="rounds in flight before host sync (0 = sync mode)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = lm_config(args.preset)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    n_params = sum(t.numel() for t in params.values())
    print(f"model={cfg.name} params~{n_params/1e6:.1f}M vocab={cfg.vocab_size}")

    # Non-IID: one topic per client (Case-2-like for language data)
    clients = [
        make_lm_tokens(256, args.seq, cfg.vocab_size, topic=i, seed=args.seed)
        for i in range(args.clients)
    ]
    test = make_lm_tokens(64, args.seq, cfg.vocab_size, topic=None, seed=args.seed + 99)

    fed_cfg = FedSimConfig(
        mode=args.mode, eta=args.eta, tau_max=args.tau_max, batch_size=args.batch,
        rounds=args.rounds, seed=args.seed, eval_every=5,
        log_dir=args.ckpt_dir, cohort_size=args.cohort, data_path=args.data_path,
        overlap=args.overlap,
    )
    sim = FederatedSimulator(model, clients, fed_cfg, test)

    start_round = 0
    if args.ckpt_dir and os.path.exists(os.path.join(args.ckpt_dir, "last", "manifest.json")):
        params, meta = restore(os.path.join(args.ckpt_dir, "last"), params)
        start_round = meta.get("round", 0)
        print(f"resumed from round {start_round}")

    t0 = time.time()
    # run in ckpt-every segments so checkpoints are round-resumable
    seg = args.ckpt_every if args.ckpt_dir else args.rounds
    done = start_round
    while done < args.rounds:
        n = min(seg, args.rounds - done)
        log = sim.run(params=params, rounds=n)
        params = log.params
        done += n
        if args.ckpt_dir:
            save(os.path.join(args.ckpt_dir, "last"), params, {"round": done})
        last = log.rows[-1]
        tok_per_s = (sum(int(np.sum(r["tau"])) for r in log.rows) * args.batch
                     * args.seq) / max(time.time() - t0, 1e-9)
        print(f"[round {done:4d}] train_ce={last['train_loss']:.4f} "
              f"test_ce={last.get('test_loss', float('nan')):.4f} "
              f"tau={last['tau']} ~{tok_per_s:,.0f} tok/s")
        t0 = time.time()
    print("done.")


if __name__ == "__main__":
    main()
