"""The paper's prototype system (§IV-A), literally: Algorithm 1 (server)
and Algorithm 2 (client) as message-passing objects (port of
``repro/fed/prototype.py`` and ``examples/prototype_cluster.py``).

The server sends (w_k, tau_i, ||grad F(w_{k-1})||^2) to each client; each
client replies with (F_i, G_i, grad F_i(w_k), beta_i, delta_i); the run
ends with a STOP flag. The wire protocol stays explicit, but the math on
both ends is the RoundEngine's: clients run ``engine.client_update`` (the
round's masked local loop) and the server reduces through
``engine.server_aggregate`` and ``engine.weighted_average`` (the
strategy and the vecavg reduce), so on the card the server's two reduces
a round are two vecavg launches. The byte counters are the wire cost of
every message, counted as the JAX package counts them.

Two dispatch fabrics run the same protocol:

  * ``batched=True`` (default): the server still composes one message a
    client and counts its bytes, each client still draws its minibatches
    from its private data, but every reply of the round comes from ONE
    ``engine.client_update_many`` call (batch stacks padded to tau_max:
    steps past tau_i are masked no-ops);
  * ``batched=False``: the testbed's loop, one ``engine.client_update``
    call a client message, on the client's own one-client engine.

Both consume each client's RNG identically, so the taus and the byte
counts are equal; the params differ by float32 rounding of the batched
gradient.

``wire=`` puts one codec (``core/wire.py``) on every client: replies
carry its payloads (billed as such), each client keeps its own
error-feedback residual, and the server decodes before it reduces.

    python -m repro_torch.fed.prototype --rounds 10
    python -m repro_torch.fed.prototype --device cpu --serial --wire int8

Runs on the card by default and raises without one.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.controller import ControllerConfig, FedVecaController
from repro_torch.core.engine import EngineConfig, RoundEngine
from repro_torch.core.fedveca import RoundStats
from repro_torch.core.tree import tree_sqnorm, tree_sub
from repro_torch.core.wire import IdentityCodec, make_codec
from repro_torch.data.device import format_batch
from repro_torch.data.partition import partition_case3
from repro_torch.data.synthetic import Dataset, binarize_even_odd, make_classification
from repro_torch.models.model import build_model_by_name


def _tree_bytes(t) -> int:
    """Wire bytes of a message: the bytes of every tensor in a (nested)
    dict. Applied to codec payloads, so lossy codecs are billed for their
    int8 buffers or top-k pairs, not the dense tree they decode into."""
    if isinstance(t, dict):
        return sum(_tree_bytes(v) for v in t.values())
    return t.numel() * t.element_size()


def _stack(trees: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-item trees -> one tree with a leading stack axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


class FedVecaClient:
    """Algorithm 2. Holds private local data; talks only in messages."""

    def __init__(self, client_id: int, model, data, batch_size: int, eta: float,
                 seed: int = 0):
        self.id = client_id
        self.model = model
        self.data = data
        self.b = batch_size
        self.eta = eta
        # the JAX package's draws: RandomState(seed + id), one a round
        self.rng = np.random.RandomState(seed + client_id)
        self._engine = None  # built lazily: the batched fabric never needs it
        # the server installs its codec; a lossy one keeps this client's
        # error-feedback residual here, where a testbed device would
        self.wire = IdentityCodec()
        self._wire_res = None

    def send_update(self, G):
        """Alg. 2 send: G through the wire codec with error feedback. Returns
        the payload the wire carries (G itself under the identity codec)."""
        if self.wire.is_identity:
            return G
        if self._wire_res is None:
            self._wire_res = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                              for k, v in G.items()}
        total = {k: u + self._wire_res[k].to(u.dtype) for k, u in G.items()}
        payload = self.wire.encode(total)
        decoded = self.wire.decode(payload, total)
        self._wire_res = {k: total[k] - decoded[k] for k in total}
        return payload

    @property
    def engine(self) -> RoundEngine:
        if self._engine is None:
            self._engine = RoundEngine(self.model.loss, EngineConfig(mode="fedveca", eta=self.eta),
                                       num_clients=1)
        return self._engine

    def _batches(self, tau: int):
        """Leaves [tau, b, ...]: exactly the minibatches the wire pays for."""
        idx = self.rng.randint(0, len(self.data), size=(tau, self.b))
        x = self.data.x[idx]
        y = None if np.issubdtype(x.dtype, np.integer) else self.data.y[idx]
        return format_batch(x, y, device=self.model.device)

    def prepare(self, msg: Dict[str, Any]):
        """Receive the round message and stage the local job: this round's
        minibatches from PRIVATE data (the serial path's RNG stream)."""
        tau = int(msg["tau"])
        return tau, self._batches(tau)

    def local_round(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Receive (w_k, tau_i, ||grad F(w_{k-1})||^2); run Alg. 2 lines 3-19."""
        tau = int(msg["tau"])
        out = self.engine.client_update(msg["w"], self._batches(tau), tau,
                                        float(msg.get("gprev_sqnorm", 0.0)))
        return dict(id=self.id, G=self.send_update(out["G"]), g0=self.wire.encode(out["g0"]),
                    beta=float(out["beta"]), delta=float(out["delta"]),
                    loss0=float(out["loss0"]), tau=tau)


class FedVecaServer:
    """Algorithm 1. Orchestrates rounds, estimates L, predicts tau (the
    numpy ``FedVecaController``); params from ``model.init(seed)`` on the
    model's device."""

    def __init__(self, model, clients: List[FedVecaClient], p: np.ndarray, eta: float,
                 alpha: float = 0.95, tau_max: int = 50, tau_init: int = 2, seed: int = 0,
                 batched: bool = True, wire="none"):
        self.model = model
        self.clients = clients
        self.p = np.asarray(p, np.float64)
        self.eta = eta
        self.batched = batched  # one client_update_many call a round
        self.tau_max = tau_max
        self.wire = make_codec(wire)
        for c in clients:  # one codec for the whole deployment
            c.wire = self.wire
            c._wire_res = None
        self.engine = RoundEngine(
            model.loss, EngineConfig(mode="fedveca", eta=eta, tau_max=tau_max),
            num_clients=len(clients))
        self.controller = FedVecaController(
            ControllerConfig(eta=eta, alpha=alpha, tau_max=tau_max, tau_init=tau_init),
            len(clients))
        self.params = model.init(seed)
        self.taus = self.controller.init_taus()
        self.ctrl_state = self.controller.init_state()
        self.gprev_sqnorm = 0.0
        self.bytes_sent = 0  # server -> clients
        self.bytes_recv = 0  # clients -> server
        self.history: List[Dict[str, Any]] = []

    def _collect_replies(self) -> List[Dict[str, Any]]:
        """One message a client out, one reply a client back. The batched
        fabric computes every reply in ONE ``client_update_many`` call;
        messages, data draws and wire accounting stay per client."""
        msgs = []
        for tau in self.taus:
            msgs.append(dict(w=self.params, tau=int(tau), gprev_sqnorm=self.gprev_sqnorm))
            self.bytes_sent += _tree_bytes(self.params) + 16
        if not self.batched:
            return [c.local_round(m) for c, m in zip(self.clients, msgs)]
        jobs = [c.prepare(m) for c, m in zip(self.clients, msgs)]
        taus = np.array([t for t, _ in jobs], np.int32)

        def pad(b):
            return {k: torch.cat([x, x.new_zeros((self.tau_max - x.shape[0],) + x.shape[1:])])
                    for k, x in b.items()}

        outs = self.engine.client_update_many(
            self.params, _stack([pad(b) for _, b in jobs]), taus, float(self.gprev_sqnorm))
        # each reply leaves through ITS client's codec state: the batched
        # fabric shares the card, not the wire
        return [dict(id=c.id, G=c.send_update({k: v[i] for k, v in outs["G"].items()}),
                     g0=c.wire.encode({k: v[i] for k, v in outs["g0"].items()}),
                     beta=float(outs["beta"][i]), delta=float(outs["delta"][i]),
                     loss0=float(outs["loss0"][i]), tau=int(taus[i]))
                for i, c in enumerate(self.clients)]

    def round(self) -> Dict[str, Any]:
        params_start = self.params
        recv_before = self.bytes_recv
        replies = self._collect_replies()
        for reply in replies:  # codec payloads: these ARE the uplink bytes
            self.bytes_recv += _tree_bytes(reply["G"]) + _tree_bytes(reply["g0"]) + 24
        if not self.wire.is_identity:
            # decode-before-reduce: the reduces below see dense trees
            for reply in replies:
                reply["G"] = self.wire.decode(reply["G"], self.params)
                reply["g0"] = self.wire.decode(reply["g0"], self.params)

        p32 = np.asarray(self.p, np.float32)
        self.params, tau_k = self.engine.server_aggregate(
            self.params, _stack([r["G"] for r in replies]), np.asarray(self.taus), p32)
        global_grad = self.engine.weighted_average(_stack([r["g0"] for r in replies]), p32)
        stats = RoundStats(
            loss0=np.array([r["loss0"] for r in replies], np.float32),
            beta=np.array([r["beta"] for r in replies], np.float32),
            delta=np.array([r["delta"] for r in replies], np.float32),
            g0_sqnorm=np.array([float(tree_sqnorm(r["g0"])) for r in replies], np.float32),
            tau=np.asarray(self.taus),
            tau_k=tau_k,
            global_grad=global_grad,
            update_sqnorm=tree_sqnorm(tree_sub(self.params, params_start)),
            params_sqnorm=tree_sqnorm(params_start),
            global_grad_sqnorm=tree_sqnorm(global_grad),
        )
        self.ctrl_state, self.taus, diag = self.controller.update(self.ctrl_state, stats)
        self.gprev_sqnorm = float(stats.global_grad_sqnorm)
        row = dict(round=len(self.history), tau=self.taus.copy(),
                   **{k: diag.get(k) for k in ("L", "premise", "alpha_k")},
                   wire=self.wire.name, wire_bytes=self.bytes_recv - recv_before)
        self.history.append(row)
        return row

    def run(self, rounds: int):
        for _ in range(rounds):
            self.round()
        # STOP flag (Alg. 1 lines 27-29): one byte to each client
        self.bytes_sent += len(self.clients)
        return self.params


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fed.prototype")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--serial", action="store_true",
                    help="literal per-client dispatch loop (testbed mode)")
    ap.add_argument("--wire", default="none", help="none | int8 | topk:K")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    model = build_model_by_name("svm-mnist", device=args.device)
    orig = make_classification(2000, (784,), 10, seed=0)
    train = binarize_even_odd(orig)
    parts = partition_case3(orig.y, args.clients, seed=0)
    clients = [FedVecaClient(i, model, Dataset(train.x[s], train.y[s]), batch_size=16,
                             eta=args.eta) for i, s in enumerate(parts)]
    p = np.array([len(s) for s in parts], float)
    p /= p.sum()
    server = FedVecaServer(model, clients, p, eta=args.eta, tau_max=20,
                           batched=not args.serial, wire=args.wire)
    fabric = ("serial per-client dispatches" if args.serial
              else "continuous-batched (one dispatch a round)")
    print(f"server + {args.clients} clients on {model.device}, weights={np.round(p, 3)}, "
          f"fabric={fabric}, wire={server.wire.name}")
    t0 = time.perf_counter()
    for k in range(args.rounds):
        row = server.round()
        prem = row["premise"]
        print(f"round {k:3d}: tau={row['tau']} L={row['L']:.3f} "
              f"premise={prem if prem is None else round(prem, 2)} "
              f"uplink={row['wire_bytes']} B")
    print(f"\n{args.rounds} rounds in {time.perf_counter() - t0:.1f}s ({fabric})")
    print(f"wire traffic: server->clients {server.bytes_sent / 1e6:.2f} MB, "
          f"clients->server {server.bytes_recv / 1e6:.2f} MB over {args.rounds} rounds")


if __name__ == "__main__":
    main()
