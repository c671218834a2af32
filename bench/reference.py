"""The plain reference of a cell: the federated round written out client
by client in plain PyTorch, with no ``vmap``, no kernel and no fused
loop, from the inputs the benchmark made.

It imports nothing of the program. What the program derives from the
inputs it works out again: the cohorts and the minibatch indices from the
run's seed (the draws the federated simulator specifies: a numpy
``default_rng(seed)`` choice of the cohort a round, and for client i of
round k ``torch.randint`` from a generator on the device seeded from
``SeedSequence([SeedSequence([seed, k]) word, i])``), the local loop of
Alg. 2 with its Assumption-3/4 statistics, the server step of Eq. 4 or
Eq. 5, the Eq. 8 global gradient, Alg. 1's controller with the staleness
view of partial participation, and the evaluation's test loss.

The model is a frozen copy of the two families' equations as the port
runs them: a decoder with RMSNorm (weight 1 + scale, eps 1e-6), rotary
embeddings (half split), grouped-query causal attention with a float32
softmax, a SwiGLU MLP or a top-k mixture of SwiGLU experts (float32
router, gates renormalised over the k, capacity factor token dropping in
(token, slot) order, the GShard load-balance loss averaged over layers),
a tied unembedding and the mean token cross entropy.

``precision="tf32"`` computes every matrix product in TF32 (the card's
TF32 mode; on the CPU its rounding of the inputs to 10 mantissa bits):
the control, which the comparison has to refuse. ``fault=`` plants one of
the faults the comparison has to catch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

FAULTS = ("half_batch", "token", "frozen")


# ---------------------------------------------------------------------------
# the draws the simulator specifies
# ---------------------------------------------------------------------------


def seed_word(*words: int) -> int:
    """One 64-bit word of ``numpy.random.SeedSequence(words)``."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])


def cohorts(seed: int, clients: int, size: int, rounds: int) -> List[np.ndarray]:
    """The cohort of each round: sorted distinct ids, all clients when
    ``size`` covers them."""
    rng = np.random.default_rng(seed)
    if size >= clients:
        return [np.arange(clients) for _ in range(rounds)]
    return [np.sort(rng.choice(clients, size=size, replace=False)) for _ in range(rounds)]


def minibatch_rows(seed: int, k: int, client: int, n: int, steps: int, batch: int, device):
    """Client ``client``'s sequence indices [steps, batch] in round ``k``."""
    gen = torch.Generator(device=device).manual_seed(seed_word(seed_word(seed, k), client))
    return torch.randint(0, n, (steps, batch), device=device, generator=gen)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tf32(x):
    """``x`` rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with every product's inputs rounded to TF32, forward and
    backward, as the card's TF32 mode computes them (the CPU has none)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _tf32(g) @ _tf32(b).transpose(-1, -2)
        gb = _tf32(a).transpose(-1, -2) @ _tf32(g)
        while gb.dim() > b.dim():  # a weight broadcast over leading dims
            gb = gb.sum(0)
        return ga, gb


class _Precision:
    """Matrix products in float32 (TF32 off) or in TF32."""

    def __init__(self, precision: str, device):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.emulate = precision == "tf32" and torch.device(device).type != "cuda"
        self.precision = precision

    @contextlib.contextmanager
    def scope(self):
        prev = torch.get_float32_matmul_precision()
        m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        tf32 = self.precision == "tf32"
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c

    def mm(self, a, b):
        return _TF32Matmul.apply(a, b) if self.emulate else a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x, theta: float):
    """x [B, S, H, hd], positions 0..S-1, the two halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=x.device)
                 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg, lw, x, pr: _Precision):
    B, S, d = x.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    q, k, v = pr.mm(x, lw["attn/w_q"]), pr.mm(x, lw["attn/w_k"]), pr.mm(x, lw["attn/w_v"])
    if "attn/b_q" in lw:
        q, k, v = q + lw["attn/b_q"], k + lw["attn/b_k"], v + lw["attn/b_v"]
    q = _rope(q.reshape(B, S, H, hd), cfg["rope_theta"]).transpose(1, 2)
    k = _rope(k.reshape(B, S, Hkv, hd), cfg["rope_theta"]).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    logits = pr.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, -1e30)
    o = pr.mm(torch.softmax(logits, dim=-1), v)  # [B, H, S, hd]
    return pr.mm(o.transpose(1, 2).reshape(B, S, H * hd), lw["attn/w_o"])


def _swiglu(x, wg, wu, wd, pr: _Precision):
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def _moe(cfg, lw, x, pr: _Precision):
    """Top-k routing with capacity, expert by expert -> (y, aux loss)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg["num_local_experts"], cfg["num_experts_per_tok"]
    xf = x.reshape(T, d)
    probs = torch.softmax(pr.mm(xf, lw["moe/router"]), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(1, round(k * T / E * cfg["capacity_factor"])))
    e_flat = idx.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    # rank of each (token, slot) among those routed to its expert, in order
    rank = (onehot.cumsum(0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = rank < cap
    w_flat = gates.reshape(-1) * keep
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    y = torch.zeros_like(xf)
    for e in range(E):
        sel = torch.nonzero((e_flat == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        t = token[sel]
        out = _swiglu(xf[t], lw["moe/w_gate"][e], lw["moe/w_up"][e], lw["moe/w_down"][e], pr)
        y = y.index_add(0, t, out * w_flat[sel, None])
    frac = onehot.sum(0).float() / (T * k)
    aux = E * torch.sum(probs.mean(0) * frac) * cfg["router_aux_loss_coef"]
    return y.reshape(B, S, d), aux


def loss(cfg: dict, w: Dict[str, torch.Tensor], seqs, pr: _Precision):
    """Mean token cross entropy (plus the routers' mean aux loss) of
    ``seqs`` [B, S + 1] (inputs ``seqs[:, :-1]``, targets ``seqs[:, 1:]``)."""
    tokens, targets = seqs[:, :-1].long(), seqs[:, 1:].long()
    eps, L = cfg["rms_norm_eps"], cfg["num_hidden_layers"]
    stacked = {k[len("layers/"):]: v.unbind(0) for k, v in w.items() if k.startswith("layers/")}
    h = w["embed"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(L):
        lw = {k: v[i] for k, v in stacked.items()}
        h = h + _attention(cfg, lw, _rmsnorm(h, lw["norm1/scale"], eps), pr)
        hn = _rmsnorm(h, lw["norm2/scale"], eps)
        if cfg.get("num_local_experts"):
            y, a = _moe(cfg, lw, hn, pr)
            aux = aux + a
        else:
            y = _swiglu(hn, lw["mlp/w_gate"], lw["mlp/w_up"], lw["mlp/w_down"], pr)
        h = h + y
    h = _rmsnorm(h, w["final_norm/scale"], eps)
    head = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
    logits = pr.mm(h, head)
    ce = (torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]).mean()
    return ce + aux / L


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _sq(tree_a, tree_b=None) -> float:
    """Squared distance of two trees (float64), or a tree's squared norm."""
    return float(sum(((a - tree_b[k]) if tree_b is not None else a).double().square().sum()
                     for k, a in tree_a.items()))


def _local(cfg, w0, batches, tau: int, gprev_sqnorm: float, eta: float, pr, fault):
    """Alg. 2 for one client: ``tau`` SGD steps on ``batches`` [T, b, S + 1]
    -> dict(cum_g, g0 trees; loss0, beta, delta floats)."""
    keys = sorted(w0)
    w = {k: v.clone() for k, v in w0.items()}
    g0 = cum = None
    loss0, beta, delta = 0.0, 0.0, 0.0
    for lam in range(tau):
        seqs = batches[lam]
        if fault == "half_batch":
            seqs = seqs[: seqs.shape[0] // 2]
        if fault == "token":
            seqs = seqs.clone()
            seqs[0, -1] = (seqs[0, -1] + 1) % cfg["vocab_size"]
        leaves = [w[k].requires_grad_(True) for k in keys]
        value = loss(cfg, w, seqs, pr)
        grads = torch.autograd.grad(value, leaves)
        g = {k: gk.detach() for k, gk in zip(keys, grads)}
        w = {k: v.detach() for k, v in w.items()}
        if lam == 0:
            g0, cum, loss0 = g, {k: v.clone() for k, v in g.items()}, float(value.detach())
        else:
            cum = {k: cum[k] + g[k] for k in keys}
            dist = _sq(w, w0)
            beta = max(beta, math.sqrt(_sq(g, g0) / max(dist, 1e-20)))
            delta = max(delta, _sq(cum) / ((lam + 1.0) * max(gprev_sqnorm, 1e-20)))
        w = {k: w[k] - eta * g[k] for k in keys}
        del g
    return dict(cum_g=cum, g0=g0, loss0=loss0, beta=beta, delta=delta)


class _Controller:
    """Alg. 1's server state and Eq. 15 in float32, with the staleness
    view of clients outside the cohort."""

    def __init__(self, traffic: dict, clients: int, taus: np.ndarray):
        self.eta = np.float32(traffic["eta"])
        self.alpha = np.float32(traffic["alpha"])
        self.decay = np.float32(traffic["stats_decay"])
        self.tau_max, self.tau_min = traffic["tau_max"], 2
        self.adapt = traffic["mode"] == "fedveca"
        self.k = 0
        self.L = np.float32(0)
        self.taus = taus.astype(np.int32)
        self.ever = np.zeros(clients, bool)
        self.stale = np.zeros(clients, np.float32)
        self.vals = {n: np.zeros(clients, np.float32) for n in ("beta", "delta")}
        self.gg_prev = self.gg_prev2 = None
        self.gsq_prev = np.float32(0)
        self.p0sq = np.float32(0)
        self.usq_prev = self.usq_prev2 = np.float32(0)

    def step(self, members, beta, delta, gg, gsq, psq, usq):
        eps = np.float32(1e-12)
        self.stale = self.stale * self.decay
        self.stale[members] = 1.0
        self.vals["beta"][members] = beta
        self.vals["delta"][members] = delta
        self.ever[members] = True
        ever = self.ever.astype(np.float32)
        n_obs = max(np.float32(ever.sum()), np.float32(1))
        view = {}
        for n, v in self.vals.items():
            mean = np.float32((v * ever).sum() / n_obs)
            view[n] = self.stale * v + (np.float32(1) - self.stale) * mean
        if self.k == 1:
            self.L = max(self.L, np.float32(np.sqrt(self.gsq_prev) / max(np.sqrt(self.p0sq), eps)))
        elif self.k >= 2:
            num = np.float32(math.sqrt(_sq(self.gg_prev, self.gg_prev2)))
            self.L = max(self.L, np.float32(num / max(np.float32(np.sqrt(self.usq_prev2)), eps)))
        A = self.eta * np.square(view["beta"]) * view["delta"]
        if self.adapt and self.k >= 1 and np.isfinite(A).all() and (A > eps).any():
            A_safe = np.maximum(A, eps)
            A_min = A_safe.min()
            bound = np.float32(2) * self.L / max(A_min, eps)
            alpha_k = min(np.float32(0.999) * bound, self.alpha) if bound < 1 else self.alpha
            denom = A_safe - alpha_k * A_min
            tau_f = np.where(denom > eps, np.floor(A_safe / np.maximum(denom, eps)),
                             np.float32(self.tau_max))
            tau_f = np.where(tau_f <= 1, np.float32(self.tau_min), tau_f)
            self.taus = np.clip(tau_f, self.tau_min, self.tau_max).astype(np.int32)
        if self.k == 0:
            self.p0sq = np.float32(psq)
        self.gg_prev2, self.gg_prev = self.gg_prev, gg
        self.gsq_prev = np.float32(gsq)
        self.usq_prev2, self.usq_prev = self.usq_prev, np.float32(usq)
        self.k += 1
        return self.taus.copy()


def run_rounds(cfg: dict, traffic: dict, seed: int, w0, clients, test, *, rounds: int,
               device, precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """``rounds`` federated rounds from ``w0`` on ``clients`` (int arrays
    [n_i, S + 1]) -> the same record the harness takes from the program:
    ``rounds`` (per round: ``train_loss``, ``cohort``, ``tau_next`` [C],
    ``beta`` and ``delta`` of the cohort, ``test_loss`` where the
    simulator evaluates), ``d1`` and ``dR`` (per leaf, ||w_1 - w_0|| and
    ||w_R - w_0||)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; one of {FAULTS}")
    pr = _Precision(precision, device)
    C, T, b = len(clients), traffic["tau_max"], traffic["batch"]
    eta, mode = traffic["eta"], traffic["mode"]
    sizes = np.array([len(c) for c in clients], np.float64)
    p = (sizes / sizes.sum()).astype(np.float32)
    data = [torch.as_tensor(c, device=device) for c in clients]
    test_t = torch.as_tensor(test, device=device)
    first = traffic["tau_init"] if mode == "fedveca" else T
    ctrl = _Controller(traffic, C, np.full(C, first, np.int32))
    w = {k: v.detach().clone() for k, v in w0.items()}
    out_rounds, d1 = [], None
    with pr.scope():
        for k, members in enumerate(cohorts(seed, C, traffic["cohort"], rounds)):
            taus = np.clip(ctrl.taus, 1, T)
            pw = p[members] / p[members].sum(dtype=np.float32)
            tau_k = float(np.float32((pw * taus[members].astype(np.float32)).sum()))
            step = gg = None
            beta, delta, loss0 = [], [], []
            for j, i in enumerate(members):
                rows = minibatch_rows(seed, k, int(i), len(clients[i]), T, b, device)
                o = _local(cfg, w, data[i][rows], int(taus[i]), float(ctrl.gsq_prev), eta, pr,
                           fault)
                scale = float(pw[j]) / (float(taus[i]) if mode == "fedveca" else 1.0)
                step = {n: (0 if step is None else step[n]) + scale * o["cum_g"][n]
                        for n in o["cum_g"]}
                gg = {n: (0 if gg is None else gg[n]) + float(pw[j]) * o["g0"][n]
                      for n in o["g0"]}
                beta.append(o["beta"])
                delta.append(o["delta"])
                loss0.append(o["loss0"])
                del o
            mult = eta * tau_k if mode == "fedveca" else eta
            upd = {n: -mult * v for n, v in step.items()}
            if fault == "frozen":
                upd = {n: torch.zeros_like(v) for n, v in upd.items()}
            psq = _sq(w)
            w = {n: w[n] + upd[n] for n in w}
            tau_next = ctrl.step(members, np.float32(beta), np.float32(delta), gg, _sq(gg), psq,
                                 _sq(upd))
            row = dict(train_loss=float(np.dot(pw.astype(np.float64), loss0)),
                       cohort=[int(i) for i in members], tau_next=[int(t) for t in tau_next],
                       beta=beta, delta=delta)
            if k % traffic["eval_every"] == 0 or k == rounds - 1:
                with torch.no_grad():
                    row["test_loss"] = float(loss(cfg, w, test_t, pr))
            out_rounds.append(row)
            if k == 0:
                d1 = leaf_norms(w, w0)
            del step, upd
    return dict(rounds=out_rounds, d1=d1, dR=leaf_norms(w, w0))


def leaf_norms(w, w0) -> Dict[str, float]:
    """||w - w0|| a leaf, in float64."""
    return {k: float(torch.linalg.vector_norm((w[k] - w0[k]).double())) for k in sorted(w0)}
