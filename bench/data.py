"""A cell's inputs, made from ``--seed`` by the benchmark itself and handed
to both the program and the plain reference: the weights (on the device,
in one draw from a ``torch.Generator`` there) and the clients' token
sequences (numpy, in bulk).

The token data follow the federated LM example's Non-IID scheme: a bank of
per-topic unigram distributions (a Dirichlet draw over the vocabulary),
client i drawing only from topic i, the test set mixing the topics.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1, np.uint64)[0] >> 1)


def weight_layout(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Every parameter leaf as the port lays it out (weights ``[in, out]``,
    layers stacked ``[L, ...]``), with its initial standard deviation:
    N(0, 1/in) matrices, N(0, 0.02^2) embedding and router, zero norm
    scales and biases."""
    d, H, Hkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    L, V, f = cfg["num_hidden_layers"], cfg["vocab_size"], cfg["intermediate_size"]
    q, kv = H * hd, Hkv * hd
    out: Dict[str, Tuple[Tuple[int, ...], float]] = {
        "embed": ((V, d), 0.02),
        "final_norm/scale": ((d,), 0.0),
        "layers/norm1/scale": ((L, d), 0.0),
        "layers/norm2/scale": ((L, d), 0.0),
        "layers/attn/w_q": ((L, d, q), 1 / math.sqrt(d)),
        "layers/attn/w_k": ((L, d, kv), 1 / math.sqrt(d)),
        "layers/attn/w_v": ((L, d, kv), 1 / math.sqrt(d)),
        "layers/attn/w_o": ((L, q, d), 1 / math.sqrt(q)),
    }
    if cfg.get("attention_bias"):
        out.update({"layers/attn/b_q": ((L, q), 0.0), "layers/attn/b_k": ((L, kv), 0.0),
                    "layers/attn/b_v": ((L, kv), 0.0)})
    E = cfg.get("num_local_experts", 0)
    if E:
        out.update({"layers/moe/router": ((L, d, E), 0.02),
                    "layers/moe/w_gate": ((L, E, d, f), 1 / math.sqrt(d)),
                    "layers/moe/w_up": ((L, E, d, f), 1 / math.sqrt(d)),
                    "layers/moe/w_down": ((L, E, f, d), 1 / math.sqrt(f))})
    else:
        out.update({"layers/mlp/w_gate": ((L, d, f), 1 / math.sqrt(d)),
                    "layers/mlp/w_up": ((L, d, f), 1 / math.sqrt(d)),
                    "layers/mlp/w_down": ((L, f, d), 1 / math.sqrt(f))})
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = ((d, V), 1 / math.sqrt(d))
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights, float32: one ``randn`` over every leaf from a
    generator on ``device``, then each leaf's slice scaled (or zeroed) in
    place. Leaves are views into that one buffer."""
    layout = weight_layout(cfg)
    total = sum(math.prod(shape) for shape, _ in layout.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for key in sorted(layout):
        shape, std = layout[key]
        n = math.prod(shape)
        leaf = flat[off:off + n]
        leaf.mul_(std) if std else leaf.zero_()
        out[key] = leaf.view(shape)
        off += n
    return out


def client_sizes(traffic: dict, seed: int) -> np.ndarray:
    """The traffic's fixed set of client sizes in an order drawn from the
    seed: every seed trains on the same sizes, so the same work."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    return rng.permutation(np.asarray(traffic["client_sizes"], np.int64))


def make_tokens(cfg: dict, traffic: dict, seed: int) -> Tuple[List[np.ndarray], np.ndarray]:
    """-> (client sequences, each int32 [n_i, seq + 1] from topic i; the
    IID test set [test_seqs, seq + 1])."""
    V, S = cfg["vocab_size"], traffic["seq"]
    T = traffic["topics"]
    rng = np.random.default_rng(sub_seed(seed, 2))
    bank = rng.dirichlet(np.full(V, traffic["topic_concentration"]), size=T)
    cdf = np.cumsum(bank, axis=1)
    cdf /= cdf[:, -1:]

    def draw(topics: np.ndarray) -> np.ndarray:
        u = rng.random((len(topics), S + 1))
        out = np.empty((len(topics), S + 1), np.int32)
        for t in np.unique(topics):
            rows = topics == t
            out[rows] = np.minimum(np.searchsorted(cdf[t], u[rows], side="right"), V - 1)
        return out

    sizes = client_sizes(traffic, seed)
    clients = [draw(np.full(int(n), i % T)) for i, n in enumerate(sizes)]
    test = draw(rng.integers(0, T, size=traffic["test_seqs"]))
    return clients, test
