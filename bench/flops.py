"""The benchmark's own arithmetic: parameters, useful model FLOPs and the
bytes a kernel call needs, from a configuration file's published keys
(``configs/<name>.json``) and the call's shapes, plus the table of peaks.

Kept here, apart from the program, so that a change to the program cannot
change its own yardstick. Useful FLOPs count the matrix products a token
needs (6 x the active matmul weights for a training step, 2 x for a
forward) and the causal attention products; masked local steps, the
recomputed forward of rematerialization, norms and elementwise work are
not counted.
"""
from __future__ import annotations

import json
from pathlib import Path

_HERE = Path(__file__).resolve().parent


def peaks(device_name: str) -> dict:
    """The peak table's row for a card (matched by the family in its name)."""
    table = json.loads((_HERE / "peaks.json").read_text())
    for family, row in table.items():
        if family in device_name:
            return row
    raise KeyError(f"no peak table row for {device_name!r} (have {sorted(table)})")


def _dims(cfg: dict):
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    return d, H, Hkv, hd


def attn_matmul_params(cfg: dict) -> int:
    """q, k, v and o projections of one layer."""
    d, H, Hkv, hd = _dims(cfg)
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def ffn_matmul_params(cfg: dict, active: bool) -> int:
    """One layer's feed-forward weights: a SwiGLU MLP, or the router and
    the experts (the ``num_experts_per_tok`` a token reaches when
    ``active``, all of them otherwise)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    E = cfg.get("num_local_experts", 0)
    if not E:
        return 3 * d * f
    n = cfg["num_experts_per_tok"] if active else E
    return d * E + n * 3 * d * f


def head_params(cfg: dict) -> int:
    return cfg["vocab_size"] * cfg["hidden_size"]


def matmul_params_per_token(cfg: dict) -> int:
    """The matmul weights one token's forward touches: every layer's
    projections and active feed-forward weights, and the unembedding
    (the embedding matrix itself when tied)."""
    L = cfg["num_hidden_layers"]
    return L * (attn_matmul_params(cfg) + ffn_matmul_params(cfg, active=True)) + head_params(cfg)


def param_count(cfg: dict) -> int:
    """Every parameter the model holds (the server reduce's D)."""
    d, H, Hkv, hd = _dims(cfg)
    L = cfg["num_hidden_layers"]
    per_layer = attn_matmul_params(cfg) + ffn_matmul_params(cfg, active=False) + 2 * d
    if cfg.get("attention_bias"):
        per_layer += H * hd + 2 * Hkv * hd
    n = L * per_layer + cfg["vocab_size"] * d + d  # layers, embedding, final norm
    if not cfg["tie_word_embeddings"]:
        n += head_params(cfg)
    return n


def attn_forward_flops(cfg: dict, seq: int) -> int:
    """QK^T and PV of one causal sequence through every layer: each of the
    S(S+1)/2 live (query, key) pairs costs 2 x 2 x head_dim a head."""
    _, H, _, hd = _dims(cfg)
    return cfg["num_hidden_layers"] * 4 * H * hd * (seq * (seq + 1) // 2)


def train_flops_per_seq(cfg: dict, seq: int) -> int:
    """One sequence through one training step (forward and backward)."""
    return 6 * matmul_params_per_token(cfg) * seq + 3 * attn_forward_flops(cfg, seq)


def forward_flops_per_seq(cfg: dict, seq: int) -> int:
    return 2 * matmul_params_per_token(cfg) * seq + attn_forward_flops(cfg, seq)


def window_flops(cfg: dict, seq: int, active_seqs: int, eval_seqs: int) -> int:
    """Useful FLOPs of a stretch of rounds: ``active_seqs`` sequences
    through active local steps, ``eval_seqs`` through evaluation forwards."""
    return active_seqs * train_flops_per_seq(cfg, seq) + eval_seqs * forward_flops_per_seq(cfg, seq)


def vecavg_bytes(clients: int, numel: int, div: bool) -> int:
    """Bytes one vecavg call needs, float32: the [C, D] rows read once,
    the [D] result written, p and the per-client squared norms (and the
    divisors when the call divides)."""
    return 4 * (clients * numel + numel + 2 * clients + (clients if div else 0))
