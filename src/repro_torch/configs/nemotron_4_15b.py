"""Nemotron-4-15B [arXiv:2402.16819]: dense decoder, squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU
(non-gated) MLP, LayerNorm, RoPE (partial in the paper; full here).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="sq_relu",
    norm="layernorm",
    rope=True,
)
