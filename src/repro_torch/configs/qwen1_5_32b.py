"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: dense decoder with QKV bias.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064, swiglu, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
)
