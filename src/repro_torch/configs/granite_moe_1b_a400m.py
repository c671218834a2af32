"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 32 experts top-8, swiglu, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
    tie_embeddings=True,
)
