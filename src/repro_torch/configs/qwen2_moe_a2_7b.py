"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; MoE: 60 routed experts top-4 with
per-expert d_ff=1408 + 4 always-on shared experts (fused as one 4x1408=5632
shared MLP, per the model card), swiglu, RMSNorm, RoPE, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
)
