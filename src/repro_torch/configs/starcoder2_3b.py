"""StarCoder2-3B [arXiv:2402.19173]: dense GQA decoder, sliding-window 4096.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, RoPE, gelu MLP,
LayerNorm, attention/MLP bias. StarCoder2's native sliding-window attention
(window 4096) makes it eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope=True,
    rope_theta=999_999.0,
    sliding_window=4096,
    swa_long_context_variant=True,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    tie_embeddings=True,
)
