"""Hymba-1.5B [arXiv:2411.13676]: hybrid-head — parallel attention + SSM.

32L d_model=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16, vocab=32001.
Every layer runs attention heads and mamba heads in parallel on the same
input and fuses (mean of the two normalized branch outputs), per the paper.
Sliding-window attention in most layers makes long_500k native.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    hybrid_parallel_ssm=True,
    sliding_window=2048,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
    tie_embeddings=True,
)
