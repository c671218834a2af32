"""DeepSeek-Coder-33B [arXiv:2401.14196]: llama-arch dense decoder.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, swiglu, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    source="arXiv:2401.14196",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=100_000.0,
)
