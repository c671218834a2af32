"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM recurrent blocks, no attention.

48L d_model=2048, 4 heads, vocab=50304, d_ff=0 (blocks carry their own
up/down projections). Block pattern follows xLSTM[7:1]: super-blocks of
7 mLSTM + 1 sLSTM, repeated 6x = 48 layers. Sub-quadratic by construction
(long_500k native, O(1) recurrent state per layer).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    xlstm_proj_factor=2.0,
    norm="layernorm",
    rope=False,
    tie_embeddings=True,
)
