"""Whisper-medium [arXiv:2212.04356]: encoder-decoder, conv frontend STUBBED.

24L enc + 24L dec, d_model=1024 16H d_ff=4096 vocab=51865, learned positions,
gelu, LayerNorm. The mel+conv frontend is a stub: input_specs() feeds
precomputed frame embeddings (1500, d_model). NOTE (DESIGN.md §5): Whisper's
decoder positional range is 448; decode_32k/long_500k are skipped, and
train/prefill shapes drive the *decoder* sequence beyond 448 only through
extended learned positions, exercised for sharding realism.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=24,
    encoder_layers=24,
    encoder_seq=1500,
    frontend_dim=1024,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    rope=False,
    learned_pos=True,
    mlp_act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm="layernorm",
    tie_embeddings=True,
)
