"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini LM backbone: 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064,
swiglu, RMSNorm, RoPE. Vision tower (CLIP ViT-L/14) is a STUB: input_specs()
provides precomputed patch embeddings (num_patches, vision_dim=1024); the
in-model projector (1024 -> 3072) is real and trained.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    vision_dim=1024,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope=True,
)
