"""Architecture configs and the registry (a copy of the JAX package's
``configs/base.py``: ``ArchConfig``, ``reduced()`` and ``get_arch``).

Only the architectures the port serves are registered; each resolves to a
module of ``repro_torch.configs``. ``reduced()`` is the CPU-test variant
(2 layers, d_model <= 128, f32) with exactly the JAX package's arithmetic,
so reduced configs agree between the two packages.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple

@dataclass(frozen=True)
class ArchConfig:
    """A single architecture in the zoo.

    The same dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM
    families; family-specific fields default to "off".
    """

    name: str
    family: str  # dense | moe | audio | hybrid | vlm | ssm | toy
    source: str  # citation from the assignment table

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention ---
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention; >0 = SWA window
    # Some archs get a sliding-window *variant* only for long_500k (flagged
    # per-shape at build time); `sliding_window` here is the native setting.
    swa_long_context_variant: bool = False  # arch supports SWA for long_500k

    # --- mlp ---
    mlp_act: str = "swiglu"  # swiglu | gelu | sq_relu
    mlp_bias: bool = False

    # --- norm / embeddings ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    learned_pos: bool = False  # whisper-style learned absolute positions

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_experts_pad: int = 0  # dummy (never-routed) experts appended so the
    #   expert axis divides the mesh model axis (beyond-paper optimization:
    #   turns d_ff-sharded expert fallback into true expert parallelism)
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (d_ff used if 0)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # --- SSM (mamba-style) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- xLSTM ---
    xlstm_pattern: Tuple[str, ...] = ()  # e.g. 7*("m",)+("s",) super-block
    xlstm_proj_factor: float = 2.0

    # --- hybrid (hymba): parallel attention + SSM heads in every layer ---
    hybrid_parallel_ssm: bool = False

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend output length (whisper: 1500)
    frontend_dim: int = 0  # stub embedding dim fed by input_specs()

    # --- VLM ---
    num_patches: int = 0  # stub vision tokens per image
    vision_dim: int = 0  # stub patch-embedding dim (projector input)

    # --- dtypes ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- toy models (paper's own SVM / CNN) ---
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny sizes."""
        if self.family == "toy":
            return self
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads))
        if heads % kv:
            kv = 1
        hd = 32
        d = hd * heads  # <= 128
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=4 * d if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.is_moe:
            kw.update(
                num_experts=4,
                experts_per_token=min(2, self.experts_per_token),
                num_shared_experts=min(1, self.num_shared_experts),
                moe_d_ff=2 * d,
            )
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=16, frontend_dim=d)
        if self.num_patches:
            kw.update(num_patches=4, vision_dim=64)
        if self.ssm_state:
            kw.update(ssm_state=8)
        if self.xlstm_pattern:
            kw.update(xlstm_pattern=("m", "s"), num_layers=2)
        if self.sliding_window:
            kw.update(sliding_window=min(self.sliding_window, 64))
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    # full attention (window=0); served here at reduced size by the CPU tests
    "qwen1.5-32b": "qwen1_5_32b",
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has: "
                       f"{sorted(ARCH_MODULES)} (ROADMAP.md lists the rest)")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


def list_archs():
    return list(ARCH_MODULES)
