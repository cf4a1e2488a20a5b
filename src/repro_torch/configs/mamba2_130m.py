"""mamba2-130m — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 (attn-free) vocab=50280,
ssm_state=128; expand=2 -> d_inner=1536, head_dim=64 -> 24 SSM heads.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_chunk=256,
        rope="none",
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )
)
