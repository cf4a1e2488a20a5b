"""yi-34b — llama-arch dense GQA.

[arXiv:2403.04652; hf]  60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        rope="rope",
        source="arXiv:2403.04652",
    )
)
