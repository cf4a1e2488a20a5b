"""qwen1.5-110b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab=152064,
        head_dim=128,
        qkv_bias=True,
        rope="rope",
        source="hf:Qwen/Qwen1.5-0.5B",
    )
)
