"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, local window 2048.  Block pattern (rec, rec, attn)
repeating — two recurrent blocks per local-attention block.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab=256000,
        head_dim=256,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,
        lru_width=2560,
        rope="rope",
        source="arXiv:2402.19427",
    )
)
