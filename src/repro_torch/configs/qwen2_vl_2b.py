"""qwen2-vl-2b — VLM backbone with M-RoPE (3-section rotary: t/h/w).

[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  The vision patch frontend is a STUB (``input_specs``
provides precomputed patch embeddings + 3-D M-RoPE position ids,
per the assignment); dynamic resolution enters only through the
position-id stream.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        head_dim=128,
        rope="mrope",
        mrope_sections=(16, 24, 24),
        modality="vision",
        source="arXiv:2409.12191",
    )
)
