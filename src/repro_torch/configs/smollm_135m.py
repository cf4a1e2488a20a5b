"""smollm-135m — llama-arch small dense GQA (the ~100M-class example model).

[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152.
"""

from .base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        head_dim=64,
        rope="rope",
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
)
