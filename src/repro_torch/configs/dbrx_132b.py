"""dbrx-132b — Databricks DBRX, 16 experts top-4, fine-grained MoE.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16e top-4.
"""

from .base import ModelConfig, MoESpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        head_dim=128,
        moe=MoESpec(n_experts=16, top_k=4),
        rope="rope",
        source="hf:databricks/dbrx-base",
    )
)
