"""moonlight-16b-a3b — Moonlight-16B-A3B (DeepSeek-V3's architecture).

[hf:moonshotai/Moonlight-16B-A3B, config.json; model_type deepseek_v3]
27L d_model=2048 16H, latent attention (kv_lora_rank 512, q_lora_rank
null, qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim 128), one
leading dense layer (intermediate_size 11264), then 26 MoE layers of 64
routed experts (moe_intermediate_size 1408), top-6, 2 shared experts;
sigmoid scoring with a correction bias (noaux_tc, n_group 1), normalised
top-k weights times routed_scaling_factor 2.446, dropless; vocab 163840,
untied head, rope_theta 50000, rms_norm_eps 1e-5.  Registered in this
package alone (``PORT_ONLY_ARCHS``): it serves; the dry-run, sharding
presets and training are out of its scope.
"""

from .base import ModelConfig, MoESpec, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="moonlight-16b-a3b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163840,
        moe=MoESpec(n_experts=64, top_k=6, n_shared=2, scoring="sigmoid",
                    correction_bias=True, routed_scale=2.446, dropless=True),
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        first_dense_layers=1,
        dense_d_ff=11264,
        rope="rope",
        rope_theta=50000.0,
        norm_eps=1e-5,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
