"""Model configuration schema + architecture registry.

Every assigned architecture registers a :class:`ModelConfig` here; the
model zoo (``repro_torch.models``) builds from these, the launcher selects
them via ``--arch <id>``, and each config can produce a ``reduced()`` twin
of the same family for CPU smoke tests.  Pure data: the registry equals
the JAX package's, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = [
    "MoESpec",
    "ModelConfig",
    "ARCH_REGISTRY",
    "register_arch",
    "get_arch",
    "list_archs",
    "PORT_ONLY_ARCHS",
]

# Archs registered in this package alone (the JAX package has no latent
# attention): serving only; the dry-run, sharding presets and training
# refuse them.
PORT_ONLY_ARCHS = ("moonlight-16b-a3b",)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    # capacity factor for expert dispatch buffers (tokens per expert =
    # tokens * top_k / n_experts * capacity)
    capacity: float = 1.25
    # --- DeepSeek's router (port-only; the defaults are the softmax router) ---
    n_shared: int = 0  # shared experts, run as one SwiGLU n_shared * d_ff wide on every token
    scoring: str = "softmax"  # softmax | sigmoid
    correction_bias: bool = False  # noaux_tc: the top k chosen by score + a per-expert bias
    norm_topk: bool = True  # the top-k weights normalised to sum 1 (the softmax router always is)
    routed_scale: float = 1.0  # routed_scaling_factor on the top-k weights
    dropless: bool = False  # every routed pair runs (no capacity): ``layers.dropless_moe``

    def __post_init__(self) -> None:
        if self.scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown MoE scoring {self.scoring!r}")
        unscaled = self.routed_scale == 1.0  # repro-lint: ignore[P201]  # 1.0 is the default given exactly; any other value is a scale
        plain = (self.scoring == "softmax" and not self.correction_bias and self.norm_topk
                 and unscaled and self.n_shared == 0)
        if not self.dropless and not plain:
            raise ValueError("the capacity router is softmax top-k alone: DeepSeek's router, "
                             "bias, scale and shared experts run on the dropless path")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one instance per assigned arch)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    moe: MoESpec | None = None
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    local_window: int = 2048
    lru_width: int = 0  # 0 -> d_model
    # --- positional encoding ---
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # qwen2-vl t/h/w split
    # --- latent attention (MLA, DeepSeek-V2/V3; port-only, 0 = off) ---
    kv_lora_rank: int = 0  # the cached latent's width
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0  # the rotated part of q and the shared rope key
    v_head_dim: int = 0
    # --- leading dense layers before the MoE layers (port-only) ---
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0
    # --- modality frontend (STUB per assignment: precomputed embeddings) ---
    modality: str = "text"  # text | audio | vision
    # --- numerics / execution ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # Activation checkpointing. 'full' (remat each layer, save only layer
    # boundaries) is the production default: 'dots' keeps every matmul
    # output alive — including flash-attention score tiles — and costs
    # ~10x the activation memory at 4k sequence length (see §Perf).
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True  # lax.scan over layer-stacked params
    tie_embeddings: bool = False
    source: str = ""  # provenance tag from the assignment table

    def __post_init__(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoESpec")
        if self.mla and self.family != "moe":
            raise ValueError("latent attention is built for the moe family")

    @property
    def mla(self) -> bool:
        """Latent attention (MLA) in place of GQA."""
        return self.kv_lora_rank > 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is bounded (long_500k applicability)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND FLOPs.
        A latent-attention config counts every leaf of its tree, norms
        included (its published total does)."""
        if self.mla:
            return self._mla_param_count(active=False)
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        if self.family == "ssm":
            di = self.ssm_expand * self.d_model
            nh = di // self.ssm_head_dim
            per_layer = (
                d * (2 * di + 2 * self.ssm_state + nh)  # in_proj (x,z,B,C,dt)
                + self.ssm_conv * (di + 2 * self.ssm_state)
                + di * d  # out_proj
                + 2 * nh  # A, D
            )
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = d * w * 2 + w * d + 3 * w + 2 * (w * w // 8)  # rg-lru gates (block-diag 8)
            mlp = 3 * d * self.d_ff
            n_attn = sum(1 for b in self._pattern() if b == "attn")
            n_rec = self.n_layers - n_attn
            per_layer = 0  # handled below
            blocks = n_rec * (rec + mlp) + n_attn * (attn + mlp)
            return emb + blocks
        elif self.family == "moe":
            assert self.moe is not None
            router = d * self.moe.n_experts
            experts = self.moe.n_experts * 3 * d * self.d_ff
            per_layer = attn + router + experts
        else:
            per_layer = attn + 3 * d * self.d_ff
        n_layers = self.n_layers + self.enc_layers
        if self.family == "encdec":
            # decoder layers add cross-attention
            per_layer_dec = per_layer + attn
            return emb + self.enc_layers * per_layer + self.n_layers * per_layer_dec
        return emb + n_layers * per_layer

    def _mla_param_count(self, *, active: bool) -> int:
        """Every leaf of a latent-attention model's tree (``active``: of
        the routed experts only the top k)."""
        assert self.moe is not None
        d, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        attn = (d * H * qk + d * (r + self.qk_rope_head_dim) + r
                + r * H * (self.qk_nope_head_dim + self.v_head_dim) + H * self.v_head_dim * d)
        norms = 2 * d
        n_moe = self.n_layers - self.first_dense_layers
        E, F = self.moe.n_experts, self.d_ff
        routed = (self.moe.top_k if active else E) * 3 * d * F
        moe = (d * E + routed + 3 * d * self.moe.n_shared * F
               + (E if self.moe.correction_bias else 0))
        dense = 3 * d * self.dense_d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2) + d  # and the final norm
        return (emb + self.n_layers * (attn + norms) + self.first_dense_layers * dense
                + n_moe * moe)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        if self.mla:
            return self._mla_param_count(active=True)
        if self.family != "moe":
            return self.param_count()
        assert self.moe is not None
        d = self.d_model
        total = self.param_count()
        experts_all = self.n_layers * self.moe.n_experts * 3 * d * self.d_ff
        experts_active = self.n_layers * self.moe.top_k * 3 * d * self.d_ff
        return total - experts_all + experts_active

    def _pattern(self) -> tuple[str, ...]:
        if not self.block_pattern:
            return ()
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind for hybrid models; uniform otherwise."""
        if self.family == "hybrid":
            return self._pattern()
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        return ("attn",) * self.n_layers

    def reduced(self) -> "ModelConfig":
        """Same-family tiny twin for CPU smoke tests.  A latent-attention
        config keeps every mechanism at tiny widths: one dense layer, then
        two MoE layers of 4 experts with a shared expert and its router."""
        if self.mla:
            return self._mla_reduced()
        kw: dict = dict(
            name=self.name + "-reduced",
            family=self.family,
            n_layers=min(self.n_layers, 3 if self.family != "hybrid" else 3),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=512,
            head_dim=16,
            qkv_bias=self.qkv_bias,
            moe=MoESpec(4, min(self.moe.top_k, 2)) if self.moe else None,
            ssm_state=16 if self.ssm_state else 0,
            ssm_expand=self.ssm_expand,
            ssm_head_dim=16,
            ssm_conv=self.ssm_conv,
            ssm_chunk=16,
            block_pattern=self.block_pattern,
            local_window=16,
            lru_width=64 if self.lru_width else 0,
            rope=self.rope,
            rope_theta=self.rope_theta,
            mrope_sections=(2, 3, 3) if self.rope == "mrope" else self.mrope_sections,
            enc_layers=min(self.enc_layers, 2),
            modality=self.modality,
            norm_eps=self.norm_eps,
            dtype="float32",
            remat="none",
            scan_layers=self.scan_layers,
            tie_embeddings=self.tie_embeddings,
            source=self.source,
        )
        return ModelConfig(**kw)

    def _mla_reduced(self) -> "ModelConfig":
        assert self.moe is not None
        moe = dataclasses.replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                                  n_shared=min(self.moe.n_shared, 1))
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=32, vocab=512, moe=moe, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, first_dense_layers=1, dense_d_ff=96,
            dtype="float32", remat="none")


ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in ARCH_REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCH_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}"
        ) from None


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)
