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
]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    # capacity factor for expert dispatch buffers (tokens per expert =
    # tokens * top_k / n_experts * capacity)
    capacity: float = 1.25


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
        """Analytic parameter count (embeddings + blocks), for 6ND FLOPs."""
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

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
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
        """Same-family tiny twin for CPU smoke tests."""
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
