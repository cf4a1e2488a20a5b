"""Config registry (the assigned architectures) and the paper's task sets.

``base`` holds the :class:`ModelConfig` schema and the registry; the arch
modules below register themselves on import.  ``shapes`` holds the
assigned input shapes and which arch x shape cells run; ``paper_examples``
holds the paper's worked examples (Tables I/II, Examples 1-3).
"""

from __future__ import annotations

from .base import (
    ARCH_REGISTRY,
    PORT_ONLY_ARCHS,
    ModelConfig,
    MoESpec,
    get_arch,
    list_archs,
    register_arch,
)
from .shapes import SHAPES, InputShape, get_shape

# Import for registration side effects.
from . import (  # noqa: F401  isort: skip
    moonshot_v1_16b_a3b,
    dbrx_132b,
    seamless_m4t_large_v2,
    mamba2_130m,
    qwen15_110b,
    deepseek_67b,
    yi_34b,
    smollm_135m,
    qwen2_vl_2b,
    recurrentgemma_2b,
    moonlight_16b_a3b,
)

__all__ = [
    "ARCH_REGISTRY",
    "PORT_ONLY_ARCHS",
    "ModelConfig",
    "MoESpec",
    "get_arch",
    "list_archs",
    "register_arch",
    "SHAPES",
    "InputShape",
    "get_shape",
]
