"""Assigned input shapes (4 per LM arch) and arch x shape applicability.

Pure data, equal to the JAX package's table field for field.
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig

__all__ = ["InputShape", "SHAPES", "get_shape", "cell_applicability", "all_cells"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        """Tokens processed per step (decode: one new token per sequence)."""
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None


def cell_applicability(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason).

    ``long_500k`` needs a bounded decode state, so it runs only for the SSM
    and hybrid archs; a full-attention arch's 512k dense KV cache is the
    excluded quadratic case, recorded as an explicit skip.  No assigned
    arch is encoder-only (seamless is enc-dec: its decoder decodes).
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k decode KV is quadratic-memory; skipped per assignment"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from . import list_archs  # late import to avoid cycle

    return [(a, s) for a in list_archs() for s in SHAPES]
