"""The control's lower precision: float8 (e4m3) rounding of a product's
operands, each scaled by its absolute maximum (an activation a row at a
time, a weight as one tensor), as an fp8 serving path would run the
products that the configuration states in bfloat16."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor, *, rows: bool) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale and widened back to float32."""
    amax = x.abs().amax(dim=-1, keepdim=True) if rows else x.abs().amax()
    scale = (amax / E4M3_MAX).clamp_min(1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
