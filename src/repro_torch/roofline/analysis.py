"""Three-term roofline from the dry-run.

    compute    = FLOPs            / (chips x peak_FLOP/s)
    memory     = bytes            / (chips x HBM_bw)
    collective = collective_bytes / (chips x links x link_bw)

FLOPs, bytes and collective bytes are those of one device's share of the
step: the port's trace of the step on DTensors (``trace_costs``) or the
JAX package's partitioned HLO module (``hlo_costs``).  Terms are therefore
computed with chips = 1 against per-chip peak numbers — equivalent to the
global formula and robust to mesh size.

Hardware: ``V5E``, the JAX package's modelled fleet (TPU v5e: 197 TFLOP/s
bf16, 819 GB/s HBM, ~50 GB/s/link ICI), carried as data; no term here is
a measurement of any device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from ..core.power import V5E, TPUSpec

__all__ = [
    "CollectiveStats",
    "RooflineResult",
    "collective_bytes",
    "analyze_compiled",
    "roofline_terms",
]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# a collective instruction line:  %name = <shape> <op>(<operands>), ...
_INSTR_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[a-z0-9_]+\[[^\]]*\](?:\{[^}]*\})?)\s*"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\s*\("
)
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class CollectiveStats:
    per_op: dict[str, int]
    per_op_count: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.per_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.per_op_count.values())


def collective_bytes(hlo_text: str) -> CollectiveStats:
    """Operand bytes + counts of every collective in an HLO module dump.

    Delegates to the loop-aware walker (``hlo_costs``): operand shapes
    are resolved through per-computation definition maps (HLO dumps
    reference operands by name), and collectives inside ``while`` bodies
    are multiplied by the loop trip count.
    """
    from .hlo_costs import parse_hlo_costs

    walk = parse_hlo_costs(hlo_text)
    return CollectiveStats(
        per_op={k: int(v) for k, v in walk.coll_bytes.items()},
        per_op_count={k: int(v) for k, v in walk.coll_counts.items()},
    )


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    bytes_per_device_peak: float  # args + peak live temporaries and outputs
    model_flops: float  # 6*N*D (train) / 2*N*D (serve), global
    coll: CollectiveStats | None = None

    # --- the three terms (seconds) ---
    def terms(self, spec: TPUSpec = V5E, links: int = 4) -> dict[str, float]:
        return {
            "compute": self.flops_per_device / spec.peak_flops,
            "memory": self.hbm_bytes_per_device / spec.hbm_bw,
            "collective": self.coll_bytes_per_device / (links * spec.ici_bw),
        }

    def bottleneck(self, spec: TPUSpec = V5E) -> str:
        t = self.terms(spec)
        return max(t, key=t.get)

    def step_time(self, spec: TPUSpec = V5E) -> float:
        return max(self.terms(spec).values())

    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs x chips) — remat/redundancy waste."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    def mfu(self, spec: TPUSpec = V5E) -> float:
        """Model FLOPs utilisation at the roofline step time."""
        t = self.step_time(spec)
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.n_chips * spec.peak_flops)

    def to_row(self) -> dict[str, Any]:
        t = self.terms()
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.n_chips,
            "compute_s": t["compute"],
            "memory_s": t["memory"],
            "collective_s": t["collective"],
            "bottleneck": self.bottleneck(),
            "step_time_s": self.step_time(),
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac(),
            "mfu": self.mfu(),
            "hbm_peak_bytes": self.bytes_per_device_peak,
        }


def _cost_get(cost: dict, key: str) -> float:
    v = cost.get(key, 0.0)
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def analyze_compiled(
    compiled,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    model_flops: float,
    hlo_text: str | None = None,
) -> RooflineResult:
    """Build a RooflineResult from a trace record.

    ``compiled`` is the ``TraceCosts`` that ``trace_costs.count_costs()``
    filled while the step ran (or None); its ``arg_bytes`` and
    ``peak_bytes`` give the per-device peak.  Given ``hlo_text`` (an XLA
    HLO module dump), the costs come from the loop-aware HLO walker
    (``hlo_costs``) instead, as the JAX package takes them.
    """
    from .hlo_costs import parse_hlo_costs

    walk = parse_hlo_costs(hlo_text) if hlo_text is not None else compiled
    flops = walk.flops
    hbm = walk.bytes
    coll = CollectiveStats(
        per_op={k: int(v) for k, v in walk.coll_bytes.items()},
        per_op_count={k: int(v) for k, v in walk.coll_counts.items()},
    )

    peak = compiled.arg_bytes + compiled.peak_bytes if compiled is not None else 0.0

    return RooflineResult(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        coll_bytes_per_device=float(coll.total_bytes),
        bytes_per_device_peak=peak,
        model_flops=model_flops,
        coll=coll,
    )


def roofline_terms(
    flops_per_device: float,
    hbm_per_device: float,
    coll_per_device: float,
    spec: TPUSpec = V5E,
    links: int = 4,
) -> dict[str, float]:
    return {
        "compute": flops_per_device / spec.peak_flops,
        "memory": hbm_per_device / spec.hbm_bw,
        "collective": coll_per_device / (links * spec.ici_bw),
    }
