"""Power model and analytic roofline throughput for ML-job task variants.

The paper characterises each task variant by a measured (throughput,
power) pair on synthesized bitstreams (Tables I/II).  For ML jobs on an
accelerator fleet both come from an analytic model over the quantities a
roofline uses, the FLOPs, memory bytes and collective bytes of one step:

    t_step  = max(compute term, memory term, collective term)
    power   = n_chips * (idle + e_flop * flops/s + e_hbm * B/s + e_ici * B/s)

:data:`V5E` is the JAX package's modelled fleet chip, carried here as data
so that the port's variant tables equal the reference's exactly; its
figures describe that modelled fleet, not the device this package runs
on.  The scheduler is agnostic to where the (throughput, power) tables come
from: the paper's own tables ship as configs.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "TPUSpec",
    "V5E",
    "PowerModel",
    "step_time_roofline",
    "DeviceClass",
    "DEVICE_CLASSES",
    "FPGA_CLASS",
    "GPU_CLASS",
    "CPU_CLASS",
    "TPU_CLASS",
]


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    name: str
    peak_flops: float  # FLOP/s bf16 per chip
    hbm_bw: float  # B/s per chip
    ici_bw: float  # B/s per link
    hbm_bytes: float  # HBM capacity per chip


V5E = TPUSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
)


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """A fleet device class for heterogeneous scheduling (arXiv:2304.04488).

    ``t_cfg_frac`` is the class's program-switch cost as a *fraction of
    the fleet's reference slice* ``t_slr``: unit-free, so one class table
    serves the paper's millisecond fleets and second-scale accelerator
    fleets alike.  FPGAs pay a full or partial bitstream (re)configuration
    (the paper's Example 1 charges 6/60 = 0.1 of the slice; Example 3's
    Alveo fleet 21/600 = 0.035), GPUs and CPUs only a kernel or process
    launch (~0), accelerator slices an executable load and weight
    resharding (45 s against a 3600 s slice = 0.0125).
    ``capacity_scale`` derates the device's effective slice capacity
    relative to the fleet's reference ``t_slr`` (the "effective capacity"
    axis of arXiv:1908.06519: a CPU does the same share's work slower).
    ``idle_w`` feeds fleet-level idle-power accounting.
    """

    name: str
    t_cfg_frac: float
    capacity_scale: float = 1.0
    idle_w: float = 75.0

    def __post_init__(self) -> None:
        if self.t_cfg_frac < 0:
            raise ValueError("t_cfg_frac must be >= 0")
        if not (0 < self.capacity_scale <= 1.0):
            raise ValueError("capacity_scale must be in (0, 1]")


FPGA_CLASS = DeviceClass(name="fpga", t_cfg_frac=0.1, capacity_scale=1.0, idle_w=40.0)
GPU_CLASS = DeviceClass(name="gpu", t_cfg_frac=0.001, capacity_scale=0.9, idle_w=90.0)
CPU_CLASS = DeviceClass(name="cpu", t_cfg_frac=0.0, capacity_scale=0.35, idle_w=60.0)
TPU_CLASS = DeviceClass(name="tpu", t_cfg_frac=0.0125, capacity_scale=1.0, idle_w=75.0)

DEVICE_CLASSES = {c.name: c for c in (FPGA_CLASS, GPU_CLASS, CPU_CLASS, TPU_CLASS)}


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Energy model: P(chip) = idle + e_flop*F/s + e_hbm*B/s + e_ici*B/s."""

    idle_w: float = 75.0
    e_flop: float = 0.51e-12  # J/FLOP
    e_hbm: float = 30e-12  # J/B
    e_ici: float = 10e-12  # J/B

    def chip_power(self, flops_per_s: float, hbm_Bps: float, ici_Bps: float) -> float:
        return (
            self.idle_w
            + self.e_flop * flops_per_s
            + self.e_hbm * hbm_Bps
            + self.e_ici * ici_Bps
        )

    def job_power(
        self,
        n_chips: int,
        step_time_s: float,
        flops: float,
        hbm_bytes: float,
        ici_bytes: float,
    ) -> float:
        """Total W while the job runs (per-chip quantities / step)."""
        if step_time_s <= 0:
            return n_chips * self.idle_w
        per_chip = self.chip_power(
            flops / n_chips / step_time_s,
            hbm_bytes / n_chips / step_time_s,
            ici_bytes / n_chips / step_time_s,
        )
        return n_chips * per_chip


def step_time_roofline(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    n_chips: int,
    spec: TPUSpec = V5E,
    *,
    links_per_chip: int = 4,
) -> tuple[float, dict[str, float]]:
    """Roofline step time = max of the three terms (seconds) + the terms."""
    compute = flops / (n_chips * spec.peak_flops)
    memory = hbm_bytes / (n_chips * spec.hbm_bw)
    collective = coll_bytes / (n_chips * links_per_chip * spec.ici_bw)
    terms = {"compute": compute, "memory": memory, "collective": collective}
    return max(terms.values()), terms
