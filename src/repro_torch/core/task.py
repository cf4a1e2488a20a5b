"""Task model for PADPS-FR (paper §II, Table I/II).

A periodic hardware task ``T_i = [p_i, td_i, nv_i, II_i, {th_ij}, {pw_ij}]``:
period, input data volume, number of variants, initialization interval, and
per-variant throughput / power.  A *variant* is one hardware realisation of
the task with ``j`` parallel computation units (CUs); on the TPU fleet a
variant is a (chips, sharding) realisation of a compiled step function.

Shares follow eq. 5:  ``shr_ij = td_i / (th_ij * p_i) * t_slr``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "TaskVariant",
    "Task",
    "DeviceProfile",
    "FleetSpec",
    "TaskSetCombo",
    "combo_count",
    "validate_tasks",
    "worst_case_survivor_indices",
]


def worst_case_survivor_indices(
    t_slr: np.ndarray, t_cfg: np.ndarray, k: int
) -> np.ndarray:
    """Ascending indices of the devices left alive by the worst ``k`` failures.

    The adversary removes the ``k`` devices whose loss hurts most: the
    largest-capacity ones, breaking capacity ties toward the cheaper
    reconfiguration cost (so the survivors keep the expensive-cfg
    devices), then toward the lowest index.  Deterministic and a function
    of the fleet alone — never of the candidate row — so resilience
    verdicts keep the reject-monotonicity the replanner relies on.  On a
    homogeneous fleet every k-subset of survivors is equivalent, so the
    worst case is exact; on heterogeneous fleets it is the documented
    adversary the guarantee is verified against.
    """
    t_slr = np.asarray(t_slr, dtype=np.float64)
    t_cfg = np.asarray(t_cfg, dtype=np.float64)
    n_f = t_slr.shape[0]
    if not 0 <= k < n_f:
        raise ValueError(f"resilience must satisfy 0 <= k < n_f={n_f}, got {k}")
    if k == 0:
        return np.arange(n_f)
    order = np.lexsort((np.arange(n_f), t_cfg, -t_slr))
    return np.sort(order[k:])


@dataclasses.dataclass(frozen=True)
class TaskVariant:
    """One hardware realisation of a task.

    ``cu`` is the number of parallel computation units (paper) or the
    parallelism degree of the compiled program (TPU adaptation).
    ``throughput`` is in data-units per time-unit (GB/ms in Table I,
    KB/ms in Table II, bytes/s for TPU jobs); ``power`` in mW (paper)
    or W (TPU).  ``program`` optionally names the pre-generated artifact
    (xclbin in the paper; an AOT-compiled executable key here).
    """

    cu: int
    throughput: float
    power: float
    program: str = ""

    def __post_init__(self) -> None:
        if self.throughput <= 0:
            raise ValueError(f"variant throughput must be > 0, got {self.throughput}")
        if self.power < 0:
            raise ValueError(f"variant power must be >= 0, got {self.power}")


@dataclasses.dataclass(frozen=True)
class Task:
    """A periodic hardware task (paper §II)."""

    name: str
    period: float  # p_i — completion-time requirement
    data: float  # td_i — input data volume per period
    init_interval: float  # II_i — warm-up before the task produces data
    variants: tuple[TaskVariant, ...]

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError(f"{self.name}: period must be > 0")
        if self.data <= 0:
            raise ValueError(f"{self.name}: data must be > 0")
        if self.init_interval < 0:
            raise ValueError(f"{self.name}: init_interval must be >= 0")
        if not self.variants:
            raise ValueError(f"{self.name}: at least one variant required")

    @property
    def nv(self) -> int:
        return len(self.variants)

    def exec_times(self) -> np.ndarray:
        """e_ij = td_i / th_ij (eq. 2-4)."""
        return np.asarray([self.data / v.throughput for v in self.variants], dtype=np.float64)

    def shares(self, t_slr: float) -> np.ndarray:
        """shr_ij = td_i / (th_ij * p_i) * t_slr (eq. 5)."""
        return self.exec_times() / self.period * t_slr

    def powers(self) -> np.ndarray:
        return np.asarray([v.power for v in self.variants], dtype=np.float64)

    def weight(self, j: int) -> float:
        """Task weight e_ij / p_i of variant ``j`` (DP-Fair weight)."""
        return (self.data / self.variants[j].throughput) / self.period


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One fleet device: its slice capacity, reconfiguration overhead and
    hardware class.

    The source paper assumes a homogeneous FPGA fleet; real data-center
    fleets mix FPGAs (large ``t_cfg`` — full/partial bitstream load),
    GPUs and CPUs (``t_cfg`` ~ 0 — a kernel/program launch), and devices
    of differing effective capacity (arXiv:1908.06519, arXiv:2304.04488).
    """

    t_slr: float
    t_cfg: float
    klass: str = "fpga"

    def __post_init__(self) -> None:
        if self.t_slr <= 0:
            raise ValueError("device t_slr must be > 0")
        if self.t_cfg < 0:
            raise ValueError("device t_cfg must be >= 0")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The schedulable fleet (paper §II, generalised to heterogeneity).

    Homogeneous form (the paper's): ``n_f`` devices, time slice ``t_slr``,
    reconfiguration overhead ``t_cfg``.  Heterogeneous form: per-device
    :class:`DeviceProfile` tuples built with :meth:`heterogeneous`; the
    scalar ``t_slr`` then serves as the *reference* slice used by eq. 5
    shares (``shr_ij = e_ij / p_i * t_slr``) while each device ``j``
    contributes its own capacity ``t_slr_j`` and pays its own ``t_cfg_j``.

    On the TPU adaptation a *device* is a pod slice and ``t_cfg`` is the
    program-switch cost (executable load + weight resharding).
    """

    n_f: int
    t_slr: float
    t_cfg: float
    name: str = "fleet"
    devices: tuple[DeviceProfile, ...] = ()

    def __post_init__(self) -> None:
        if self.n_f < 1:
            raise ValueError("n_f must be >= 1")
        if self.t_slr <= 0:
            raise ValueError("t_slr must be > 0")
        if self.t_cfg < 0:
            raise ValueError("t_cfg must be >= 0")
        if self.devices and len(self.devices) != self.n_f:
            raise ValueError(
                f"devices has {len(self.devices)} profiles but n_f={self.n_f}"
            )

    @classmethod
    def heterogeneous(
        cls, devices: Sequence[DeviceProfile], *, name: str = "hetero-fleet"
    ) -> "FleetSpec":
        """Fleet from per-device profiles; reference t_slr is the maximum
        device slice (shares are defined against the largest device)."""
        devices = tuple(devices)
        if not devices:
            raise ValueError("at least one device profile required")
        return cls(
            n_f=len(devices),
            t_slr=max(d.t_slr for d in devices),
            t_cfg=max(d.t_cfg for d in devices),
            name=name,
            devices=devices,
        )

    @property
    def is_heterogeneous(self) -> bool:
        return bool(self.devices)

    def profile(self, j: int) -> DeviceProfile:
        if self.devices:
            return self.devices[j]
        return DeviceProfile(t_slr=self.t_slr, t_cfg=self.t_cfg)

    def t_slr_of(self, j: int) -> float:
        return self.devices[j].t_slr if self.devices else self.t_slr

    def t_cfg_of(self, j: int) -> float:
        return self.devices[j].t_cfg if self.devices else self.t_cfg

    @property
    def t_slr_arr(self) -> np.ndarray:
        """Per-device capacities ``t_slr_j`` as an (n_f,) float64 array."""
        if self.devices:
            return np.asarray([d.t_slr for d in self.devices], dtype=np.float64)
        return np.full(self.n_f, self.t_slr, dtype=np.float64)

    @property
    def t_cfg_arr(self) -> np.ndarray:
        """Per-device reconfiguration costs ``t_cfg_j`` as (n_f,) float64."""
        if self.devices:
            return np.asarray([d.t_cfg for d in self.devices], dtype=np.float64)
        return np.full(self.n_f, self.t_cfg, dtype=np.float64)

    @property
    def t_cfg_min(self) -> float:
        return min(d.t_cfg for d in self.devices) if self.devices else self.t_cfg

    @property
    def t_cfg_max(self) -> float:
        return max(d.t_cfg for d in self.devices) if self.devices else self.t_cfg

    @property
    def capacity(self) -> float:
        """Total HPC capacity per slice: sum_j t_slr_j (eq. 6 RHS)."""
        if self.devices:
            return float(sum(d.t_slr for d in self.devices))
        return self.t_slr * self.n_f

    def workable_budget(self, n_t: int, extra_cfgs: int = 1) -> float:
        """RHS of the workability condition eq. 7.

        The paper's eq. 7 text charges ``n_t * t_cfg`` (one configuration
        per task), but its published counts (620 TFS in Example 1, 6 in
        Example 3) only emerge from ``(n_t + 1) * t_cfg`` — one extra
        reconfiguration for the DP-wrap split task (Fig 2 indeed shows 7
        configurations for 6 tasks).  We default to the implemented
        condition (``extra_cfgs=1``) and expose the knob; the discrepancy
        is documented in EXPERIMENTS.md.

        Heterogeneous fleets charge the *minimum* per-device ``t_cfg`` —
        the loosest reading of eq. 7, so the heterogeneous pre-filter
        rejects no combo the paper's homogeneous charge would keep (a
        combo Alg 2 could still place on the cheap-cfg devices must not
        be pre-rejected); the tighter per-class refinement lives in
        :func:`repro_torch.core.feasibility.config_overhead_lower_bound`.
        """
        return self.capacity - (n_t + extra_cfgs) * self.t_cfg_min

    def survivors(self, k: int) -> "FleetSpec":
        """Worst-case surviving fleet after any ``k`` device failures.

        This is the backup fleet the resilience mode verifies against
        (see :func:`worst_case_survivor_indices` for the adversary).  The
        reference ``t_slr``/``t_cfg`` scalars are preserved so eq-5
        shares stay defined against the original fleet; only the device
        set shrinks.  ``k=0`` returns ``self``; ``k >= n_f`` is a
        ``ValueError`` — no plan survives losing every device.
        """
        k = int(k)
        if not 0 <= k < self.n_f:
            raise ValueError(
                f"resilience must satisfy 0 <= k < n_f={self.n_f}, got {k}"
            )
        if k == 0:
            return self
        if not self.devices:
            return dataclasses.replace(self, n_f=self.n_f - k)
        keep = worst_case_survivor_indices(self.t_slr_arr, self.t_cfg_arr, k)
        return dataclasses.replace(
            self,
            n_f=self.n_f - k,
            devices=tuple(self.devices[int(j)] for j in keep),
        )

    def with_devices(self, n_f: int) -> "FleetSpec":
        """Resize the fleet.  Heterogeneous fleets repeat their device
        pattern round-robin (the sweep semantics of Figs 5-7)."""
        if not self.devices:
            return dataclasses.replace(self, n_f=n_f)
        profiles = tuple(self.devices[j % len(self.devices)] for j in range(n_f))
        return dataclasses.replace(self, n_f=n_f, devices=profiles)

    def with_t_cfg(self, t_cfg: float) -> "FleetSpec":
        """Rescale reconfiguration cost (the Fig 5-7 t_cfg sweeps).
        Heterogeneous device cfgs scale proportionally to preserve the
        class mix (a GPU's ~0 cfg stays ~0).  A heterogeneous fleet whose
        devices all reconfigure for free has nothing to rescale and is
        returned unchanged."""
        if not self.devices:
            return dataclasses.replace(self, t_cfg=t_cfg)
        if self.t_cfg == 0:
            return self
        scale = t_cfg / self.t_cfg
        profiles = tuple(
            dataclasses.replace(d, t_cfg=d.t_cfg * scale) for d in self.devices
        )
        return dataclasses.replace(self, t_cfg=t_cfg, devices=profiles)


@dataclasses.dataclass(frozen=True)
class TaskSetCombo:
    """One row of the TSS list: a choice of variant index per task."""

    variant_idx: tuple[int, ...]
    shares: tuple[float, ...]
    powers: tuple[float, ...]

    @property
    def sum_shr(self) -> float:
        return float(sum(self.shares))

    @property
    def total_power(self) -> float:
        return float(sum(self.powers))

    def describe(self, tasks: Sequence[Task]) -> str:
        parts = []
        for t, j, s in zip(tasks, self.variant_idx, self.shares, strict=True):
            parts.append(f"{t.variants[j].cu}CU-{t.name}(shr={s:g})")
        return ", ".join(parts)


def validate_tasks(tasks: Iterable[Task]) -> None:
    names = [t.name for t in tasks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate task names: {names}")


def combo_count(tasks: Sequence[Task]) -> int:
    """|TSS| = prod(nv_i)."""
    return int(math.prod(t.nv for t in tasks))
