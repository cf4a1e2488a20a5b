"""Parallelism-variant generation: ML jobs -> PADPS-FR tasks.

The paper's variants are "j parallel CUs in one FPGA"; for an ML job they
are "an ``n_chips``-chip slice".  For each (architecture x input shape)
job the variant table (throughput, power) comes from the analytic roofline
and power model of :mod:`repro_torch.core.power`, and :func:`make_task`
emits a :class:`repro_torch.core.task.Task` that the unchanged PADPS-FR
algorithms schedule: the paper's scheduler doing real work.

Analytic per-step costs (documented approximations):

* train:   FLOPs = 6 * N_active * tokens  (fwd+bwd), HBM = params read
           + grads + optimizer traffic + activation spill, collectives =
           grad all-reduce (2 * P bytes ring) over the DP axes.
* prefill: FLOPs = 2 * N_active * tokens + attention quadratic term.
* decode:  FLOPs = 2 * N_active * batch; HBM dominated by weights + KV
           cache read per token; collectives = TP all-reduces.

The arithmetic is Python floats in the JAX package's order, so the tables
equal the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import math

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from .power import DEVICE_CLASSES, V5E, DeviceClass, PowerModel, TPUSpec, step_time_roofline
from .task import DeviceProfile, FleetSpec, Task, TaskVariant

__all__ = [
    "JobSpec",
    "job_costs",
    "make_task",
    "variant_table",
    "make_hetero_fleet",
]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A periodic ML job: run `shape` for `arch` every `period_s` seconds,
    processing `steps_per_period` steps."""

    cfg: ModelConfig
    shape: InputShape
    period_s: float
    steps_per_period: int = 1
    name: str = ""

    @property
    def job_name(self) -> str:
        return self.name or f"{self.cfg.name}:{self.shape.name}"


def _bytes_per_param(kind: str) -> float:
    # bf16 weights; training adds f32 grads + AdamW moments traffic
    return 2.0 if kind != "train" else 2.0 + 4.0 + 8.0


def job_costs(cfg: ModelConfig, shape: InputShape) -> dict[str, float]:
    """Per-step analytic (FLOPs, HBM bytes, collective bytes at 1 chip).

    Collective bytes returned separately as per-replica ring volume:
    gradient all-reduce 2*P*4 bytes (f32) for train; TP activation
    reductions approximated as 2 * tokens * d_model * 2 bytes * L.
    """
    N = cfg.active_param_count()
    P = cfg.param_count()
    tokens = shape.tokens
    L = cfg.n_layers + cfg.enc_layers
    d = cfg.d_model
    kind = shape.kind

    if kind == "train":
        flops = 6.0 * N * tokens
    else:
        flops = 2.0 * N * tokens
    # attention quadratic term (full-attention archs; window for hybrid)
    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    if cfg.family not in ("ssm",):
        ctx = min(shape.seq_len, cfg.local_window) if cfg.family == "hybrid" else shape.seq_len
        if kind == "decode":
            att = 2.0 * 2.0 * shape.global_batch * ctx * H * hd * (L if cfg.family != "hybrid" else L / 3)
        else:
            att = 2.0 * 2.0 * tokens * ctx * H * hd * (L if cfg.family != "hybrid" else L / 3)
            att *= 0.5  # causal
            if kind == "train":
                att *= 3.0  # fwd + bwd recompute
        flops += att

    hbm = P * _bytes_per_param(kind)
    if kind == "decode":
        # KV cache read per decoded token
        kv_bytes = (
            2.0 * L * shape.global_batch * shape.seq_len * cfg.n_kv_heads * hd * 2.0
            if cfg.family not in ("ssm", "hybrid")
            else 2.0 * L * shape.global_batch * (cfg.ssm_state * d if cfg.family == "ssm" else cfg.local_window * cfg.n_kv_heads * hd) * 2.0
        )
        hbm += kv_bytes
    else:
        hbm += 2.0 * tokens * d * 2.0 * L  # activation traffic

    if kind == "train":
        coll = 2.0 * P * 4.0  # ring all-reduce of f32 grads
    else:
        coll = 2.0 * tokens * d * 2.0 * math.log2(max(L, 2))  # TP reduces
    return {"flops": flops, "hbm": hbm, "coll": coll}


def variant_table(
    job: JobSpec,
    chip_options: tuple[int, ...] = (32, 64, 128, 256),
    spec: TPUSpec = V5E,
    power: PowerModel | None = None,
) -> list[TaskVariant]:
    """One TaskVariant per slice size, throughput in steps/sec."""
    power = power or PowerModel()
    costs = job_costs(job.cfg, job.shape)
    out = []
    for n in chip_options:
        t_step, _terms = step_time_roofline(
            costs["flops"], costs["hbm"], costs["coll"], n, spec
        )
        # weight-memory feasibility: params (+opt state for train) must fit
        state_bytes = job.cfg.param_count() * (
            2.0 if job.shape.kind != "train" else 2.0 + 4.0 + 8.0
        )
        if state_bytes > n * spec.hbm_bytes * 0.8:
            continue  # this slice size cannot hold the job
        th = 1.0 / t_step  # steps per second
        pw = power.job_power(n, t_step, costs["flops"], costs["hbm"], costs["coll"])
        out.append(TaskVariant(cu=n, throughput=th, power=pw, program=f"{job.job_name}@{n}"))
    return out


def make_hetero_fleet(
    class_counts: dict[str, int] | list[tuple[DeviceClass | str, int]],
    t_slr: float,
    *,
    name: str = "hetero-fleet",
) -> FleetSpec:
    """Build a mixed FPGA/GPU/CPU/TPU fleet from device-class counts.

    Each class contributes ``count`` devices with capacity
    ``t_slr * capacity_scale`` and reconfiguration cost
    ``t_slr * t_cfg_frac`` (:data:`repro_torch.core.power.DEVICE_CLASSES`) —
    both derived from the reference slice, so the class table is
    unit-free (an FPGA costs 0.1 of the slice whether ``t_slr`` is the
    paper's 60 ms or an accelerator fleet's 3600 s).  ``t_slr`` is the fleet's
    reference slice — eq. 5 shares are defined against it, per-device
    capacities derate from it.

    Example — two FPGAs plus one GPU (slightly derated capacity, near-free
    reconfiguration):

        >>> fleet = make_hetero_fleet({"fpga": 2, "gpu": 1}, t_slr=60.0)
        >>> fleet.n_f, [d.klass for d in fleet.devices]
        (3, ['fpga', 'fpga', 'gpu'])
        >>> [(d.t_slr, round(d.t_cfg, 2)) for d in fleet.devices]
        [(60.0, 6.0), (60.0, 6.0), (54.0, 0.06)]
    """
    items = class_counts.items() if isinstance(class_counts, dict) else class_counts
    profiles: list[DeviceProfile] = []
    for klass, count in items:
        dc = DEVICE_CLASSES[klass] if isinstance(klass, str) else klass
        if count < 0:
            raise ValueError(f"{dc.name}: count must be >= 0")
        profiles.extend(
            DeviceProfile(
                t_slr=t_slr * dc.capacity_scale,
                t_cfg=t_slr * dc.t_cfg_frac,
                klass=dc.name,
            )
            for _ in range(count)
        )
    if not profiles:
        raise ValueError("fleet needs at least one device")
    return FleetSpec.heterogeneous(tuple(profiles), name=name)


def make_task(
    job: JobSpec,
    chip_options: tuple[int, ...] = (32, 64, 128, 256),
    spec: TPUSpec = V5E,
    power: PowerModel | None = None,
) -> Task:
    """PADPS-FR task: data volume = steps per period, throughput = steps/s.

    ``init_interval`` models program-switch warm-up (first-step dispatch);
    the fleet's ``t_cfg`` models executable load + weight restore.
    """
    variants = variant_table(job, chip_options, spec, power)
    if not variants:
        raise ValueError(
            f"{job.job_name}: no slice size in {chip_options} fits the job"
        )
    return Task(
        name=job.job_name,
        period=job.period_s,
        data=float(job.steps_per_period),
        init_interval=0.5,  # s — first-step dispatch/warm-up
        variants=tuple(variants),
    )
