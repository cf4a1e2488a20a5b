"""The paper's own task sets — Tables I and II, Examples 1/2/3 (§IV-A).

Shipped as configs so the reproduction tests and benchmarks consume the
exact published numbers.

Power columns in Table I are truncated in the PDF ("5, 6, 7," ...); the
visible ascending-by-CU pattern fixes the missing last entries (T2: 8,
T3: 9, T4: 6).  These values do not affect the TFS/TNFS counts (only
shares enter eq. 7) and reproduce the paper's selected combination.
"""

from __future__ import annotations

from ..core.task import FleetSpec, Task, TaskVariant

__all__ = [
    "example1_tasks",
    "example1_fleet",
    "example2_tasks",
    "example2_fleet",
    "example3_tasks",
    "example3_fleet",
]


def _task(name, p, ii, td, ths, pws):
    return Task(
        name=name,
        period=p,
        data=td,
        init_interval=ii,
        variants=tuple(
            TaskVariant(cu=j + 1, throughput=th, power=pw, program=f"{name}_{j + 1}cu.xclbin")
            for j, (th, pw) in enumerate(zip(ths, pws, strict=True))
        ),
    )


def example1_tasks() -> tuple[Task, ...]:
    """Table I.  t in ms, data in GB, throughput GB/ms, power mW."""
    return (
        _task("T1", 60, 2, 24, [0.5, 1.0], [5, 6]),
        _task("T2", 60, 4, 18, [0.5, 1.0, 1.5, 2.0], [5, 6, 7, 8]),
        _task("T3", 60, 2, 48, [1.0, 2.0, 3.0, 4.0], [6, 7, 8, 9]),
        _task("T4", 90, 4, 36, [0.25, 0.5, 0.75, 1.0], [3, 4, 5, 6]),
        _task("T5", 90, 6, 72, [1.0, 2.0, 3.0, 4.0], [4, 4.5, 5, 5.5]),
        _task("T6", 90, 6, 72, [1.0, 2.0], [4, 5]),
    )


def example1_fleet() -> FleetSpec:
    return FleetSpec(n_f=4, t_slr=60.0, t_cfg=6.0, name="example1")


def example2_tasks() -> tuple[Task, ...]:
    """Example 2 = Example 1 with II(T3): 2 -> 12 ms (§IV-A2)."""
    tasks = list(example1_tasks())
    t3 = tasks[2]
    tasks[2] = Task(
        name=t3.name,
        period=t3.period,
        data=t3.data,
        init_interval=12.0,
        variants=t3.variants,
    )
    return tuple(tasks)


def example2_fleet() -> FleetSpec:
    return example1_fleet()


def example3_tasks() -> tuple[Task, ...]:
    """Table II.  t in ms, data in KB, throughput KB/ms, power mW.

    LZ-4 / ZSTD are the Vitis lossless-compression kernels, VAdd vector
    addition; xclbins pre-generated per variant (1-3 CU LZ4, 1-2 CU ZSTD,
    1-4 CU VAdd).
    """
    return (
        _task("LZ-4", 600, 2, 107375, [129.37, 165.29, 198.84], [6.38, 6.55, 6.64]),
        _task("ZSTD", 600, 2, 107375, [244.03, 255.65], [6.89, 7.06]),
        _task("VAdd", 600, 2, 19, [0.12, 0.16, 0.18, 0.2], [6.12, 6.21, 6.38, 6.55]),
    )


def example3_fleet() -> FleetSpec:
    return FleetSpec(n_f=2, t_slr=600.0, t_cfg=21.0, name="example3-alveo50")
