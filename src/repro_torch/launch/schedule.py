"""Fleet-level power-aware scheduling: the paper's scheduler placing ML jobs.

Takes a fleet spec (slices x chips) and a job list (arch x shape x
period); generates parallelism variants for every job (throughput and
power from the analytic roofline and power model), runs PADPS-FR, and
prints the placement plan: a timeline a slice with program switches,
warm-ups and batch splits.

  PYTHONPATH=src python -m repro_torch.launch.schedule \\
      --slices 4 --slice-chips 64 --t-slr 3600 --t-cfg 45 \\
      --job yi-34b:train_4k:1800:900 --job smollm-135m:decode_32k:600:5000

The flags are the JAX package's ``launch/schedule.py``'s, plus ``--engine``:
``cuda`` (the default) runs the Alg-2 placement sweep on the card and
raises without one; ``torch`` runs its plain version on the CPU.
"""

from __future__ import annotations

import argparse

from ..configs import get_arch
from ..configs.shapes import get_shape
from ..core import FleetSpec, PADPSFRScheduler, render_gantt
from ..core.variants import JobSpec, make_task

__all__ = ["main", "parse_job", "plan_fleet"]


def parse_job(spec: str) -> JobSpec:
    """arch:shape:period_s:steps  e.g. yi-34b:train_4k:1800:900"""
    arch, shape, period, steps = spec.split(":")
    return JobSpec(
        cfg=get_arch(arch),
        shape=get_shape(shape),
        period_s=float(period),
        steps_per_period=int(steps),
    )


def plan_fleet(jobs, fleet: FleetSpec, chip_options=(32, 64, 128, 256), *,
               engine: str = "cuda"):
    """(tasks, ScheduleResult) of ``jobs`` on ``fleet``; ``engine`` picks the
    placement backend (``"cuda"``: kernel 1 on the card)."""
    tasks = [make_task(j, chip_options) for j in jobs]
    sched = PADPSFRScheduler(fleet, engine=engine)
    return tasks, sched.schedule(tasks, count_all_rejects=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slices", type=int, default=4, help="n_f schedulable slices")
    ap.add_argument("--slice-chips", type=int, default=64)
    ap.add_argument("--t-slr", type=float, default=3600.0, help="time slice (s)")
    ap.add_argument(
        "--t-cfg", type=float, default=45.0,
        help="program-switch cost (s): executable load + weight restore",
    )
    ap.add_argument(
        "--job", action="append", required=True,
        help="arch:shape:period_s:steps (repeatable)",
    )
    ap.add_argument(
        "--engine", default="cuda",
        help="placement engine: cuda (default; raises without a card), torch or scalar",
    )
    args = ap.parse_args(argv)

    jobs = [parse_job(j) for j in args.job]
    fleet = FleetSpec(n_f=args.slices, t_slr=args.t_slr, t_cfg=args.t_cfg, name="tpu-fleet")
    chip_opts = tuple(
        sorted({args.slice_chips // 4, args.slice_chips // 2, args.slice_chips})
    )
    tasks, result = plan_fleet(jobs, fleet, chip_opts, engine=args.engine)

    print(f"fleet: {args.slices} slices x {args.slice_chips} chips, "
          f"t_slr={args.t_slr:g}s t_cfg={args.t_cfg:g}s")
    for t in tasks:
        vs = ", ".join(
            f"{v.cu}ch:{v.throughput:.3g}st/s/{v.power:.0f}W" for v in t.variants
        )
        print(f"  job {t.name}: period={t.period:g}s steps={t.data:g} [{vs}]")
    print()
    print(result.summary(tasks))
    if result.feasible:
        print(render_gantt(result.plan, tasks, fleet))
    return 0 if result.feasible else 1


if __name__ == "__main__":
    raise SystemExit(main())
