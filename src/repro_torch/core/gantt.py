"""ASCII Gantt rendering of placement plans (reproduces Figs 2-4 as text)."""

from __future__ import annotations

from typing import Sequence

from .placement import PlacementPlan
from .task import FleetSpec, Task

__all__ = ["render_gantt", "plan_rows"]


def plan_rows(
    plan: PlacementPlan, tasks: Sequence[Task]
) -> list[list[tuple[str, float, float]]]:
    """Per device: list of (label, start, end)."""
    rows = []
    for script in plan.scripts:
        row = []
        for seg in script.segments:
            if seg.kind == "null":
                label = "NULL"
            elif seg.kind == "cfg":
                label = f"cfg:{tasks[seg.task].name}"
            elif seg.kind == "init":
                label = f"II:{tasks[seg.task].name}"
            else:
                label = tasks[seg.task].name
            row.append((label, seg.start, seg.end))
        rows.append(row)
    return rows


def render_gantt(
    plan: PlacementPlan,
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    width: int = 96,
) -> str:
    """Fixed-width ASCII Gantt chart, one row per device.

    Heterogeneous fleets render each device's row to its own ``t_slr_j``
    (shorter devices end early, annotated with their class)."""
    scale = width / max(fleet.t_slr_of(j) for j in range(fleet.n_f))
    if fleet.is_heterogeneous:
        mix = ",".join(
            f"F{j + 1}:{fleet.profile(j).klass}(t_slr={fleet.t_slr_of(j):g},"
            f"t_cfg={fleet.t_cfg_of(j):g})"
            for j in range(fleet.n_f)
        )
        lines = [f"heterogeneous fleet n_f={fleet.n_f}: {mix}"]
    else:
        lines = [
            f"time slice t_slr={fleet.t_slr:g}, t_cfg={fleet.t_cfg:g}, n_f={fleet.n_f}"
        ]
    for dev, row in enumerate(plan_rows(plan, tasks)):
        cells = []
        for label, s, e in row:
            w = max(1, int(round((e - s) * scale)))
            txt = label[: w - 1] if w > 1 else ""
            cells.append(f"|{txt:<{w - 1}}" if w > 1 else "|")
        tag = f"F{dev + 1}"
        if fleet.is_heterogeneous:
            tag += f"[{fleet.profile(dev).klass[0]}]"
        lines.append(f"{tag} " + "".join(cells) + "|")
    if plan.splits:
        for sp in plan.splits:
            ratio = ":".join(f"{r:.3g}" for r in sp.ratio)
            devs = ",".join(f"F{d + 1}" for d in sp.devices)
            parts = ":".join(f"{p:g}" for p in sp.share_parts)
            lines.append(
                f"split {tasks[sp.task].name}: share {parts} across {devs} "
                f"-> input data ratio {ratio}"
            )
    if not plan.feasible:
        un = ",".join(tasks[k].name for k in plan.unplaced)
        lines.append(f"INFEASIBLE — unplaced: {un}")
    return "\n".join(lines)
