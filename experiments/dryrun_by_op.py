#!/usr/bin/env python3
"""One dry-run cell's per-device counts, broken down by aten op.

    python3 experiments/dryrun_by_op.py --arch smollm-135m --shape train_4k \
        [--mesh single|multi] [--rules PRESET] [--moe-impl vmap|batched] \
        [--layers N] [--sites] [--out FILE.json] [--against OTHER.json]

Traces the cell as ``repro_torch.launch.dryrun`` does (full width, the
shape's default rules or ``--rules``, ``meta`` shards in a fake 512-rank world; no card)
under ``ByOpMode``, the dry-run's cost counter with a breakdown, and
writes the torch version, the totals (FLOPs, dot FLOPs, bytes, collective
bytes and counts by op, argument bytes, peak live bytes, trace seconds)
and, for each aten op, its count, FLOPs, bytes and the bytes it created
that are live at the peak (DTensor's all-to-all under
``shard_dim_alltoall``).
``--layers`` cuts the depth (stated in the record).  ``--sites`` keys
each op by its call site too (the innermost frames of the port's model,
training and sharding code that ran it; a backward op's, the autograd
node and the frames of the forward op it differentiates).  ``--against`` prints,
op by op, where this trace differs from another one written by this
script (another torch version, another ``moe_impl``), largest byte
difference first.  The last line of output is the JSON record.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import re
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, fake_world, make_mesh  # noqa: E402
from repro_torch.models import ExecConfig  # noqa: E402
from repro_torch.roofline.trace_costs import CostMode, TraceCosts, counting  # noqa: E402
from repro_torch.sharding import PRESETS, activation_sharding  # noqa: E402

_KEYS = ("flops", "bytes", "peak_bytes", "count")
_SRC = str(ROOT / "src" / "repro_torch")


def _site() -> str:
    """The innermost two frames of the port outside the cost counter; in
    a backward, the autograd node and its forward op's frames."""
    node = torch._C._current_autograd_node()
    if node is not None:
        frames = re.findall(r'File "([^"]+)", line (\d+)', "".join(
            node.metadata.get("traceback_", [])))
        out = [f"{Path(f).name}:{n}" for f, n in reversed(frames)
               if f.startswith(_SRC) and "roofline" not in f][:2]
        return f"{node.name()} of " + (" < ".join(out) or "-")
    f, out = sys._getframe(2), []
    while f is not None and len(out) < 2:
        name = f.f_code.co_filename
        if name.startswith(_SRC) and "roofline" not in name:
            out.append(f"{Path(name).name}:{f.f_lineno}")
        f = f.f_back
    return " < ".join(out) or "-"


class ByOpMode(CostMode):
    """The dry-run's counter, whose counts are also kept by aten op (with
    ``sites``, by op and call site): each op's share is what it added to
    the totals, and its peak bytes are those of the storages it created
    that were live when the peak was first reached."""

    def __init__(self, costs: TraceCosts, sites: bool = False) -> None:
        super().__init__(costs)
        self.sites = sites
        self.by_op: dict[str, dict] = {}
        self.owner: dict[int, tuple[str, int]] = {}  # id(storage) -> (op, bytes)
        self.live_by_op: collections.Counter = collections.Counter()
        self.peak_by_op: dict[str, int] = {}

    def _totals(self) -> tuple[float, float, float]:
        c = self.costs
        return c.flops, c.bytes, c.peak_bytes

    def _note(self, name: str, before: tuple, outs: list) -> None:
        key = f"{name} @ {_site()}" if self.sites else name
        flops, nbytes, peak = (a - b for a, b in zip(self._totals(), before, strict=True))
        if flops or nbytes:
            rec = self.by_op.setdefault(key, dict.fromkeys(_KEYS, 0))
            rec["count"] += 1
            rec["flops"] += flops
            rec["bytes"] += nbytes
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            sid = id(st)
            if sid in self.seen and sid not in self.owner:
                self.owner[sid] = (key, self.seen[sid])
                self.live_by_op[key] += self.seen[sid]
                weakref.finalize(st, self._gone, sid)
        if peak > 0:
            self.peak_by_op = {k: n for k, n in self.live_by_op.items() if n}

    def _gone(self, sid: int) -> None:
        key, n = self.owner.pop(sid)
        self.live_by_op[key] -= n

    def alltoall(self, fn, input, *args):
        before = self._totals()
        out = super().alltoall(fn, input, *args)
        self._note("shard_dim_alltoall", before, [out])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self._totals()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self.paused:
            self._note(func._overloadpacket.__name__, before,
                       [t for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor)])
        return out

    def breakdown(self) -> dict:
        """{op: count, flops, bytes, peak_bytes}, largest bytes first."""
        for key, n in self.peak_by_op.items():
            self.by_op.setdefault(key, dict.fromkeys(_KEYS, 0))["peak_bytes"] = n
        return dict(sorted(self.by_op.items(), key=lambda kv: -kv[1]["bytes"]))


def trace(arch: str, shape_name: str, mesh_name: str, moe_impl: str, layers: int | None,
          sites: bool = False, rules_name: str = "auto") -> dict:
    """The cell traced as ``dryrun.trace_cell`` traces it, under ``ByOpMode``."""
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = get_shape(shape_name)
    if rules_name == "auto":
        rules_name = dryrun.default_rules(shape.kind)
    mesh_shape, axes = MULTI_POD if mesh_name == "multi" else SINGLE_POD
    ex = ExecConfig(remat=cfg.remat, attn_impl="xla", moe_impl=moe_impl)
    rules = PRESETS[rules_name]
    costs = TraceCosts()
    mode = ByOpMode(costs, sites)
    with fake_world(math.prod(MULTI_POD[0])):
        mesh = make_mesh(mesh_shape, axes)
        run, arg_bytes = dryrun.cell_step(cfg, shape, mesh, rules, ex=ex)
        t0 = time.perf_counter()
        with activation_sharding(mesh, rules), counting(mode):
            run()
        trace_s = time.perf_counter() - t0
    return {"torch": torch.__version__, "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "rules": rules_name, "moe_impl": moe_impl, "layers": cfg.n_layers,
            "flops": costs.flops, "dot_flops": costs.dot_flops, "bytes": costs.bytes,
            "coll_bytes": costs.coll_bytes, "coll_counts": costs.coll_counts,
            "arg_bytes": arg_bytes, "peak_bytes": costs.peak_bytes, "trace_s": trace_s,
            "by_op": mode.breakdown()}


def diff(a: dict, b: dict) -> list[dict]:
    """The ops whose counts differ between two records, largest byte
    difference first."""
    rows = []
    for op in sorted(set(a["by_op"]) | set(b["by_op"])):
        x = a["by_op"].get(op, dict.fromkeys(_KEYS, 0))
        y = b["by_op"].get(op, dict.fromkeys(_KEYS, 0))
        d = {k: y[k] - x[k] for k in _KEYS}
        if any(d.values()):
            rows.append({"op": op, **{f"d_{k}": v for k, v in d.items()},
                         "this": x, "other": y})
    return sorted(rows, key=lambda r: -abs(r["d_bytes"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--rules", default="auto", choices=["auto", *PRESETS],
                    help="the sharding preset (auto: the shape's default)")
    ap.add_argument("--moe-impl", default="vmap", choices=["vmap", "batched"])
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--sites", action="store_true", help="key ops by their call sites too")
    ap.add_argument("--out", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args(argv)
    if args.sites:
        # forward tracebacks on the autograd nodes, for the backward's sites
        torch.autograd.set_detect_anomaly(True, check_nan=False)
    rec = trace(args.arch, args.shape, args.mesh, args.moe_impl, args.layers or None,
                args.sites, args.rules)
    if args.against:
        other = json.loads(Path(args.against).read_text())
        rec["against"] = {k: other[k] for k in ("torch", "moe_impl", "layers")}
        for row in diff(rec, other):
            print(f"{row['op']:>28}  bytes {row['d_bytes']:+.4g}  flops {row['d_flops']:+.4g}  "
                  f"peak {row['d_peak_bytes']:+.4g}  count {row['d_count']:+d}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
