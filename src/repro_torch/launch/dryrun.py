"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

For each cell this builds the step the shape demands (the train step,
``Model.prefill`` or ``Model.decode_step``), derives the placements of its
state, parameters and inputs from the logical-axis rules, builds them as
DTensors of ``meta`` local shards on the production mesh (``fake_world(512)``:
no device, no allocation, no computation), runs the step once under
``activation_sharding`` and ``count_costs()``, and records

* per-device FLOPs, bytes and collective bytes + op counts (``trace_costs``),
* the exact per-device argument bytes from the shard shapes, the peak of
  live bytes the step created (``temp_bytes``) and its outputs' bytes,
* the three roofline terms + bottleneck + MFU estimate, against the JAX
  package's modelled fleet (``V5E``: data, not a measurement).

Results are appended to a JSON file so a sweep can resume.  Skipped cells
(long_500k on full-attention archs) are recorded as SKIP rows; a cell that
raises is recorded as a FAIL row and the run exits 1.  The step runs on
``ExecConfig(remat=cfg.remat, attn_impl="xla")``, the JAX package's
dry-run route.  No card is used.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback

import torch

from .._tree import leaves, tree_map
from ..configs import get_arch, list_archs
from ..configs.shapes import SHAPES, cell_applicability, get_shape
from ..models import ExecConfig, Model
from ..models.model import decode_input_specs, prefill_batch_specs, train_batch_specs
from ..optim import AdamW
from ..roofline import analyze_compiled
from ..roofline.trace_costs import count_costs
from ..sharding import (
    PRESETS,
    activation_sharding,
    batch_axes_tree,
    state_axes_tree,
    tree_shardings,
)
from ..train.step import TrainState, make_train_step, train_state_axes
from .mesh import MULTI_POD, SINGLE_POD, fake_world, make_mesh

__all__ = ["dryrun_cell", "main"]


def _abstract_train_state(model: Model, *, compress: bool = False) -> TrainState:
    params = model.abstract_params()
    f32 = lambda t: tree_map(  # noqa: E731
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), t
    )
    return TrainState(
        params=params,
        opt_state={"m": f32(params), "v": f32(params)},
        step=torch.empty((), dtype=torch.int32, device="meta"),
        ef_residual=f32(params) if compress else None,
    )


def _model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * shape.tokens


def default_rules(kind: str) -> str:
    """Shape-aware preset: training/prefill wants FSDP + sequence-parallel
    activations; decode wants the KV-cache time axis on 'model' (GQA kv
    head counts don't fill a 16-wide axis)."""
    return "sp_serve" if kind == "decode" else "fsdp_tp_sp"


def _local_shape(shape, placements, mesh) -> tuple[int, ...]:
    out = list(shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.shape[j]
    return tuple(out)


def _shard_bytes(tree_abs, tree_pl, mesh) -> float:
    """Per-device bytes of a tree under its placements, from the shard
    shapes (the JAX package's ``_shard_bytes``)."""
    sizes: list[int] = []
    tree_map(lambda t, pl: sizes.append(math.prod(_local_shape(t.shape, pl, mesh))
                                        * t.element_size()), tree_abs, tree_pl)
    return float(sum(sizes))


def _dtensors(tree_abs, tree_pl, mesh):
    """DTensors of the abstract tree's global shapes and dtypes, each local
    shard an empty ``meta`` tensor.

    Not fake tensors: under a ``FakeTensorMode`` DTensor's redistribution
    planner fails on a view that merges two sharded dims (einsum's
    ``bsd -> (b s) d`` of a batch- and sequence-sharded activation), since
    it sizes the merged dim's shards with a ``torch.arange(...).tolist()``
    that the mode makes data-dependent.  Meta tensors carry the same shapes
    and dtypes, and everything the program creates from them
    (``device=x.device``) stays on ``meta``."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False)

    return tree_map(one, tree_abs, tree_pl)


def _args(tree_abs, axes, mesh, rules):
    """A step's argument tree and its bytes a device: DTensors of ``meta``
    shards placed by the rules on ``mesh``, or with no mesh the abstract
    tree itself (one device)."""
    if mesh is None:
        return tree_abs, float(sum(t.numel() * t.element_size() for t in leaves(tree_abs)))
    pl = tree_shardings(tree_abs, axes, mesh, rules)
    return _dtensors(tree_abs, pl, mesh), _shard_bytes(tree_abs, pl, mesh)


def cell_step(cfg, shape, mesh=None, rules=None, *, ex: ExecConfig | None = None,
              compress_grads: bool = False):
    """The step ``shape`` demands of ``cfg`` on its ``meta`` arguments
    (``_args``), as a thunk, and the arguments' bytes a device."""
    ex = ex or ExecConfig(remat=cfg.remat, attn_impl="xla")
    if shape.kind == "train":
        model = Model(cfg, ex, params={}, device="meta")
        abstract = _abstract_train_state(model, compress=compress_grads)
        state, arg_bytes = _args(abstract, train_state_axes(model, compress=compress_grads),
                                 mesh, rules)
        batch_abs = train_batch_specs(cfg, shape)
        batch, b_bytes = _args(batch_abs, batch_axes_tree(batch_abs), mesh, rules)
        arg_bytes += b_bytes
        step = make_train_step(model, AdamW(1e-4), compress_grads=compress_grads)
        run = lambda: step(state, batch)  # noqa: E731
    else:
        abstract = Model(cfg, ex, params={}, device="meta")
        params_abs = abstract.abstract_params("bfloat16")
        params, arg_bytes = _args(params_abs, abstract.param_axes(), mesh, rules)
        model = Model(cfg, ex, params=params, device="meta")
        if shape.kind == "prefill":
            batch_abs = prefill_batch_specs(cfg, shape)
            batch, b_bytes = _args(batch_abs, batch_axes_tree(batch_abs), mesh, rules)
            arg_bytes += b_bytes
            run = lambda: model.prefill(batch)  # noqa: E731
        else:
            inputs = decode_input_specs(cfg, shape)
            state, st_bytes = _args(inputs["state"], state_axes_tree(inputs["state"]), mesh,
                                    rules)
            tokens, tok_bytes = _args(inputs["tokens"], ("batch",), mesh, rules)
            arg_bytes += st_bytes + tok_bytes
            idx = shape.seq_len - 1  # the last slot: a full cache
            run = lambda: model.decode_step(state, tokens, idx)  # noqa: E731
    return run, arg_bytes


def trace_cell(cfg, shape, mesh=None, rules=None, *, ex: ExecConfig | None = None,
               compress_grads: bool = False):
    """Trace one step of ``cfg`` at ``shape`` on ``meta`` tensors: on
    ``mesh`` (inside a fake world or a real process group) as DTensors
    placed by ``rules`` under ``activation_sharding``, or with no mesh on
    plain tensors (one device).  Returns (TraceCosts with ``arg_bytes``
    set, trace seconds)."""
    run, arg_bytes = cell_step(cfg, shape, mesh, rules, ex=ex, compress_grads=compress_grads)
    sharding = activation_sharding(mesh, rules) if mesh is not None else contextlib.nullcontext()
    t0 = time.perf_counter()
    with sharding, count_costs() as costs:
        out = run()
    trace_s = time.perf_counter() - t0
    costs.arg_bytes = arg_bytes
    costs.out_bytes = float(sum(_local(t).numel() * t.element_size() for t in leaves(out)
                                if isinstance(t, torch.Tensor)))
    return costs, trace_s


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def dryrun_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    *,
    rules_name: str = "auto",
    ex: ExecConfig | None = None,
    compress_grads: bool = False,
    verbose: bool = True,
) -> dict:
    """Trace one cell on its production mesh; returns the result-row dict."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, reason = cell_applicability(cfg, shape)
    if not ok:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "SKIP", "reason": reason,
        }
    if rules_name == "auto":
        rules_name = default_rules(shape.kind)
    rules = PRESETS[rules_name]
    mesh_shape, axes = MULTI_POD if mesh_name == "multi" else SINGLE_POD
    n_chips = math.prod(mesh_shape)
    with fake_world(math.prod(MULTI_POD[0])):
        mesh = make_mesh(mesh_shape, axes)
        costs, trace_s = trace_cell(cfg, shape, mesh, rules, ex=ex,
                                    compress_grads=compress_grads)
    res = analyze_compiled(
        costs,
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name,
        n_chips=n_chips,
        model_flops=_model_flops(cfg, shape),
    )
    row = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "OK",
        "rules": rules_name,
        "chips": n_chips,
        "trace_s": round(trace_s, 2),
        "flops_per_device": res.flops_per_device,
        "dot_flops_per_device": costs.dot_flops,
        "hbm_bytes_per_device": res.hbm_bytes_per_device,
        "coll_bytes_per_device": res.coll_bytes_per_device,
        "coll_per_op": res.coll.per_op if res.coll else {},
        "coll_counts": res.coll.per_op_count if res.coll else {},
        "arg_bytes": costs.arg_bytes,
        "temp_bytes": costs.peak_bytes,
        "out_bytes": costs.out_bytes,
        **{k: v for k, v in res.to_row().items() if k not in ("arch", "shape", "mesh", "chips")},
    }
    if verbose:
        t = res.terms()
        print(
            f"[{arch} x {shape_name} x {mesh_name}] OK chips={n_chips} "
            f"trace={trace_s:.1f}s flops/dev={res.flops_per_device:.4g} "
            f"bytes/dev={res.hbm_bytes_per_device:.4g} "
            f"coll/dev={res.coll_bytes_per_device:.4g} "
            f"V5E-modelled: compute={t['compute']*1e3:.2f}ms memory={t['memory']*1e3:.2f}ms "
            f"coll={t['collective']*1e3:.2f}ms bottleneck={res.bottleneck()} "
            f"mfu={res.mfu():.3f} "
            f"args/dev={costs.arg_bytes/1e9:.2f}GB peak-live/dev={costs.peak_bytes/1e9:.2f}GB",
            flush=True,
        )
    return row


def _load(out):
    try:
        with open(out) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="auto", choices=["auto"] + list(PRESETS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--force", action="store_true", help="recompute existing rows")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        cells = [(args.arch, args.shape)]

    results = _load(args.out) if args.out else []
    done = {(r["arch"], r["shape"], r["mesh"], r.get("rules", "fsdp_tp")) for r in results}

    failures = 0
    for arch, shape in cells:
        for mesh_name in meshes:
            key = (arch, shape, mesh_name, args.rules)
            if not args.force and key in done:
                continue
            try:
                row = dryrun_cell(arch, shape, mesh_name, rules_name=args.rules)
            except Exception as e:
                traceback.print_exc()
                row = {
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "rules": args.rules, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                }
                failures += 1
            if row.get("status") == "SKIP":
                print(f"[{arch} x {shape} x {mesh_name}] SKIP — {row['reason']}")
            results = [r for r in results
                       if (r["arch"], r["shape"], r["mesh"], r.get("rules", "fsdp_tp")) != key]
            results.append(row)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
