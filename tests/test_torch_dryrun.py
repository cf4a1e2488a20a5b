"""The port's dry-run (``repro_torch.launch.dryrun``).

Exact against the JAX package: per-device ``arg_bytes`` of every
applicable (arch x shape x mesh) cell equals what the reference's
``dryrun_cell`` sums with its ``_shard_bytes`` from the ``NamedSharding``s
of its rules on its 256- and 512-device meshes (computed in a subprocess,
since the reference's dry-run module sets ``XLA_FLAGS`` for 512 host
devices when imported; nothing is lowered), and so do ``_model_flops``
and ``default_rules``.

Per device: a reduced smollm-135m prefill on a fake (2, 2) mesh, where
every sharded dim divides, reads exactly a quarter of the dot FLOPs of the
(1, 1) mesh.  The reduced (4, 2) train cell of tests/test_dryrun_small.py
traces in a subprocess for its three archs, with FLOPs, collective bytes
and argument bytes all > 0, and the CLI writes, skips and resumes rows.
The full smollm-135m x train_4k cell traces to chip_smoke.py's
``F3_TORCH_213`` counts, each within its 1%.
On a card (``needs_cuda``), a world-1 NCCL group and a (1, 1) mesh run
one float32 train step of reduced smollm-135m with the state as DTensors,
equal to the plain step within 1e-6 relative, and the state's allocation
equals the dry-run's ``arg_bytes`` within 1%.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape, cell_applicability  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, fake_world, make_mesh  # noqa: E402
from repro_torch.models import ExecConfig  # noqa: E402
from repro_torch.sharding import PRESETS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

_REF_CELLS = r"""
import json
import jax
import numpy as np
from repro.launch import dryrun as d
from repro.configs import get_arch, list_archs
from repro.configs.shapes import SHAPES, cell_applicability
from repro.launch.mesh import make_production_mesh
from repro.models import Model
from repro.models.model import decode_input_specs, prefill_batch_specs, train_batch_specs
from repro.sharding import PRESETS, batch_axes_tree, state_axes_tree, tree_shardings
from repro.train.step import train_state_axes


def shard_bytes(tree_abs, tree_sh):
    tot = 0.0
    for sds, sh in zip(jax.tree.leaves(tree_abs), jax.tree.leaves(tree_sh), strict=True):
        tot += float(np.prod(sh.shard_shape(sds.shape))) * sds.dtype.itemsize
    return tot


rows = []
meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
for arch in list_archs():
    cfg = get_arch(arch)
    for name, shape in SHAPES.items():
        flops = d._model_flops(cfg, shape)
        if not cell_applicability(cfg, shape)[0]:
            continue
        rules = PRESETS[d.default_rules(shape.kind)]
        model = Model(cfg)
        for mesh_name, mesh in meshes.items():
            if shape.kind == "train":
                state, batch = d._abstract_train_state(model), train_batch_specs(cfg, shape)
                args = (shard_bytes(state, tree_shardings(state, train_state_axes(model), mesh,
                                                          rules))
                        + shard_bytes(batch, tree_shardings(batch, batch_axes_tree(batch), mesh,
                                                            rules)))
            else:
                params = model.abstract_params("bfloat16")
                args = shard_bytes(params, tree_shardings(params, model.param_axes(), mesh,
                                                          rules))
                if shape.kind == "prefill":
                    batch = prefill_batch_specs(cfg, shape)
                    args += shard_bytes(batch, tree_shardings(batch, batch_axes_tree(batch),
                                                              mesh, rules))
                else:
                    inp = decode_input_specs(cfg, shape)
                    args += shard_bytes(inp["state"], tree_shardings(
                        inp["state"], state_axes_tree(inp["state"]), mesh, rules))
                    args += shard_bytes(inp["tokens"], tree_shardings(
                        inp["tokens"], ("batch",), mesh, rules))
            rows.append([arch, name, mesh_name, d.default_rules(shape.kind), args, flops])
print("RESULT " + json.dumps(rows))
"""


@pytest.fixture(scope="module")
def reference_cells():
    proc = subprocess.run([sys.executable, "-c", _REF_CELLS], capture_output=True, text=True,
                          timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_arg_bytes_and_model_flops_equal_reference(reference_cells):
    """Every applicable cell on both production meshes, exactly."""
    assert len(reference_cells) > 40
    meshes = {"single": SINGLE_POD, "multi": MULTI_POD}
    with fake_world(512):
        built = {name: make_mesh(*m) for name, m in meshes.items()}
        for arch, shape_name, mesh_name, rules_name, args, flops in reference_cells:
            cfg, shape = get_arch(arch), SHAPES[shape_name]
            assert cell_applicability(cfg, shape)[0]
            assert dryrun.default_rules(shape.kind) == rules_name
            assert dryrun._model_flops(cfg, shape) == flops
            _, got = dryrun.cell_step(cfg, shape, built[mesh_name], PRESETS[rules_name])
            assert got == args, (arch, shape_name, mesh_name)
    applicable = {(a, s) for a in list_archs() for s in SHAPES
                  if cell_applicability(get_arch(a), SHAPES[s])[0]}
    assert {(a, s) for a, s, *_ in reference_cells} == applicable


def test_per_device_dot_flops_are_a_quarter_on_a_2x2_mesh():
    """Reduced smollm-135m prefill, every sharded dim dividing: the (2, 2)
    mesh's per-device dot FLOPs are exactly a quarter of the (1, 1)
    mesh's (no work replicated: the projections run token-parallel on
    FSDP-gathered weights, the head vocab-parallel)."""
    cfg = get_arch("smollm-135m").reduced()
    shape = InputShape("t", 32, 8, "prefill")
    rules = PRESETS["fsdp_tp_sp"]
    dots = {}
    with fake_world(4):
        for mesh_shape in ((1, 1), (2, 2)):
            costs, _ = dryrun.trace_cell(cfg, shape, make_mesh(mesh_shape, ("data", "model")),
                                         rules)
            dots[mesh_shape] = costs.dot_flops
            if mesh_shape == (2, 2):
                assert costs.total_coll_bytes > 0
    plain, _ = dryrun.trace_cell(cfg, shape)  # no mesh: one device, plain tensors
    assert dots[(1, 1)] == plain.dot_flops > 0
    assert dots[(2, 2)] * 4 == dots[(1, 1)]


_SMALL = r"""
import json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import ExecConfig
from repro_torch.roofline import analyze_compiled
from repro_torch.sharding import PRESETS

cfg = get_arch(sys.argv[1]).reduced()
with fake_world(8):
    mesh = make_mesh((4, 2), ("data", "model"))
    costs, _ = trace_cell(cfg, InputShape("t", 32, 8, "train"), mesh, PRESETS["fsdp_tp_sp"],
                          ex=ExecConfig(remat="full", attn_impl="xla"))
res = analyze_compiled(costs, arch=sys.argv[1], shape="t", mesh_name="m", n_chips=8,
                       model_flops=1.0)
print("RESULT " + json.dumps({"flops": res.flops_per_device, "coll": res.coll_bytes_per_device,
                              "mem": costs.arg_bytes}))
"""


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m", "moonshot-v1-16b-a3b"])
def test_reduced_cell_traces_on_small_mesh(arch):
    proc = subprocess.run([sys.executable, "-c", _SMALL, arch], capture_output=True, text=True,
                          timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    res = json.loads(line[len("RESULT "):])
    assert res["flops"] > 0
    assert res["coll"] > 0  # sharded training must communicate
    assert res["mem"] > 0


def test_smollm_train_cell_traces_to_the_torch_213_counts():
    """chip_smoke.py holds the card host's torch to ``F3_TORCH_213`` (the
    single-pod smollm-135m x train_4k counts, full width and depth); this
    torch traces the cell to them too, so a change that moves them shows
    here as well as on the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ex = ExecConfig(remat=get_arch("smollm-135m").remat, attn_impl="xla")
    row = dryrun.dryrun_cell("smollm-135m", "train_4k", "single", ex=ex, verbose=False)
    rec = smoke._against_torch_213(row)  # raises past the tolerance
    assert rec["flops"]["here"] > 0 and rec["coll_all-to-all"]["here"] > 0


def test_cli_writes_skips_and_resumes(tmp_path):
    out = tmp_path / "dryrun.json"
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
            "--mesh", "single", "--out", str(out)]
    proc = subprocess.run(base + ["--shape", "decode_32k", "--rules", "sp_serve"],
                          capture_output=True, text=True, timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[smollm-135m x decode_32k x single] OK chips=256" in proc.stdout
    proc = subprocess.run(base + ["--shape", "long_500k"], capture_output=True, text=True,
                          timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0 and "SKIP" in proc.stdout
    rows = json.loads(out.read_text())
    assert [(r["shape"], r["status"]) for r in rows] == [("decode_32k", "OK"),
                                                         ("long_500k", "SKIP")]
    ok = rows[0]
    assert ok["chips"] == 256 and ok["rules"] == "sp_serve"
    assert ok["flops_per_device"] > 0 and ok["coll_bytes_per_device"] > 0
    assert ok["arg_bytes"] > 0 and ok["trace_s"] >= 0
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck", "step_time_s",
                "model_flops", "useful_flops_frac", "mfu", "hbm_peak_bytes", "coll_per_op",
                "coll_counts", "temp_bytes"):
        assert key in ok
    # a rerun of a row's (arch, shape, mesh, rules) without --force leaves the
    # rows as they are (as in the reference, "auto" never names a row's rules)
    proc = subprocess.run(base + ["--shape", "decode_32k", "--rules", "sp_serve"],
                          capture_output=True, text=True, timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0 and "OK" not in proc.stdout
    assert json.loads(out.read_text()) == rows


def test_a_failing_cell_is_a_fail_row(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no sharding for this op")

    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    out = tmp_path / "rows.json"
    rc = dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--out", str(out)])
    assert rc == 1
    (row,) = json.loads(out.read_text())
    assert row["status"] == "FAIL" and row["error"] == "RuntimeError: no sharding for this op"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.needs_cuda
def test_one_device_nccl_mesh_step_equals_plain(cuda_device):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_map
    from repro_torch.data import make_batch_fn
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import activation_sharding, batch_axes_tree, tree_shardings
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_train_state, train_state_axes

    cfg = get_arch("smollm-135m").reduced()
    ex = ExecConfig(attn_impl="xla", remat="full")
    opt = AdamW(1e-3)
    model = Model(cfg, ex, params={}, device=cuda_device)
    host = init_train_state(Model(cfg, ex, params={}, device="cpu"), opt,
                            torch.Generator().manual_seed(0))
    shape = InputShape("t", 64, 4, "train")
    batch = {k: torch.as_tensor(v) for k, v in make_batch_fn(cfg, shape)(0).items()}
    rules = PRESETS["fsdp_tp_sp"]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        assert mesh.device_type == "cuda"
        _, arg_bytes = dryrun.cell_step(cfg, shape, mesh, rules, ex=ex)

        def place(tree, axes):
            pl = tree_shardings(tree, axes, mesh, rules)
            return tree_map(lambda t, p: DTensor.from_local(t.to(cuda_device), mesh, p,
                                                            run_check=False), tree, pl)

        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        d_state, d_batch = place(host, train_state_axes(model)), place(batch,
                                                                       batch_axes_tree(batch))
        grown = torch.cuda.memory_allocated(cuda_device) - before
        step = make_train_step(model, opt)
        with activation_sharding(mesh, rules):
            _, got = step(d_state, d_batch)
        _, want = step(tree_map(lambda t: t.to(cuda_device), host),
                       {k: v.to(cuda_device) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            g, w = float(got[k].full_tensor()), float(want[k])
            assert abs(g - w) <= 1e-6 * abs(w), (k, g, w)
    finally:
        dist.destroy_process_group()
    # the caching allocator rounds each of the many small leaves up to 512 B
    assert abs(grown - arg_bytes) <= 0.01 * arg_bytes + 512 * 64
