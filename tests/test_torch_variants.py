"""The port's fleet planning against the JAX package's, exactly.

``configs.shapes``, ``core.power``, ``core.variants`` and
``launch.schedule``: the shape table and cell applicability, the per-step
job costs and variant tables of every registered arch x shape at two sets
of slice sizes, the heterogeneous fleets and tasks, the fleet plans of
``tests/test_scheduler_fleet.py`` (the reference on its numpy engine, the
port on ``"torch"``) and the CLI's output.  Every float is compared with
``==``: both packages run the same Python float operations in the same
order.  One ``needs_cuda`` test plans on ``engine="cuda"`` (kernel 1).
"""

import dataclasses
import doctest
import io
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.configs.paper_examples import example1_tasks as ref_example1_tasks  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.core import PADPSFRScheduler as RefScheduler  # noqa: E402
from repro.core import power as ref_power  # noqa: E402
from repro.core import variants as ref_variants  # noqa: E402
from repro.launch import schedule as ref_schedule  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    PORT_ONLY_ARCHS,
    SHAPES,
    InputShape,
    get_arch,
    get_shape,
    list_archs,
)
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.paper_examples import example1_tasks  # noqa: E402
from repro_torch.core import FleetSpec, PADPSFRScheduler, power, variants  # noqa: E402
from repro_torch.kernels.placement_step import placement_sweep_cuda  # noqa: E402
from repro_torch.launch import schedule  # noqa: E402

from test_torch_scheduler import _assert_same  # noqa: E402

CHIP_OPTIONS = [(16, 32, 64), (32, 64, 128, 256)]
CELLS = [(a, s) for a in ref_list_archs() for s in ref_shapes.SHAPES]


def _variant_fields(vs):
    return [(v.cu, v.throughput, v.power, v.program) for v in vs]


def _task_fields(t):
    return (t.name, t.period, t.data, t.init_interval, _variant_fields(t.variants))


def _fleet_fields(f):
    return (f.n_f, f.t_slr, f.t_cfg, f.name,
            [(d.t_slr, d.t_cfg, d.klass) for d in f.devices])


def _jobs(mod, get, steps=(600, 3000, 2000)):
    """tests/test_scheduler_fleet.py's three jobs, built from ``mod``."""
    return [
        mod.JobSpec(cfg=get("yi-34b"), shape=_shape(mod, "train_4k"),
                    period_s=3600, steps_per_period=steps[0]),
        mod.JobSpec(cfg=get("smollm-135m"), shape=_shape(mod, "decode_32k"),
                    period_s=600, steps_per_period=steps[1]),
        mod.JobSpec(cfg=get("mamba2-130m"), shape=_shape(mod, "train_4k"),
                    period_s=1800, steps_per_period=steps[2]),
    ]


def _shape(mod, name):
    return (get_shape if mod is variants else ref_shapes.get_shape)(name)


# ---------------------------------------------------------------------------
# configs.shapes and core.power: the tables
# ---------------------------------------------------------------------------


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    assert [s.tokens for s in SHAPES.values()] == [s.tokens for s in ref_shapes.SHAPES.values()]
    # the port's own archs (PORT_ONLY_ARCHS) add their cells, which no dry-run runs
    assert [c for c in shapes.all_cells() if c[0] not in PORT_ONLY_ARCHS] == \
        ref_shapes.all_cells()
    assert not any(shapes.cell_applicability(get_arch(a), get_shape(s))[0]
                   for a, s in shapes.all_cells() if a in PORT_ONLY_ARCHS)
    for arch, shape in CELLS:
        assert shapes.cell_applicability(get_arch(arch), get_shape(shape)) == \
            ref_shapes.cell_applicability(ref_get_arch(arch), ref_shapes.get_shape(shape))
    assert isinstance(get_shape("train_4k"), InputShape)
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")


def test_power_model_and_device_classes_equal_reference():
    assert dataclasses.asdict(power.V5E) == dataclasses.asdict(ref_power.V5E)
    assert dataclasses.asdict(power.PowerModel()) == dataclasses.asdict(ref_power.PowerModel())
    assert {k: dataclasses.asdict(v) for k, v in power.DEVICE_CLASSES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_power.DEVICE_CLASSES.items()}
    pm, ref_pm = power.PowerModel(), ref_power.PowerModel()
    for args in ((64, 0.5, 3e15, 2e12, 1e10), (8, 0.0, 1.0, 1.0, 1.0), (1, 1e-3, 0.0, 5e9, 0.0)):
        assert pm.job_power(*args) == ref_pm.job_power(*args)
    for args in ((3e15, 2e12, 1e10, 64), (1.0, 1e13, 0.0, 1)):
        assert power.step_time_roofline(*args) == ref_power.step_time_roofline(*args)
    with pytest.raises(ValueError, match="capacity_scale"):
        power.DeviceClass(name="x", t_cfg_frac=0.0, capacity_scale=0.0)
    with pytest.raises(ValueError, match="t_cfg_frac"):
        power.DeviceClass(name="x", t_cfg_frac=-1.0)


# ---------------------------------------------------------------------------
# core.variants: costs, tables, fleets, tasks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_job_costs_and_variant_tables_equal_reference(arch, shape):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    shp, ref_shp = get_shape(shape), ref_shapes.get_shape(shape)
    assert variants.job_costs(cfg, shp) == ref_variants.job_costs(ref_cfg, ref_shp)
    job = variants.JobSpec(cfg=cfg, shape=shp, period_s=1800.0, steps_per_period=250)
    ref_job = ref_variants.JobSpec(cfg=ref_cfg, shape=ref_shp, period_s=1800.0,
                                   steps_per_period=250)
    assert job.job_name == ref_job.job_name
    for opts in CHIP_OPTIONS:
        want = ref_variants.variant_table(ref_job, opts)
        assert _variant_fields(variants.variant_table(job, opts)) == _variant_fields(want)
        if want:
            assert _task_fields(variants.make_task(job, opts)) == \
                _task_fields(ref_variants.make_task(ref_job, opts))
        else:
            with pytest.raises(ValueError, match="no slice size"):
                variants.make_task(job, opts)


def test_variant_table_options_equal_reference():
    """A named job, another power model and a spec with less memory."""
    spec = dataclasses.replace(power.V5E, hbm_bytes=4e9)
    ref_spec = dataclasses.replace(ref_power.V5E, hbm_bytes=4e9)
    pm = power.PowerModel(idle_w=60.0, e_flop=0.4e-12)
    ref_pm = ref_power.PowerModel(idle_w=60.0, e_flop=0.4e-12)
    job = variants.JobSpec(get_arch("qwen2-vl-2b"), get_shape("prefill_32k"), 900.0, 40, "vl")
    ref_job = ref_variants.JobSpec(ref_get_arch("qwen2-vl-2b"),
                                   ref_shapes.get_shape("prefill_32k"), 900.0, 40, "vl")
    got = variants.variant_table(job, (8, 16, 32, 64), spec, pm)
    want = ref_variants.variant_table(ref_job, (8, 16, 32, 64), ref_spec, ref_pm)
    assert _variant_fields(got) == _variant_fields(want) and got[0].program.startswith("vl@")


@pytest.mark.parametrize("counts,t_slr", [
    ({"fpga": 2, "gpu": 1}, 60.0),
    ({"fpga": 2, "gpu": 1, "cpu": 1}, 60.0),
    ({"tpu": 3, "cpu": 2}, 3600.0),
    ([("gpu", 2), ("fpga", 0), ("fpga", 1)], 600.0),
])
def test_make_hetero_fleet_equals_reference(counts, t_slr):
    got = variants.make_hetero_fleet(counts, t_slr, name="mixed")
    want = ref_variants.make_hetero_fleet(counts, t_slr, name="mixed")
    assert _fleet_fields(got) == _fleet_fields(want)


def test_make_hetero_fleet_classes_and_refusals():
    klass = power.DeviceClass(name="asic", t_cfg_frac=0.02, capacity_scale=0.5)
    ref_klass = ref_power.DeviceClass(name="asic", t_cfg_frac=0.02, capacity_scale=0.5)
    got = variants.make_hetero_fleet([(klass, 2), ("fpga", 1)], 60.0)
    want = ref_variants.make_hetero_fleet([(ref_klass, 2), ("fpga", 1)], 60.0)
    assert _fleet_fields(got) == _fleet_fields(want)
    with pytest.raises(ValueError, match="at least one device"):
        variants.make_hetero_fleet({"gpu": 0}, 60.0)
    with pytest.raises(ValueError, match="count must be >= 0"):
        variants.make_hetero_fleet({"gpu": -1}, 60.0)


def test_variants_doctest():
    result = doctest.testmod(variants, verbose=False)
    assert result.attempted > 0 and result.failed == 0


# ---------------------------------------------------------------------------
# launch.schedule: plans and the CLI
# ---------------------------------------------------------------------------


def test_plan_fleet_feasible_equals_reference():
    """tests/test_scheduler_fleet.py's feasible case: the same combo, rank,
    power and plan."""
    ref_tasks, ref = ref_schedule.plan_fleet(
        _jobs(ref_variants, ref_get_arch), RefFleetSpec(n_f=4, t_slr=3600.0, t_cfg=45.0),
        chip_options=(16, 32, 64))
    tasks, got = schedule.plan_fleet(_jobs(variants, get_arch),
                                     FleetSpec(n_f=4, t_slr=3600.0, t_cfg=45.0),
                                     chip_options=(16, 32, 64), engine="torch")
    assert [_task_fields(t) for t in tasks] == [_task_fields(t) for t in ref_tasks]
    assert got.feasible and got.total_power > 0
    _assert_same(got, ref)
    placed = {seg.task for s in got.plan.scripts for seg in s.segments if seg.kind == "run"}
    assert placed == set(range(len(tasks)))


def test_plan_fleet_infeasible_equals_reference():
    def jobs(mod, get):
        return [mod.JobSpec(cfg=get("yi-34b"), shape=_shape(mod, "train_4k"),
                            period_s=10.0, steps_per_period=100000)]

    _, ref = ref_schedule.plan_fleet(jobs(ref_variants, ref_get_arch),
                                     RefFleetSpec(n_f=2, t_slr=10.0, t_cfg=1.0),
                                     chip_options=(64, 128))
    _, got = schedule.plan_fleet(jobs(variants, get_arch), FleetSpec(n_f=2, t_slr=10.0, t_cfg=1.0),
                                 chip_options=(64, 128), engine="torch")
    assert not got.feasible
    _assert_same(got, ref)


def test_plan_fleet_on_a_hetero_fleet_equals_reference():
    """Example 1 on two FPGAs, a GPU and a CPU (examples/hetero_fleet.py)."""
    counts = {"fpga": 2, "gpu": 1, "cpu": 1}
    ref = RefScheduler(ref_variants.make_hetero_fleet(counts, 60.0), engine="numpy").schedule(
        ref_example1_tasks(), count_all_rejects=True)
    got = PADPSFRScheduler(variants.make_hetero_fleet(counts, 60.0), engine="torch").schedule(
        example1_tasks(), count_all_rejects=True)
    assert got.feasible
    _assert_same(got, ref)


def _stdout(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--slices", "4", "--slice-chips", "64", "--t-slr", "3600", "--t-cfg", "45",
     "--job", "yi-34b:train_4k:1800:250", "--job", "smollm-135m:decode_32k:600:5000"],
    ["--slices", "4", "--slice-chips", "64", "--t-slr", "3600", "--t-cfg", "45",
     "--job", "yi-34b:train_4k:1800:900", "--job", "smollm-135m:decode_32k:600:5000"],
    ["--job", "yi-34b:train_4k:1800:900", "--job", "smollm-135m:decode_32k:600:5000",
     "--job", "moonshot-v1-16b-a3b:prefill_32k:3600:20"],
    ["--slices", "2", "--slice-chips", "64", "--t-slr", "10", "--t-cfg", "1",
     "--job", "yi-34b:train_4k:10:100000"],
], ids=["cli-test", "docstring", "defaults-three-jobs", "infeasible"])
def test_schedule_cli_output_equals_reference(argv):
    want = _stdout(ref_schedule.main, argv)
    got = _stdout(schedule.main, [*argv, "--engine", "torch"])
    assert got == want
    assert got[1].startswith("fleet:") and (got[0] == 0) == ("time slice" in got[1])


def test_schedule_cli_defaults_to_the_card():
    argv = ["--job", "smollm-135m:decode_32k:600:5000"]
    if torch.cuda.is_available():
        assert _stdout(schedule.main, argv)[0] == 0
        return
    with pytest.raises(RuntimeError, match="not available"):
        schedule.main(argv)


@pytest.mark.needs_cuda
def test_plan_fleet_on_cuda_equals_torch_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fleet = FleetSpec(n_f=4, t_slr=3600.0, t_cfg=45.0)
    before = placement_sweep_cuda.launches
    tasks, got = schedule.plan_fleet(_jobs(variants, get_arch), fleet, (16, 32, 64))
    assert placement_sweep_cuda.launches > before
    _, want = schedule.plan_fleet(_jobs(variants, get_arch), fleet, (16, 32, 64),
                                  engine="torch")
    assert got.feasible
    _assert_same(got, want)
