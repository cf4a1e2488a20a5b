"""The port's ``schedule()`` path against the JAX package's, exactly.

The same instances — the paper's Examples 1-3, randomized heterogeneous
instances, the deep band instance — go through the reference's numpy
engine and through the port's ``"torch"`` and ``"scalar"`` engines, carried
across field by field with :mod:`repro_torch.convert`.  Every result field
must be equal, floats included: both packages run the same float64
operations in the same order.  Also here: the block enumerator's
``ComboBlock`` streams against the reference's, the port's import
hygiene (no ``jax``, nothing of ``repro``), and its layers' imports, which
point one way.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import paper_examples as ref_examples  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.core import PADPSFRScheduler as RefScheduler  # noqa: E402
from repro.core import iter_feasible_pruned_blocks as ref_blocks  # noqa: E402
from repro.core import search_feasible as ref_search  # noqa: E402
from repro_torch.configs import paper_examples as port_examples  # noqa: E402
from repro_torch.convert import fleet_from, tasks_from  # noqa: E402
from repro_torch.core import PADPSFRScheduler, WalkStats, block_ramp  # noqa: E402
from repro_torch.core import iter_feasible_pruned_blocks as port_blocks  # noqa: E402
from repro_torch.core import search_feasible as port_search  # noqa: E402

from test_block_enumeration import _tie_tasks  # noqa: E402
from test_placement_batched import _random_fleet, _random_tasks  # noqa: E402

PAPER = ["example1", "example2", "example3"]
PORT_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _paper(name):
    return (
        getattr(ref_examples, f"{name}_tasks")(),
        getattr(ref_examples, f"{name}_fleet")(),
    )


def _plan_fields(plan):
    if plan is None:
        return None
    return (
        plan.feasible,
        [[(g.kind, g.task, g.start, g.end) for g in s.segments] for s in plan.scripts],
        [(s.task, s.devices, s.share_parts) for s in plan.splits],
        plan.unplaced,
        plan.executed_share,
        _plan_fields(plan.backup),
    )


def _assert_same(port, ref):
    """A port ScheduleResult equals a reference one, field for field."""
    for f in ("feasible", "chosen_rank", "n_placement_rejects", "total_power",
              "n_tss", "n_tfs", "n_tnfs"):
        assert getattr(port, f) == getattr(ref, f), f
    if ref.combo is None:
        assert port.combo is None
    else:
        assert port.combo.variant_idx == ref.combo.variant_idx
        assert port.combo.shares == ref.combo.shares
        assert port.combo.powers == ref.combo.powers
    assert _plan_fields(port.plan) == _plan_fields(ref.plan)


def _both(tasks, fleet, engine, *, exhaustive=None, **kw):
    ref = RefScheduler(fleet, engine="numpy", exhaustive=exhaustive).schedule(tasks, **kw)
    port = PADPSFRScheduler(fleet_from(fleet), engine=engine, exhaustive=exhaustive).schedule(
        tasks_from(tasks), **kw
    )
    _assert_same(port, ref)
    return port


# ---------------------------------------------------------------------------
# the paper's examples
# ---------------------------------------------------------------------------


def test_paper_configs_carry_across_field_for_field():
    for name in PAPER:
        tasks, fleet = _paper(name)
        assert tasks_from(tasks) == getattr(port_examples, f"{name}_tasks")()
        assert fleet_from(fleet) == getattr(port_examples, f"{name}_fleet")()


@pytest.mark.parametrize("engine", ["torch", "scalar"])
@pytest.mark.parametrize("name", PAPER)
@pytest.mark.parametrize("count_all", [True, False], ids=["all-rejects", "early-exit"])
@pytest.mark.parametrize("exhaustive", [None, False], ids=["exhaustive", "streaming"])
def test_paper_examples_match_reference(engine, name, count_all, exhaustive):
    tasks, fleet = _paper(name)
    _both(tasks, fleet, engine, exhaustive=exhaustive, count_all_rejects=count_all)


def test_example1_published_numbers():
    tasks, fleet = port_examples.example1_tasks(), port_examples.example1_fleet()
    res = PADPSFRScheduler(fleet, engine="torch").schedule(tasks, count_all_rejects=True)
    assert (res.n_tss, res.n_tfs, res.n_placement_rejects, res.chosen_rank) == (1024, 620, 146, 4)
    assert res.total_power == 31.5
    (sp,) = res.plan.splits
    assert sp.task == 2 and sp.devices == (1, 2)
    assert [round(p) for p in sp.share_parts] == [12, 12]


OPTIONS = [
    pytest.param(dict(resilience=1), id="resilience1"),
    pytest.param(dict(resilience=2), id="resilience2"),
    pytest.param(dict(resilience=4), id="resilience-all-devices"),
    pytest.param(dict(repay_init=False), id="preemptive"),
    pytest.param(dict(repay_init=False, t_capture=4.5, t_store=5.0), id="preemptive-resume"),
    pytest.param(dict(t_capture=12.0, t_store=12.0, repay_init=False, resilience=1),
                 id="preemptive-resilience1"),
]


@pytest.mark.parametrize("engine", ["torch", "scalar"])
@pytest.mark.parametrize("kw", OPTIONS)
@pytest.mark.parametrize("name", PAPER)
def test_paper_examples_with_placement_options(engine, kw, name):
    tasks, fleet = _paper(name)
    _both(tasks, fleet, engine, count_all_rejects=True, **kw)
    _both(tasks, fleet, engine, exhaustive=False, **kw)


# ---------------------------------------------------------------------------
# randomized heterogeneous instances
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["torch", "scalar"])
def test_randomized_hetero_instances_match_reference(engine):
    rng = np.random.default_rng(42)
    feasible = 0
    for i in range(120):
        tasks, fleet = _random_tasks(rng), _random_fleet(rng)
        res = _both(tasks, fleet, engine, count_all_rejects=bool(i % 2))
        feasible += res.feasible
    assert 20 < feasible < 120  # both verdicts exercised


@pytest.mark.parametrize("kw", OPTIONS[:2] + OPTIONS[3:])
def test_randomized_instances_with_placement_options(kw):
    rng = np.random.default_rng(17)
    for i in range(40):
        tasks, fleet = _random_tasks(rng, max_tasks=4), _random_fleet(rng)
        _both(tasks, fleet, "torch", count_all_rejects=bool(i % 2), **kw)
        if i % 4 == 0:
            _both(tasks, fleet, "scalar", exhaustive=False, **kw)


@pytest.mark.parametrize("block_size", [None, 1, 7], ids=["ramp", "b1", "b7"])
def test_block_size_invariance_on_streaming_path(block_size):
    rng = np.random.default_rng(5)
    for _ in range(15):
        tasks, fleet = _random_tasks(rng), _random_fleet(rng)
        ref = RefScheduler(fleet, engine="numpy", exhaustive=False).schedule(tasks)
        port = PADPSFRScheduler(
            fleet_from(fleet), engine="torch", exhaustive=False, block_size=block_size
        ).schedule(tasks_from(tasks))
        _assert_same(port, ref)


def test_deep_band_instance_quick():
    """The benchmark's quick deep instance (9 tasks x 4 variants, 5
    devices): the winner sits thousands of rows deep, past several ramp
    blocks, on the streaming and the exhaustive path."""
    from benchmarks.scheduler_scale import _deep_instance

    tasks, fleet = _deep_instance(True)
    ws = WalkStats()
    ref = RefScheduler(fleet, engine="numpy", exhaustive=False).schedule(tasks)
    port = PADPSFRScheduler(fleet_from(fleet), engine="torch", exhaustive=False).schedule(
        tasks_from(tasks), walk_stats=ws
    )
    _assert_same(port, ref)
    assert port.chosen_rank > 10_000
    assert ws.block_sizes[:4] == [64, 512, 4096, 32768]
    assert ws.rows == sum(ws.block_sizes)
    _both(tasks, fleet, "torch")


# ---------------------------------------------------------------------------
# enumeration: ComboBlock streams equal the reference's
# ---------------------------------------------------------------------------


def _assert_streams_equal(tasks, fleet, sizes_fn, resilience=0):
    got = list(port_blocks(tasks_from(tasks), fleet_from(fleet), sizes_fn(), resilience=resilience))
    want = list(ref_blocks(tasks, fleet, sizes_fn(), resilience=resilience))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.variant_idx, w.variant_idx)
        np.testing.assert_array_equal(g.total_power, w.total_power)
        np.testing.assert_array_equal(g.sum_shr, w.sum_shr)
        np.testing.assert_array_equal(g.shares, w.shares)
    return sum(len(w) for w in want)


@pytest.mark.parametrize("name", PAPER)
def test_paper_block_streams_match_reference(name):
    tasks, fleet = _paper(name)
    assert _assert_streams_equal(tasks, fleet, lambda: 64) > 0
    assert _assert_streams_equal(tasks, fleet, lambda: 64, resilience=1) >= 0


@pytest.mark.parametrize("block_sizes", [1, 3, 4096, None], ids=["b1", "b3", "b4096", "ramp"])
def test_randomized_block_streams_match_reference(block_sizes):
    rng = np.random.default_rng(101)
    rows = 0
    for _ in range(40):
        tasks, fleet = _random_tasks(rng), _random_fleet(rng)
        rows += _assert_streams_equal(
            tasks, fleet, (lambda: block_sizes) if block_sizes else block_ramp
        )
    assert rows > 200


def test_block_streams_under_exact_power_ties():
    rng = np.random.default_rng(42)
    ties = 0
    for _ in range(120):
        tasks, fleet = _tie_tasks(rng), _random_fleet(rng)
        feas = ref_search(tasks, fleet)
        ties += int((np.diff(feas.total_power[feas.tfs_indices_by_power()]) == 0).sum())
        _assert_streams_equal(tasks, fleet, lambda: 7)
    assert ties > 500  # the instances really tie


def test_exhaustive_feasibility_matches_reference():
    rng = np.random.default_rng(9)
    for k in (0, 1):
        for _ in range(30):
            tasks, fleet = _random_tasks(rng), _random_fleet(rng)
            if k >= fleet.n_f:
                continue
            want = ref_search(tasks, fleet, resilience=k)
            got = port_search(tasks_from(tasks), fleet_from(fleet), resilience=k)
            np.testing.assert_array_equal(got.sum_shr, want.sum_shr)
            np.testing.assert_array_equal(got.total_power, want.total_power)
            np.testing.assert_array_equal(got.fit_mask, want.fit_mask)
            np.testing.assert_array_equal(got.tfs_indices_by_power(), want.tfs_indices_by_power())


def test_homogeneous_fleet_survivors_match_reference():
    fleet = RefFleetSpec(n_f=5, t_slr=50.0, t_cfg=2.0)
    for k in range(5):
        assert fleet_from(fleet.survivors(k)) == fleet_from(fleet).survivors(k)


# ---------------------------------------------------------------------------
# the port's boundaries
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted(PORT_SRC.rglob("*.py")) + [PORT_SRC.parents[1] / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def _imported(path: Path) -> list[str]:
    """The modules a port file imports, at module or function level, as
    absolute dotted names (a relative import resolved against the file's
    package; ``from x import y`` as both ``x`` and ``x.y``)."""
    package = ("repro_torch", *path.relative_to(PORT_SRC).with_suffix("").parts[:-1])
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[:len(package) - node.level + 1]) if node.level else ""
            module = ".".join(p for p in (base, node.module or "") if p)
            out += [module] + [f"{module}.{a.name}" for a in node.names]
    return out


def _attributes(path: Path) -> set[str]:
    """Every attribute name a file reads (``x.name``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)}


def _imports_none_of(files, *above):
    def check():
        for path in files:
            for name in _imported(path):
                assert not name.startswith(above), f"{path.name} imports {name}"
    return check


def _kernel_counts_read_no_config():
    from repro_torch.configs.base import ModelConfig

    path = PORT_SRC / "kernels" / "counts.py"
    _imports_none_of([path], "repro_torch.configs")()
    fields = {f.name for f in dataclasses.fields(ModelConfig)} | {"layer_kinds", "mla"}
    assert not _attributes(path) & fields, sorted(_attributes(path) & fields)


def _engine_reads_no_family():
    assert "family" not in _attributes(PORT_SRC / "serve" / "engine.py")


# The port's layers, imports pointing one way: configs, sharding.ctx, trace
# and _tree under kernels, under models, under graphs, under serve, train
# and launch.  The serving engine asks the model what its family decides.
LAYER_RULES = {
    "kernels-import-nothing-above-them": _imports_none_of(
        sorted((PORT_SRC / "kernels").rglob("*.py")), "repro_torch.models", "repro_torch.serve",
        "repro_torch.train", "repro_torch.launch"),
    "train-imports-nothing-from-serve": _imports_none_of(
        sorted((PORT_SRC / "train").rglob("*.py")), "repro_torch.serve"),
    "serve-engine-reads-no-family": _engine_reads_no_family,
    "kernel-counts-read-no-config": _kernel_counts_read_no_config,
}


@pytest.mark.parametrize("rule", list(LAYER_RULES))
def test_port_layers_import_one_way(rule):
    LAYER_RULES[rule]()


@pytest.mark.parametrize("exhaustive", [False, True], ids=["stop-at-winner", "exhaustive"])
def test_record_state_returns_the_reference_plan_state(exhaustive):
    """``schedule(record_state=True)`` on Example 1 returns a PlanState
    whose recorded rows, verdicts and death depths equal the reference's."""
    tasks, fleet = _paper("example1")
    ref = RefScheduler(fleet, engine="numpy").schedule(
        tasks, record_state=True, record_exhaustive=exhaustive
    )
    port = PADPSFRScheduler(fleet_from(fleet), engine="torch").schedule(
        tasks_from(tasks), record_state=True, record_exhaustive=exhaustive
    )
    _assert_same(port, ref)
    st, want = port.plan_state, ref.plan_state
    assert type(st).__name__ == "PlanState" and st.engine == "torch"
    for name in ("rec_pow", "rec_sumshr", "rec_chosen", "rec_verdict", "rec_depth"):
        got, exp = getattr(st, name), getattr(want, name)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp, err_msg=name)
    assert st.complete_below == want.complete_below
    assert st.origin == want.origin == "cold"
    assert st.n_recorded >= port.chosen_rank + 1 == 5


@pytest.mark.parametrize(
    "modname",
    [
        "repro_torch.core.feasibility",
        "repro_torch.core.scheduler",
        "repro_torch.core.placement_batched",
        "repro_torch.core.replan",
    ],
)
def test_port_doctests(modname):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(modname), verbose=False)
    assert result.attempted > 0 and result.failed == 0
