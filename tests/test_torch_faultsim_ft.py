"""The port's fault-injection simulator and ``ft/`` against the JAX package's.

``make_failure_trace`` draws from ``np.random.default_rng(seed)`` in both
packages, so the traces are equal draw for draw; ``run_fault_injection``
replays them through each package's service (the reference on
``"numpy"``, the port on ``"torch"`` and ``"scalar"``) and the per-event
records — fleet size, plan survival, misses, replanned power — must be
equal.  On the reference's crafted 4-task, 4-device instance the
resilience guarantee holds on the port as it does there: zero misses at
k = 1 and 2 under any seeded trace, all 4 tasks missing at k = 0, and the
power ladder 8 / 20 / 32 W.  ``FleetHealth`` (with an injected clock),
``StragglerDetector`` and ``ElasticController(engine="torch")`` replay
the reference's fault-tolerance scenarios with the reference's outcomes.
"""

import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_examples as ref_examples  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.core import Task as RefTask  # noqa: E402
from repro.core import TaskVariant as RefTaskVariant  # noqa: E402
from repro.ft import ElasticController as RefElastic  # noqa: E402
from repro.ft import FleetHealth as RefHealth  # noqa: E402
from repro.ft import StragglerDetector as RefStraggler  # noqa: E402
from repro.service import make_failure_trace as ref_trace  # noqa: E402
from repro.service import power_premium as ref_premium  # noqa: E402
from repro.service import run_fault_injection as ref_inject  # noqa: E402
from repro_torch.configs.paper_examples import example1_fleet, example1_tasks  # noqa: E402
from repro_torch.convert import fleet_from, tasks_from  # noqa: E402
from repro_torch.core import FleetSpec, PADPSFRScheduler  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    ElasticController,
    FleetHealth,
    SliceState,
    StragglerDetector,
)
from repro_torch.service import (  # noqa: E402
    DeviceFailure,
    DeviceRecovery,
    make_failure_trace,
    power_premium,
    run_fault_injection,
)

from test_torch_scheduler import _assert_same  # noqa: E402

PORT_ENGINES = ["torch", "scalar"]


def _crafted(n_f=4):
    """The reference's premium-ladder instance: n_f share-25 tasks fill n_f
    devices, so every resilience level forces hot share-10 upgrades."""
    fleet = RefFleetSpec(n_f=n_f, t_slr=30.0, t_cfg=1.0)
    tasks = [
        RefTask(name=f"R{i}", period=10.0, data=20.0, init_interval=1.0,
                variants=(RefTaskVariant(cu=1, throughput=2.4, power=2.0),
                          RefTaskVariant(cu=2, throughput=6.0, power=8.0)))
        for i in range(n_f)
    ]
    return fleet, tasks


# ---------------------------------------------------------------------------
# failure traces and fault injection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recover", [False, True])
def test_failure_traces_match_reference_draw_for_draw(recover):
    for seed in range(8):
        for n_f, n_failures in ((4, 1), (4, 2), (4, 3), (7, 5)):
            got = make_failure_trace(n_f, n_failures, seed=seed, recover=recover)
            want = ref_trace(n_f, n_failures, seed=seed, recover=recover)
            assert [e.describe() for e in got] == [e.describe() for e in want]
            assert all(isinstance(e, (DeviceFailure, DeviceRecovery)) for e in got)
    with pytest.raises(ValueError):
        make_failure_trace(3, 3)


def _same_records(got, want):
    assert (got.resilience, got.seed, got.n_tasks, got.n_failures) == (
        want.resilience, want.seed, want.n_tasks, want.n_failures)
    assert got.initial_power == want.initial_power
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records, strict=True):
        assert (g.step, g.event, g.n_f_after, g.plan_survived, g.misses,
                g.replanned_feasible, g.total_power) == (
            w.step, w.event, w.n_f_after, w.plan_survived, w.misses,
            w.replanned_feasible, w.total_power)
    assert got.total_misses == want.total_misses and got.survived == want.survived


@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("recover", [False, True], ids=["fail", "fail-recover"])
def test_fault_injection_records_match_reference(engine, k, recover):
    ref_fleet, ref_tasks = _crafted()
    n_failures = max(k, 1)
    for seed in range(8):
        got = run_fault_injection(fleet_from(ref_fleet), tasks_from(ref_tasks), resilience=k,
                                  n_failures=n_failures, seed=seed, recover=recover,
                                  engine=engine)
        want = ref_inject(ref_fleet, ref_tasks, resilience=k, n_failures=n_failures,
                          seed=seed, recover=recover, engine="numpy")
        _same_records(got, want)
        if k:
            assert got.survived and got.total_misses == 0
            assert all(r.plan_survived for r in got.records)


def test_unprotected_plan_misses_every_task():
    ref_fleet, ref_tasks = _crafted()
    r = run_fault_injection(fleet_from(ref_fleet), tasks_from(ref_tasks), resilience=0,
                            n_failures=1, seed=0, engine="torch")
    assert not r.survived and r.total_misses == len(ref_tasks) == 4


def test_fault_injection_rejects_inadmissible_instance():
    ref_fleet, ref_tasks = _crafted(n_f=3)
    with pytest.raises(ValueError, match="rejected at resilience=2"):
        run_fault_injection(fleet_from(ref_fleet), tasks_from(ref_tasks), resilience=2,
                            n_failures=2, engine="torch")


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_power_premium_ladder_matches_reference(engine):
    ref_fleet, ref_tasks = _crafted()
    got = power_premium(fleet_from(ref_fleet), tasks_from(ref_tasks), ks=(0, 1, 2), engine=engine)
    assert got == ref_premium(ref_fleet, ref_tasks, ks=(0, 1, 2), engine="numpy")
    assert [got[k]["power"] for k in (0, 1, 2)] == [8.0, 20.0, 32.0]
    assert [got[k]["premium_pct"] for k in (0, 1, 2)] == pytest.approx([0.0, 150.0, 300.0])


def test_power_premium_zero_power_baseline():
    fleet = RefFleetSpec(n_f=4, t_slr=30.0, t_cfg=1.0)
    tasks = [RefTask(name=f"Z{i}", period=10.0, data=20.0, init_interval=1.0,
                     variants=(RefTaskVariant(cu=1, throughput=2.4, power=0.0),))
             for i in range(2)]
    got = power_premium(fleet_from(fleet), tasks_from(tasks), ks=(0, 1), engine="torch")
    assert got == ref_premium(fleet, tasks, ks=(0, 1), engine="numpy")
    assert got[1]["premium_pct"] == 0.0


def test_fault_injection_defaults_to_the_card():
    fleet, tasks = _crafted()
    fleet, tasks = fleet_from(fleet), tasks_from(tasks)
    if torch.cuda.is_available():
        assert run_fault_injection(fleet, tasks, resilience=1).survived
        assert power_premium(fleet, tasks)[2]["power"] == 32.0
        return
    with pytest.raises(RuntimeError, match="engine='torch'"):
        run_fault_injection(fleet, tasks, resilience=1)
    with pytest.raises(RuntimeError, match="engine='torch'"):
        power_premium(fleet, tasks)


# ---------------------------------------------------------------------------
# ft: health, elastic re-planning, stragglers
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_health_state_machine_matches_reference():
    clocks = (FakeClock(), FakeClock())
    port = FleetHealth(3, timeout=30, suspect=10, clock=clocks[0])
    ref = RefHealth(3, timeout=30, suspect=10, clock=clocks[1])
    assert port.n_up == ref.n_up == 3

    def step(t, beats=(), poll=True):
        for c in clocks:
            c.t = t
        for h in (port, ref):
            for j in beats:
                h.heartbeat(j)
        if poll:
            got, want = port.poll(), ref.poll()
            assert {j: s.value for j, s in got.items()} == {j: s.value for j, s in want.items()}
            return got
        return None

    states = step(15.0, beats=(0,))
    assert states[0] == SliceState.UP and states[1] == SliceState.SUSPECT
    states = step(45.0, beats=(0,))
    assert states[0] == SliceState.UP and states[1] == SliceState.DOWN
    assert port.n_up == ref.n_up == 1
    port.revive(1)
    ref.revive(1)
    assert step(46.0)[1] == SliceState.UP
    port.mark_down(2)
    ref.mark_down(2)
    step(47.0, beats=(2,))
    assert port.up_slices() == ref.up_slices() == [0, 1]


def _same_event(got, want):
    assert (got.reason, got.n_slices, got.dropped_tasks) == (
        want.reason, want.n_slices, want.dropped_tasks)
    _assert_same(got.result, want.result)


def test_elastic_replan_on_failure_and_recovery_matches_reference():
    ref = RefElastic(ref_examples.example1_fleet(), ref_examples.example1_tasks())
    port = ElasticController(example1_fleet(), example1_tasks(), engine="torch")
    assert port.engine == "torch"
    _same_event(port.events[0], ref.events[0])
    p0 = port.current.total_power
    _same_event(port.on_slice_down(3), ref.on_slice_down(3))
    ev = port.on_slice_up(3)
    _same_event(ev, ref.on_slice_up(3))
    assert ev.n_slices == 4 and ev.result.feasible and ev.result.total_power == p0


def test_elastic_sheds_tasks_like_reference():
    ref = RefElastic(RefFleetSpec(n_f=2, t_slr=60.0, t_cfg=6.0), ref_examples.example1_tasks())
    port = ElasticController(FleetSpec(n_f=2, t_slr=60.0, t_cfg=6.0), example1_tasks(),
                             engine="scalar")
    _same_event(port.events[0], ref.events[0])
    assert port.events[0].dropped_tasks
    assert [t.name for t in port.active_tasks] == [t.name for t in ref.active_tasks]
    assert "T1" in {t.name for t in port.active_tasks}


def test_elastic_poll_on_heartbeat_loss_matches_reference():
    clocks = (FakeClock(), FakeClock())
    port_h = FleetHealth(4, timeout=30, suspect=10, clock=clocks[0])
    ref_h = RefHealth(4, timeout=30, suspect=10, clock=clocks[1])
    port = ElasticController(example1_fleet(), example1_tasks(), health=port_h, engine="torch")
    ref = RefElastic(ref_examples.example1_fleet(), ref_examples.example1_tasks(), health=ref_h)
    for c in clocks:
        c.t = 31.0
    for j in (0, 1, 2):
        port_h.heartbeat(j)
        ref_h.heartbeat(j)
    ev = port.poll()
    _same_event(ev, ref.poll())
    assert ev.n_slices == 3 and len(port.events) == len(ref.events) == 2
    assert port.poll() is None and ref.poll() is None


def test_elastic_controller_defaults_to_the_card():
    if torch.cuda.is_available():
        ctl = ElasticController(example1_fleet(), example1_tasks())
        assert ctl.engine == "cuda" and ctl.current.total_power == 31.5
        return
    with pytest.raises(RuntimeError, match="engine='torch'"):
        ElasticController(example1_fleet(), example1_tasks())


def test_elastic_plan_equals_a_cold_schedule():
    port = ElasticController(example1_fleet(), example1_tasks(), engine="torch")
    ev = port.on_slice_down(0)
    cold = PADPSFRScheduler(example1_fleet().with_devices(3), engine="torch").schedule(
        port.active_tasks)
    _assert_same(ev.result, cold)


def test_straggler_detection_matches_reference():
    port = StragglerDetector(threshold=1.5, patience=3)
    ref = RefStraggler(threshold=1.5, patience=3)
    steps = [(0, 1.0, 1.0)] * 10 + [(1, 5.0, 1.0)] * 10 + [(2, 1.4, 1.0), (2, 2.2, 1.0)] * 6
    for j, t, p in steps:
        assert port.observe(j, t, p) == ref.observe(j, t, p)
    assert port.stragglers() == ref.stragglers() == [1, 2]
    port.reset(1)
    ref.reset(1)
    assert port.stragglers() == ref.stragglers() == [2]
