"""The port's scheduling service against the JAX package's, event by event.

The reference's service traces — the random arrival/exit/failure traces
of ``tests/test_service_replay.py`` and its mixed 100-event churn trace
with device recoveries, at ``resilience`` 0 and 1 — run through the
reference's :class:`SchedulerService` on ``"numpy"`` / ``"scalar"`` and
through the port's on ``"torch"`` / ``"scalar"``, fed the same events.
After every event the two must agree exactly: the telemetry row (path,
admission, power, rank, reason), the live plan and its recorded
:class:`PlanState`, the re-record count; and the port's live plan must
equal a cold ``schedule()`` of its task set on its own engine.  Also
here: ``what_if_many`` against solo schedules, and the service's own
behaviours (admission, rollback, cache, LIFO recovery) on the port.
"""

import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import DeviceProfile as RefDeviceProfile  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.service import SchedulerService as RefService  # noqa: E402
from repro_torch.convert import fleet_from, task_from, tasks_from  # noqa: E402
from repro_torch.core import FleetSpec, PADPSFRScheduler, Task, TaskVariant  # noqa: E402
from repro_torch.service import (  # noqa: E402
    DeviceFailure,
    DeviceRecovery,
    ReplanTelemetry,
    SchedulerService,
    TaskArrival,
    TaskExit,
)

from test_service_replay import _rand_task  # noqa: E402
from test_torch_replan import assert_same_plan, assert_same_state  # noqa: E402
from test_torch_scheduler import _assert_same  # noqa: E402

ENGINES = [("torch", "numpy"), ("scalar", "scalar")]
ENGINE_IDS = ["torch-vs-numpy", "scalar-vs-scalar"]
# The reference traces' seeds are keyed on the engine's index in its own
# engine list ("scalar", "numpy", ...).
REF_INDEX = {"scalar": 0, "numpy": 1}
TELEMETRY = ("event", "admitted", "path", "n_tasks", "feasible", "total_power",
             "chosen_rank", "reason")


class Pair:
    """A reference service and a port service fed the same events."""

    def __init__(self, ref_fleet, engines, **kw):
        port_engine, ref_engine = engines
        self.ref = RefService(ref_fleet, engine=ref_engine, **kw)
        self.port = SchedulerService(fleet_from(ref_fleet), engine=port_engine, **kw)

    def submit(self, ref_task):
        return self._check(self.ref.submit(ref_task), self.port.submit(task_from(ref_task)))

    def remove(self, name):
        return self._check(self.ref.remove(name), self.port.remove(name))

    def fail_device(self, device=-1):
        return self._check(self.ref.fail_device(device), self.port.fail_device(device))

    def recover_device(self):
        return self._check(self.ref.recover_device(), self.port.recover_device())

    def _check(self, ref_row, port_row):
        assert isinstance(port_row, ReplanTelemetry)
        for f in TELEMETRY:
            assert getattr(port_row, f) == getattr(ref_row, f), (f, ref_row.event)
        ref, port = self.ref, self.port
        assert port.tasks == tasks_from(ref.tasks)
        assert port.fleet == fleet_from(ref.fleet)
        assert port.rerecord_count == ref.rerecord_count
        assert port.engine == port._sched.engine
        assert (port.plan is None) == (ref.plan is None)
        if ref.plan is not None:
            _assert_same(port.plan, ref.plan)
            assert_same_state(port.plan.plan_state, ref.plan.plan_state)
        assert_matches_cold(port)
        return port_row


def assert_matches_cold(svc):
    """The live plan equals a cold schedule() of the live task set."""
    if not svc.tasks:
        assert svc.plan is None
        return
    cold = PADPSFRScheduler(svc.fleet, engine=svc.engine).schedule(
        svc.tasks, **svc.placement_kw
    )
    assert svc.plan is not None
    assert_same_plan(svc.plan, cold)


# ---------------------------------------------------------------------------
# the reference's traces, through both services
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
def test_random_event_traces_match_reference(engines):
    """``tests/test_service_replay.py``'s random traces (plan cache on and
    off, exhaustive recording on and off), event by event."""
    ref_engine = engines[1]
    n_trials = 6 if ref_engine == "scalar" else 10
    for seed in range(n_trials):
        rng = random.Random(1000 * REF_INDEX[ref_engine] + seed)
        fleet = RefFleetSpec(n_f=rng.randint(2, 3), t_slr=rng.uniform(15, 40),
                             t_cfg=rng.uniform(0.0, 1.5))
        pair = Pair(fleet, engines, record_exhaustive=bool(seed % 2),
                    cache_plans=bool(seed % 3))
        counter = 0
        n_events = 0
        for _ in range(rng.randint(3, 6)):
            roll = rng.random()
            if roll < 0.55 or not pair.ref.tasks:
                counter += 1
                pair.submit(_rand_task(rng, f"t{counter}", int_powers=seed % 2 == 0))
            elif roll < 0.9:
                pair.remove(rng.choice(pair.ref.tasks).name)
            elif pair.ref.fleet.n_f > 1:
                pair.fail_device()
            else:
                continue
            n_events += 1
        assert len(pair.port.telemetry) == n_events


def _mixed_trace(rng, pair, n_events):
    """``tests/test_service_replay.py``'s mixed churn trace, on both."""
    counter = 0
    paths = []
    for _ in range(n_events):
        roll = rng.random()
        svc = pair.ref
        n_alive = len(svc.tasks)
        if (roll < 0.45 and n_alive < 4) or n_alive == 0:
            counter += 1
            tel = pair.submit(_rand_task(rng, f"t{counter}", int_powers=True))
        elif roll < 0.80 and n_alive:
            tel = pair.remove(rng.choice(svc.tasks).name)
        elif roll < 0.90 and svc.fleet.n_f > svc.resilience + 1:
            tel = pair.fail_device()
        else:
            tel = pair.recover_device()
        paths.append(tel.path)
    return paths


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("resilience", [0, 1])
def test_churn_trace_matches_reference(engines, resilience):
    """The reference's 100+-event mixed arrival/exit/failure/recovery
    trace with the re-record policy live (``max_stale=5``): every event's
    telemetry, plan, state and re-record count equal the reference's."""
    ref_engine = engines[1]
    rng = random.Random(4242 + 17 * REF_INDEX[ref_engine] + resilience)
    pair = Pair(RefFleetSpec(n_f=3, t_slr=35.0, t_cfg=1.0), engines,
                resilience=resilience, max_stale=5)
    n_events = 60 if ref_engine == "scalar" else 110
    paths = _mixed_trace(rng, pair, n_events)
    assert len(pair.port.telemetry) == n_events
    solved = [p for p in paths if p not in ("admission", "noop")]
    assert any(p in ("warm", "warm_exit", "warm_failure") for p in solved)
    assert "cache" in solved


def test_bench_churn_trace_matches_reference():
    """``bench_churn``'s 200-event trace (``default_rng(11)``, 4 devices,
    ``max_stale=5``) — the trace ``chip_smoke.py`` phase 12 replays on the
    card — event by event on the plain engine against the reference's,
    for as long as the reference answers.  On Python >= 3.12 the
    reference's service stops at event 150, an arrival, on its
    replanner's "lost its incumbent row" assertion (an incumbent power
    from a compensated ``sum()`` an ulp below its row's fold; see
    ``repro_torch.core.replan._finish_warm``).  The port declines that
    warm path and answers; from there it runs alone, every plan still
    equal to a cold ``schedule()``."""
    from benchmarks.scheduler_scale import _churn_task

    rng = np.random.default_rng(11)
    pair = Pair(RefFleetSpec(n_f=4, t_slr=35.0, t_cfg=1.0), ENGINES[0], max_stale=5)
    port = pair.port
    ref_stopped_at = None
    counter = 0
    for i in range(200):
        roll = float(rng.random())
        n_alive = len(port.tasks)
        if (roll < 0.55 and n_alive < 8) or n_alive < 2:
            counter += 1
            task = _churn_task(rng, f"c{counter}")
            event, args, port_args = "submit", (task,), (task_from(task),)
        elif roll < 0.80 and n_alive:
            name = port.tasks[int(rng.integers(0, n_alive))].name
            event, args, port_args = "remove", (name,), (name,)
        elif roll < 0.90 and port.fleet.n_f > 1:
            event, args, port_args = "fail_device", (), ()
        else:
            event, args, port_args = "recover_device", (), ()
        if ref_stopped_at is None:
            try:
                getattr(pair, event)(*args)
                continue
            except AssertionError as e:
                if "lost its incumbent row" not in str(e):
                    raise
                ref_stopped_at = i
        getattr(port, event)(*port_args)
        assert_matches_cold(port)
    assert ref_stopped_at is None or ref_stopped_at >= 100
    solved = [t for t in port.telemetry if t.path not in ("admission", "noop")]
    hits = [t for t in solved if t.path in ("cache", "warm", "warm_exit", "warm_failure")]
    assert len(solved) == 156 and len(hits) / len(solved) >= 0.80


def test_rerecord_policy_fires_and_matches_reference():
    rng = random.Random(99)
    pair = Pair(RefFleetSpec(n_f=3, t_slr=35.0, t_cfg=1.0), ENGINES[0], max_stale=2)
    _mixed_trace(rng, pair, 40)
    assert pair.port.rerecord_count >= 1


def test_heterogeneous_failure_and_recovery_match_reference():
    """Heterogeneous fleets: a failure drops the indexed profile, a
    recovery puts it back at its index (LIFO), on both services."""
    fleet = RefFleetSpec.heterogeneous([
        RefDeviceProfile(t_slr=40.0, t_cfg=2.0),
        RefDeviceProfile(t_slr=80.0, t_cfg=0.0, klass="gpu"),
        RefDeviceProfile(t_slr=60.0, t_cfg=1.0),
    ])
    rng = random.Random(3)
    pair = Pair(fleet, ENGINES[0])
    for i in range(4):
        pair.submit(_rand_task(rng, f"h{i}"))
    pair.fail_device(0)
    pair.fail_device(1)
    pair.recover_device()
    pair.remove(pair.ref.tasks[0].name)
    pair.recover_device()
    assert pair.port.fleet == fleet_from(fleet)


# ---------------------------------------------------------------------------
# what_if_many
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1])
def test_what_if_many_matches_solo_schedules_and_reference(k):
    rng = random.Random(17 + k)
    ref_fleet = RefFleetSpec(n_f=3, t_slr=35.0, t_cfg=1.0)
    pair = Pair(ref_fleet, ENGINES[0], resilience=k)
    for i in range(3):
        pair.submit(_rand_task(rng, f"s{i}", int_powers=True))
    cands = [_rand_task(rng, f"c{i}", int_powers=bool(i % 2)) for i in range(12)]
    before = (pair.port.tasks, pair.port.plan, len(pair.port.telemetry))
    got = pair.port.what_if_many(tasks_from(cands))
    want = pair.ref.what_if_many(cands)
    assert (pair.port.tasks, pair.port.plan, len(pair.port.telemetry)) == before
    sched = PADPSFRScheduler(pair.port.fleet, engine="torch")
    for c, g, w in zip(cands, got, want, strict=True):
        _assert_same(g, w)
        _assert_same(g, sched.schedule(pair.port.tasks + (task_from(c),), resilience=k))
    assert any(g.feasible for g in got)


# ---------------------------------------------------------------------------
# the service's own behaviours, on the port
# ---------------------------------------------------------------------------


def _v(th, pw):
    return TaskVariant(cu=1, throughput=th, power=pw)


def _abc():
    return (
        Task("a", period=10.0, data=20.0, init_interval=1.0,
             variants=(_v(2.0, 5.0), _v(4.0, 8.0))),
        Task("b", period=10.0, data=40.0, init_interval=1.0,
             variants=(_v(4.0, 4.0), _v(8.0, 6.0))),
        Task("c", period=10.0, data=30.0, init_interval=1.0,
             variants=(_v(6.0, 3.0), _v(12.0, 9.0))),
    )


def test_service_defaults_to_the_card():
    fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
    if torch.cuda.is_available():
        assert SchedulerService(fleet).engine == "cuda"
    else:
        with pytest.raises(RuntimeError, match="engine='torch'"):
            SchedulerService(fleet)


def test_admission_filter_and_rollback():
    a, b, _ = _abc()
    svc = SchedulerService(FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0), engine="torch")
    assert svc.submit(a).admitted and svc.submit(b).admitted
    before = svc.plan
    dup = svc.submit(Task("a", period=9.0, data=5.0, init_interval=0.0, variants=(_v(5.0, 1.0),)))
    assert not dup.admitted and dup.path == "admission" and "duplicate" in dup.reason
    hopeless = svc.submit(Task("big", period=10.0, data=10000.0, init_interval=1.0,
                               variants=(_v(2.0, 1.0),)))
    assert not hopeless.admitted and "eq-7" in hopeless.reason
    tight = svc.submit(Task("tight", period=10.0, data=48.0, init_interval=29.0,
                            variants=(_v(6.0, 1.0),)))
    assert not tight.admitted and tight.path in ("warm", "general")
    assert svc.tasks == (a, b) and svc.plan is before
    assert_matches_cold(svc)


def test_plan_cache_and_telemetry_paths():
    a, b, c = _abc()
    svc = SchedulerService(FleetSpec(n_f=3, t_slr=30.0, t_cfg=1.0), engine="torch", max_stale=1)
    rows = svc.replay([TaskArrival(a), TaskArrival(b), TaskArrival(c)])
    assert [r.path for r in rows] == ["general", "warm", "warm"]
    assert svc.rerecord_count >= 1
    assert svc.remove("a").path == "warm_exit"
    assert svc.fail_device().path == "warm_failure"
    assert_matches_cold(svc)
    svc.recover_device()
    back = svc.replay([TaskExit("c"), TaskArrival(c)])[-1]
    assert back.path == "cache"
    assert_matches_cold(svc)


def test_device_failure_validation_and_lifo_recovery():
    a, b, _ = _abc()
    svc = SchedulerService(FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0), engine="scalar")
    svc.submit(a)
    svc.submit(b)
    with pytest.raises(ValueError, match="out of range"):
        svc.fail_device(2)
    assert svc.replay([DeviceFailure()])[0].admitted and svc.fleet.n_f == 1
    last = svc.fail_device()
    assert not last.admitted and "last device" in last.reason
    assert svc.replay([DeviceRecovery()])[0].admitted and svc.fleet.n_f == 2
    assert svc._sched.engine == "scalar"
    assert not svc.recover_device().admitted
    assert_matches_cold(svc)
    assert np.isfinite(svc.plan.total_power)
