"""The port's delta replanner against the JAX package's, exactly.

The same instances and the same deltas — arrivals (chained through the
recorded root), exits, device failures on homogeneous and heterogeneous
fleets, and general edits that fall back to a fresh bounded walk — go
through the reference's replanner on its ``"numpy"`` and ``"scalar"``
engines and through the port's on ``"torch"`` and ``"scalar"``.  Every
recorded :class:`PlanState` array (``rec_pow``, ``rec_sumshr``,
``rec_chosen``, ``rec_verdict``, ``rec_depth``), ``complete_below``,
``origin`` and every result field must be equal: both packages run the
same host float64 folds in the same order and the eager engines resolve
every dispatched block.  Also here: the enumerator's ``cover_prune``
hook, ``_emission_order`` and ``_suffix_max_bounds`` on exact power
ties, and the reference's replan-level scenarios on the port.
"""

import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import DeviceProfile as RefDeviceProfile  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.core import PADPSFRScheduler as RefScheduler  # noqa: E402
from repro.core import Task as RefTask  # noqa: E402
from repro.core import TaskVariant as RefTaskVariant  # noqa: E402
from repro.core import feasibility as ref_feas  # noqa: E402
from repro_torch.convert import fleet_from, tasks_from  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DeviceProfile,
    FleetSpec,
    PADPSFRScheduler,
    PlanState,
    Task,
    TaskVariant,
)
from repro_torch.core import WalkStats, feasibility as port_feas  # noqa: E402
from repro_torch.core import replan as port_replan  # noqa: E402

from test_block_enumeration import _tie_tasks  # noqa: E402
from test_placement_batched import _random_fleet, _random_tasks  # noqa: E402
from test_service_replay import _rand_task  # noqa: E402
from test_torch_scheduler import _assert_same  # noqa: E402

# (port engine, reference engine): the reference's jax/pallas engines are
# not held against (its jax version lacks enable_x64).
ENGINES = [("torch", "numpy"), ("scalar", "scalar")]
ENGINE_IDS = ["torch-vs-numpy", "scalar-vs-scalar"]
STATE_ARRAYS = ("rec_pow", "rec_sumshr", "rec_chosen", "rec_verdict", "rec_depth")


def assert_same_state(port, ref):
    """A port PlanState equals a reference one, array for array."""
    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert isinstance(port, PlanState)
    for name in STATE_ARRAYS:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.complete_below == ref.complete_below
    assert port.origin == ref.origin
    assert port.placement_kw == ref.placement_kw
    assert (port.base is None) == (ref.base is None)
    assert [t.name for t in port.appended] == [t.name for t in ref.appended]
    assert port.frontier_coverage == ref.frontier_coverage
    assert (port.enum is None) == (ref.enum is None)
    _assert_same(port.result, ref.result)


def assert_same_plan(a, b):
    """Same winner, rank, rejects and placement (n_tfs may differ: warm
    and recorded results report -1, a cold exhaustive walk counts it)."""
    assert a.feasible == b.feasible
    assert a.chosen_rank == b.chosen_rank
    assert a.n_placement_rejects == b.n_placement_rejects
    assert a.total_power == b.total_power
    if b.feasible:
        assert a.combo == b.combo
        assert str(a.plan) == str(b.plan)


def _pair(ref_fleet, engines, **kw):
    port_engine, ref_engine = engines
    return (
        PADPSFRScheduler(fleet_from(ref_fleet), engine=port_engine, **kw),
        RefScheduler(ref_fleet, engine=ref_engine, **kw),
    )


def _record_both(ref_tasks, ref_fleet, engines, *, exhaustive, **kw):
    port_s, ref_s = _pair(ref_fleet, engines)
    ref = ref_s.schedule(ref_tasks, record_state=True, record_exhaustive=exhaustive, **kw)
    port = port_s.schedule(
        tasks_from(ref_tasks), record_state=True, record_exhaustive=exhaustive, **kw
    )
    _assert_same(port, ref)
    assert_same_state(port.plan_state, ref.plan_state)
    return port_s, ref_s, port, ref


# ---------------------------------------------------------------------------
# the recorded walk
# ---------------------------------------------------------------------------


def _band_tasks(n_t, nv, seed, base, dyadic=True):
    """The JAX package's deep band recipe (benchmarks/scheduler_scale.py),
    at the reference's types: rows pass eq. 7 but fail placement for a
    long band, so recordings hold real rejects with death depths.

    ``dyadic`` rounds powers to multiples of 1/64, so every power sum is
    exact: Python's compensated ``sum()`` (the incumbent's power) and the
    enumerator's left fold then agree, which the JAX package's replanner
    needs to answer (see ``test_warm_paths_decline_on_an_ulp_lost_incumbent``)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n_t):
        pws = np.sort(rng.uniform(3.0, 9.0, nv))
        if dyadic:
            pws = np.round(pws * 64.0) / 64.0
        shr = np.maximum(base - 5.0 * pws + rng.uniform(0, 1.0, nv), 0.5)
        ths = 1.0 * 100.0 / (50.0 * shr)
        tasks.append(RefTask(
            name=f"B{i}", period=50.0, data=1.0, init_interval=float(rng.uniform(8.0, 16.0)),
            variants=tuple(RefTaskVariant(cu=j + 1, throughput=float(t), power=float(p))
                           for j, (t, p) in enumerate(zip(ths, pws, strict=True))),
        ))
    return tasks


def _instances():
    """Random heterogeneous instances, tie-heavy homogeneous ones and a
    small band instance with a winner some thousand rows deep."""
    rng = np.random.default_rng(2024)
    out = [(_random_tasks(rng, max_tasks=4), _random_fleet(rng, max_devices=4))
           for _ in range(8)]
    for _ in range(4):
        n_f = int(rng.integers(1, 4))
        out.append((_tie_tasks(rng, max_tasks=4),
                    RefFleetSpec(n_f=n_f, t_slr=60.0, t_cfg=float(rng.uniform(0, 3)))))
    out.append((_band_tasks(6, 3, seed=7, base=80.0), RefFleetSpec(n_f=3, t_slr=100.0, t_cfg=0.0)))
    return out


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("exhaustive", [False, True], ids=["stop-at-winner", "exhaustive"])
@pytest.mark.parametrize("k", [0, 1])
def test_recorded_state_matches_reference(engines, exhaustive, k):
    for ref_tasks, ref_fleet in _instances():
        _record_both(ref_tasks, ref_fleet, engines, exhaustive=exhaustive, resilience=k)


def test_band_recording_holds_rejects_with_death_depths():
    """The band instance's recording is not trivial: it holds rejects
    that died inside the task prefix, so the exit path's depth transfer
    is exercised by the replan tests below."""
    ref_tasks, ref_fleet = _instances()[-1]
    _, _, port, _ = _record_both(ref_tasks, ref_fleet, ENGINES[0], exhaustive=True)
    st = port.plan_state
    assert port.chosen_rank > 100
    assert (st.rec_verdict == port_replan.VERDICT_REJECT).sum() >= port.chosen_rank
    died = st.rec_depth[(st.rec_depth >= 0) & (st.rec_depth < len(st.tasks))]
    assert died.size > 0
    assert st.frontier_coverage == 1.0 and st.complete_below == np.inf


def test_record_state_without_tasks_and_beyond_resilience():
    ref_fleet = RefFleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
    for tasks, kw in (([], {}), (_abc(), dict(resilience=2))):
        _record_both(tasks, ref_fleet, ENGINES[0], exhaustive=True, **kw)


# ---------------------------------------------------------------------------
# replans over every delta kind
# ---------------------------------------------------------------------------


def _v(th, pw):
    return RefTaskVariant(cu=1, throughput=th, power=pw)


def _abc():
    return [
        RefTask("a", period=10.0, data=20.0, init_interval=1.0,
                variants=(_v(2.0, 5.0), _v(4.0, 8.0))),
        RefTask("b", period=10.0, data=40.0, init_interval=1.0,
                variants=(_v(4.0, 4.0), _v(8.0, 6.0))),
        RefTask("c", period=10.0, data=30.0, init_interval=1.0,
                variants=(_v(6.0, 3.0), _v(12.0, 9.0))),
    ]


def _drop_device(fleet, i):
    if fleet.is_heterogeneous:
        devs = fleet.devices[:i] + fleet.devices[i + 1:]
        return RefFleetSpec.heterogeneous(devs, name=fleet.name)
    return RefFleetSpec(n_f=fleet.n_f - 1, t_slr=fleet.t_slr, t_cfg=fleet.t_cfg,
                        name=fleet.name)


def _delta(rng, pyrng, kind, tasks, fleet, counter):
    """One delta of ``kind`` on (tasks, fleet): the new (tasks, fleet)."""
    if kind == "arrival":
        return tasks + [_rand_task(pyrng, f"n{counter}", int_powers=counter % 2 == 0)], fleet
    if kind == "exit":
        p = int(rng.integers(len(tasks)))
        return tasks[:p] + tasks[p + 1:], fleet
    if kind == "failure":
        return tasks, _drop_device(fleet, int(rng.integers(fleet.n_f)))
    # general: the last task swaps to the front (no warm path applies)
    return tasks[-1:] + tasks[:-1], fleet


def _replan_both(port_s, ref_s, port_state, ref_state, ref_tasks, ref_fleet, **kw):
    fleet_kw_ref = {} if ref_fleet == ref_state.fleet else dict(fleet=ref_fleet)
    fleet_kw_port = {} if not fleet_kw_ref else dict(fleet=fleet_from(ref_fleet))
    ref = ref_s.replan(ref_state, ref_tasks, **fleet_kw_ref, **kw)
    port = port_s.replan(port_state, tasks_from(ref_tasks), **fleet_kw_port, **kw)
    _assert_same(port, ref)
    assert_same_state(port.plan_state, ref.plan_state)
    # and the warm plan is the cold one, on the port's own engine
    cold = PADPSFRScheduler(fleet_from(ref_fleet), engine=port_s.engine).schedule(
        tasks_from(ref_tasks), resilience=kw.get("resilience", 0)
    )
    assert_same_plan(port, cold)
    return port, ref


KINDS = ["arrival", "exit", "failure", "general"]


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("exhaustive", [False, True], ids=["stop-at-winner", "exhaustive"])
def test_replan_chains_match_reference(engines, k, exhaustive):
    """Random chains of four deltas from one recording: every replan's
    result and emitted state equal the reference's, and its plan equals
    a cold schedule() of the same instance."""
    origins = set()
    n_seeds = 6 if engines[0] == "torch" else 3
    for seed in range(n_seeds):
        rng = np.random.default_rng(500 + seed)
        pyrng = random.Random(500 + seed)
        if seed % 2:
            ref_fleet = _random_fleet(rng, max_devices=4)
        else:
            ref_fleet = RefFleetSpec(n_f=int(rng.integers(2, 5)), t_slr=float(rng.uniform(15, 40)),
                                     t_cfg=float(rng.uniform(0.0, 1.5)))
        ref_tasks = [_rand_task(pyrng, f"t{i}", int_powers=bool(seed % 2)) for i in range(3)]
        port_s, ref_s, port, ref = _record_both(ref_tasks, ref_fleet, engines,
                                                exhaustive=exhaustive, resilience=k)
        for step in range(4):
            kinds = [kd for kd in KINDS
                     if not (kd == "exit" and len(ref_tasks) < 2)
                     and not (kd == "failure" and ref_fleet.n_f <= 1)]
            kind = kinds[int(rng.integers(len(kinds)))]
            ref_tasks, ref_fleet = _delta(rng, pyrng, kind, ref_tasks, ref_fleet, step)
            port, ref = _replan_both(port_s, ref_s, port.plan_state, ref.plan_state,
                                     ref_tasks, ref_fleet, resilience=k,
                                     record_exhaustive=exhaustive)
            origins.add(ref.plan_state.origin)
            port_s, ref_s = _pair(ref_fleet, engines)
    assert {"warm_arrival", "cold"} <= origins


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("kind", ["arrival", "exit-last", "exit-first", "failure",
                                  "failure-hetero-last", "failure-hetero-first"])
def test_each_warm_path_on_the_band_instance(engines, kind):
    """Each warm path on the band instance (rejects with prefix death
    depths, exhaustively recorded): same result, state and origin."""
    ref_tasks, ref_fleet = _instances()[-1]
    if kind.startswith("failure-hetero"):
        dev = RefDeviceProfile(t_slr=100.0, t_cfg=0.0)
        tiny = RefDeviceProfile(t_slr=0.5, t_cfg=0.0)
        ref_fleet = RefFleetSpec.heterogeneous([tiny, dev, dev, dev, tiny], name="het")
    if kind.startswith("exit"):
        eps = RefTask("eps", period=50.0, data=1.0, init_interval=1.0,
                      variants=(RefTaskVariant(cu=1, throughput=100.0 / (50.0 * 1e-6),
                                               power=1e-6),))
        ref_tasks = [*ref_tasks, eps] if kind == "exit-last" else [eps, *ref_tasks]
    port_s, ref_s, port, ref = _record_both(ref_tasks, ref_fleet, engines, exhaustive=True)
    new_fleet = ref_fleet
    if kind == "arrival":
        new_tasks = ref_tasks + [RefTask("arrival", period=10.0, data=25.0, init_interval=0.5,
                                         variants=(_v(5.0, 1.0), _v(10.0, 2.5)))]
    elif kind.startswith("exit"):
        new_tasks = [t for t in ref_tasks if t.name != "eps"]
    else:
        new_tasks = ref_tasks
        i = 0 if kind == "failure-hetero-first" else ref_fleet.n_f - 1
        new_fleet = _drop_device(ref_fleet, i)
    port, ref = _replan_both(port_s, ref_s, port.plan_state, ref.plan_state,
                             new_tasks, new_fleet)
    want = {"arrival": "warm_arrival", "exit": "warm_exit", "failure": "warm_failure"}
    assert ref.plan_state.origin == want[kind.split("-")[0]]


@pytest.mark.parametrize("kind", ["exit-first", "failure-hetero-first", "failure-hetero-last"])
def test_warm_paths_decline_on_an_ulp_lost_incumbent(kind):
    """The band instance at its benchmark powers (not dyadic): the old
    winner's compensated ``sum()`` lies an ulp below its left fold, so a
    warm path bounded by it drops the incumbent's row, which is the cold
    winner.  The port's warm path declines and its fresh walk (re-run
    unbounded when the ulp-short bound empties it) answers exactly like
    a cold schedule().  (The JAX package's replanner stops on an
    assertion here.)"""
    ref_tasks = _band_tasks(6, 3, seed=7, base=80.0, dyadic=False)
    tasks = list(tasks_from(ref_tasks))
    fleet = FleetSpec(n_f=3, t_slr=100.0, t_cfg=0.0)
    new_fleet = fleet
    if kind == "exit-first":
        eps = Task("eps", period=50.0, data=1.0, init_interval=1.0,
                   variants=(TaskVariant(cu=1, throughput=100.0 / (50.0 * 1e-6), power=1e-6),))
        recorded = [eps, *tasks]
    else:
        recorded = tasks
        dev, tiny = DeviceProfile(t_slr=100.0, t_cfg=0.0), DeviceProfile(t_slr=0.5, t_cfg=0.0)
        fleet = FleetSpec.heterogeneous([tiny, dev, dev, dev, tiny], name="het")
        i = 0 if kind.endswith("first") else fleet.n_f - 1
        new_fleet = FleetSpec.heterogeneous(fleet.devices[:i] + fleet.devices[i + 1:], name="het")
    sched = PADPSFRScheduler(fleet, engine="torch")
    rec = sched.schedule(recorded, record_state=True, record_exhaustive=True)
    combo = rec.combo.variant_idx[1:] if kind == "exit-first" else rec.combo.variant_idx
    fold = 0.0
    for t, j in zip(tasks, combo, strict=True):
        fold = fold + t.powers()[j]
    assert fold != sum(float(t.powers()[j]) for t, j in zip(tasks, combo, strict=True))
    warm = sched.replan(rec.plan_state, tasks, fleet=new_fleet)
    cold = PADPSFRScheduler(new_fleet, engine="torch").schedule(tasks)
    assert cold.feasible
    assert_same_plan(warm, cold)
    assert warm.plan_state.origin == "cold"


# ---------------------------------------------------------------------------
# the reference tests' replan-level scenarios, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engines", ENGINES, ids=ENGINE_IDS)
def test_warm_arrival_levels_match_cold(engines):
    """The reference's scenario: integer powers (tie-breaks) and both
    recording modes; warm == cold on the port, and == the reference."""
    for seed in range(14):
        rng = random.Random(77 + seed)
        ref_fleet = RefFleetSpec(n_f=rng.randint(1, 3), t_slr=rng.uniform(15, 40),
                                 t_cfg=rng.uniform(0.0, 1.5))
        ref_tasks = [_rand_task(rng, f"t{i}", int_powers=True)
                     for i in range(rng.randint(2, 4))]
        port_s, ref_s, port, ref = _record_both(ref_tasks, ref_fleet, engines,
                                                exhaustive=seed % 2 == 0)
        extended = ref_tasks + [_rand_task(rng, "new", int_powers=True)]
        _replan_both(port_s, ref_s, port.plan_state, ref.plan_state, extended, ref_fleet)


def test_warm_exit_transfers_reject_depths_zero_dispatch():
    """The reference's construction (2 devices x 30 slots, t_cfg=0, every
    recorded reject dying at depth 2, an eps task appended last): the
    port's warm exit re-finds the winner from transferred verdicts alone,
    without probing or dispatching a single row."""
    fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=0.0)

    def task(name, shr_cheap, p_cheap, p_exp):
        return Task(name, period=10.0, data=1.0, init_interval=2.0,
                    variants=(TaskVariant(cu=1, throughput=3.0 / shr_cheap, power=p_cheap),
                              TaskVariant(cu=1, throughput=3.0 / 13.0, power=p_exp)))

    tasks = [task("a", 21.0, 1.0, 5.0), task("b", 21.0, 2.0, 6.0), task("c", 17.0, 3.0, 7.0)]
    eps = Task("eps", period=50.0, data=1.0, init_interval=1.0,
               variants=(TaskVariant(cu=1, throughput=30.0 / (50.0 * 1e-6), power=1e-6),))
    sched = PADPSFRScheduler(fleet, engine="torch")
    rec = sched.schedule([*tasks, eps], record_state=True, record_exhaustive=True)
    assert rec.feasible
    depths = rec.plan_state.rec_depth
    died = depths[(depths >= 0) & (depths < len(tasks) + 1)]
    assert died.size > 0 and died.max() == 2

    stats = WalkStats()
    warm = sched.replan(rec.plan_state, tasks, walk_stats=stats)
    cold = sched.schedule(tasks)
    assert cold.chosen_rank > 0  # the transferred rejects are load-bearing
    assert warm.feasible
    assert_same_plan(warm, cold)
    assert warm.plan_state.origin == "warm_exit"
    assert stats.rows == 0


@pytest.mark.parametrize("kind", ["arrival", "exit", "failure", "general"])
def test_walk_stats_probe_rows_count_the_host_oracle(monkeypatch, kind):
    """``WalkStats.probe_rows`` is the number of rows a re-plan placed with
    the scalar oracle on the host (its incumbent checks and prefix probe),
    counted here independently by wrapping the oracle the replanner
    calls."""
    ref_tasks, ref_fleet = _instances()[-1]
    tasks, fleet = list(tasks_from(ref_tasks)), fleet_from(ref_fleet)
    eps = Task("eps", period=50.0, data=1.0, init_interval=1.0,
               variants=(TaskVariant(cu=1, throughput=100.0 / (50.0 * 1e-6), power=1e-6),))
    recorded, new_tasks, new_fleet = tasks, tasks, fleet
    if kind == "arrival":
        new_tasks = [*tasks, Task("arrival", period=10.0, data=25.0, init_interval=0.5,
                                  variants=(TaskVariant(cu=1, throughput=5.0, power=1.0),
                                            TaskVariant(cu=2, throughput=10.0, power=2.5)))]
    elif kind == "exit":
        recorded = [*tasks, eps]
    elif kind == "failure":
        new_fleet = FleetSpec(n_f=fleet.n_f - 1, t_slr=fleet.t_slr, t_cfg=fleet.t_cfg)
    else:
        new_tasks = tasks[1:][::-1]
    sched = PADPSFRScheduler(fleet, engine="torch")
    rec = sched.schedule(recorded, record_state=True, record_exhaustive=True)
    calls = []
    real = port_replan.place_shares

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(port_replan, "place_shares", counted)
    stats = WalkStats()
    warm = sched.replan(rec.plan_state, new_tasks, fleet=new_fleet, walk_stats=stats)
    want = {"arrival": "warm_arrival", "exit": "warm_exit", "failure": "warm_failure",
            "general": "cold"}
    assert warm.plan_state.origin == want[kind]
    assert stats.probe_rows == len(calls)
    assert calls or kind == "failure"  # there eq. 7 already refuses the old winner
    assert stats.as_dict()["probe_rows"] == stats.probe_rows
    assert_same_plan(warm, PADPSFRScheduler(new_fleet, engine="torch").schedule(new_tasks))


def test_replan_refuses_to_reuse_another_engines_state():
    """``replan`` transfers verdicts only between states of the same
    engine: a state recorded on "scalar" replanned on "torch" takes the
    general fresh walk (origin "cold") and is still exact."""
    ref_fleet = RefFleetSpec(n_f=3, t_slr=30.0, t_cfg=1.0)
    tasks = tasks_from(_abc())
    fleet = fleet_from(ref_fleet)
    rec = PADPSFRScheduler(fleet, engine="scalar").schedule(tasks[:2], record_state=True)
    warm = PADPSFRScheduler(fleet, engine="torch").replan(rec.plan_state, tasks)
    assert warm.plan_state.origin == "cold" and warm.plan_state.engine == "torch"
    assert_same_plan(warm, PADPSFRScheduler(fleet, engine="torch").schedule(tasks))
    same = PADPSFRScheduler(fleet, engine="scalar").replan(rec.plan_state, tasks)
    assert same.plan_state.origin == "warm_arrival"


# ---------------------------------------------------------------------------
# the enumerator's cover_prune hook, the emission order, the suffix bounds
# ---------------------------------------------------------------------------


def _blocks(enum, want=7):
    out = []
    while (blk := enum.next_block(want)) is not None:
        out.append((blk.total_power, blk.sum_shr, blk.variant_idx))
    return out


def _assert_same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_cover_prune_on_exact_ties_matches_reference():
    """On tie-heavy power tables the covered-subtree walk (the exit gap
    walk's hook: a prefix is covered when its largest completion passes
    a tighter budget) emits the reference's blocks row for row, and a
    ``cover_prune=None`` enumerator emits exactly the plain one's."""
    rng = np.random.default_rng(31)
    n_pruned = 0
    for _ in range(40):
        ref_tasks = _tie_tasks(rng)
        n_f = int(rng.integers(1, 4))
        ref_fleet = RefFleetSpec(n_f=n_f, t_slr=float(rng.uniform(20, 60)),
                                 t_cfg=float(rng.uniform(0, 3)))
        tight = ref_fleet.workable_budget(len(ref_tasks)) * float(rng.uniform(0.3, 0.9))

        def hook_for(feas, share_vecs):
            _, hi = feas._suffix_max_bounds(share_vecs)

            def covered(d, pshr):
                u = pshr + hi[d]
                return u + (np.abs(u) + 1.0) * 1e-12 <= tight
            return covered

        ref_e = ref_feas.BlockEnumerator(ref_tasks, ref_fleet, cover_prune=hook_for(
            ref_feas, [t.shares(ref_fleet.t_slr) for t in ref_tasks]))
        tasks, fleet = tasks_from(ref_tasks), fleet_from(ref_fleet)
        port_e = port_feas.BlockEnumerator(tasks, fleet, cover_prune=hook_for(
            port_feas, [t.shares(fleet.t_slr) for t in tasks]))
        got, want = _blocks(port_e), _blocks(ref_e)
        _assert_same_blocks(got, want)
        plain = _blocks(port_feas.BlockEnumerator(tasks, fleet))
        _assert_same_blocks(_blocks(port_feas.BlockEnumerator(tasks, fleet, cover_prune=None)),
                            plain)
        n_pruned += sum(b[0].size for b in plain) - sum(b[0].size for b in got)
    assert n_pruned > 0


def test_emission_order_on_exact_ties_matches_reference():
    """The permutation sorting rows by (power, flat TSS index): stable
    argsort, then a lexsort within each run of equal power."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 300):
        for n_t in (1, 3, 5):
            pp = rng.choice([1.0, 2.0, 2.5, 3.0], n)
            ch = rng.integers(0, 3, (n, n_t)).astype(np.int64)
            got = port_feas._emission_order(pp, ch)
            want = ref_feas._emission_order(pp, ch)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            key = [tuple([p, *c]) for p, c in zip(pp[got], ch[got], strict=True)]
            assert key == sorted(key)


def test_suffix_max_bounds_match_reference():
    rng = np.random.default_rng(8)
    for _ in range(20):
        ref_tasks = _tie_tasks(rng)
        vecs = [t.shares(float(rng.uniform(20, 60))) for t in ref_tasks]
        for a, b in zip(port_feas._suffix_max_bounds(vecs), ref_feas._suffix_max_bounds(vecs),
                        strict=True):
            np.testing.assert_array_equal(a, b)
        suf, hi = port_feas._suffix_max_bounds(vecs)
        assert hi[-1] == 0.0 and (hi[:-1] > suf[:-1]).all()
