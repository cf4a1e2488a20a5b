"""The port's fleet-parallel ``schedule_many`` and the modules around it,
against the JAX package's, exactly.

The same instances — randomized heterogeneous batches (ragged task counts,
variant counts and fleets), exact power ties, the paper's Example 1 — go
through the reference's ``schedule_many(engine="numpy")`` and through the
port's on the ``"torch"`` engine (the plain batched sweep on CPU tensors)
and the ``"scalar"`` engine, carried across with
:mod:`repro_torch.convert`.  Every result field must be equal, floats
included.  Also here: both branches of the lockstep many-walk (the raw
``(B, R)`` surface and the trimmed per-instance one), and the port's
``place_batch``, ``sweep_fleet`` (Figs 5-7), ``count_placeable``,
``preemptive_dpfair_schedule`` and the EDF / LLF / ER-fair baselines on
``backend="torch"``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.configs import paper_examples as ref_examples  # noqa: E402
from repro.core import FleetSpec as RefFleetSpec  # noqa: E402
from repro.core import PADPSFRScheduler as RefScheduler  # noqa: E402
from repro.core import ScheduleInstance as RefInstance  # noqa: E402
from repro.core import Task as RefTask  # noqa: E402
from repro.core import TaskVariant as RefVariant  # noqa: E402
from repro_torch import core as port_core  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    fleet_from,
    instance_from,
    instances_from,
    tasks_from,
)
from repro_torch.core import PADPSFRScheduler, ScheduleInstance, WalkStats  # noqa: E402
from repro_torch.core import scheduler as port_scheduler  # noqa: E402
from repro_torch.core.placement_backends import get_backend  # noqa: E402

from test_block_enumeration import _tie_tasks  # noqa: E402
from test_placement_batched import _random_fleet, _random_tasks  # noqa: E402
from test_torch_scheduler import _assert_same  # noqa: E402

ENGINES = ["torch", "scalar"]
BASE = RefFleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)


def _v(th, pw):
    return RefVariant(cu=1, throughput=th, power=pw)


TASK_A = RefTask("a", period=10.0, data=20.0, init_interval=1.0,
                 variants=(_v(2.0, 5.0), _v(4.0, 8.0)))
TASK_B = RefTask("b", period=10.0, data=40.0, init_interval=1.0,
                 variants=(_v(4.0, 4.0), _v(8.0, 6.0)))
# Every variant's share alone exceeds any single-device capacity.
HOG = RefTask("hog", period=10.0, data=1000.0, init_interval=1.0, variants=(_v(1.0, 5.0),))


def _random_instances(rng, n, *, max_tasks=4, max_variants=3, max_devices=4):
    return [
        RefInstance(
            tasks=tuple(_random_tasks(rng, max_tasks, max_variants)),
            fleet=_random_fleet(rng, max_devices=max_devices),
        )
        for _ in range(n)
    ]


def _check_many(insts, engine, *, base=BASE, block_size=None, exhaustive=None, **kw):
    """The port's schedule_many equals the reference's numpy engine, field
    for field; returns the port's results."""
    want = RefScheduler(base, engine="numpy", block_size=block_size,
                        exhaustive=exhaustive).schedule_many(insts, **kw)
    got = PADPSFRScheduler(fleet_from(base), engine=engine, block_size=block_size,
                           exhaustive=exhaustive).schedule_many(instances_from(insts), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        _assert_same(g, w)
    return got


# ---------------------------------------------------------------------------
# randomized heterogeneous parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exhaustive", [None, False], ids=["exhaustive", "streaming"])
@pytest.mark.parametrize("count_all", [True, False], ids=["all-rejects", "early-exit"])
def test_randomized_heterogeneous_batches_match_reference(exhaustive, count_all):
    rng = np.random.default_rng(2026)
    checked = feasible = 0
    while checked < 56:
        insts = _random_instances(rng, int(rng.integers(2, 9)))
        got = _check_many(insts, "torch", exhaustive=exhaustive, count_all_rejects=count_all)
        checked += len(insts)
        feasible += sum(r.feasible for r in got)
    assert checked >= 50
    assert 0 < feasible < checked  # both verdicts occur


@pytest.mark.parametrize("engine", ENGINES)
def test_scalar_and_torch_batches_equal_the_solo_loop(engine):
    rng = np.random.default_rng(8)
    insts = instances_from(_random_instances(rng, 12))
    sched = PADPSFRScheduler(fleet_from(BASE), engine=engine)
    many = sched.schedule_many(insts, count_all_rejects=True)
    for got, inst in zip(many, insts, strict=True):
        solo = PADPSFRScheduler(inst.fleet, engine=engine).schedule(
            inst.tasks, count_all_rejects=True
        )
        _assert_same(got, solo)


# ---------------------------------------------------------------------------
# edge semantics, per engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_batch_returns_empty_list(engine):
    assert PADPSFRScheduler(fleet_from(BASE), engine=engine).schedule_many([]) == []
    assert RefScheduler(BASE, engine="numpy").schedule_many([]) == []


@pytest.mark.parametrize("engine", ENGINES)
def test_singleton_batch_equals_solo_schedule(engine):
    rng = np.random.default_rng(11)
    for _ in range(8):
        tasks, fleet = _random_tasks(rng, max_tasks=4), _random_fleet(rng, max_devices=4)
        sched = PADPSFRScheduler(fleet_from(fleet), engine=engine)
        solo = sched.schedule(tasks_from(tasks), count_all_rejects=True)
        (many,) = sched.schedule_many(
            [ScheduleInstance(tasks=tasks_from(tasks))], count_all_rejects=True
        )
        _assert_same(many, solo)
        _check_many([RefInstance(tasks=tuple(tasks))], engine, base=fleet, count_all_rejects=True)


@pytest.mark.parametrize("engine", ENGINES)
def test_infeasible_instance_in_mixed_batch(engine):
    insts = [RefInstance(tasks=(TASK_A,)), RefInstance(tasks=(HOG,)), RefInstance(tasks=(TASK_A,))]
    res = _check_many(insts, engine)
    assert [r.feasible for r in res] == [True, False, True]
    bad = res[1]
    assert bad.chosen_rank == -1 and bad.combo is None and bad.plan is None
    assert bad.total_power == float("inf")
    solo = PADPSFRScheduler(fleet_from(BASE), engine=engine).schedule(tasks_from((TASK_A,)))
    _assert_same(res[0], solo)
    _assert_same(res[2], solo)


@pytest.mark.parametrize("engine", ENGINES)
def test_all_infeasible_batch(engine):
    fleet = RefFleetSpec(n_f=1, t_slr=30.0, t_cfg=1.0)
    res = _check_many([RefInstance(tasks=(HOG,)) for _ in range(3)], engine, base=fleet)
    assert len(res) == 3 and not any(r.feasible for r in res)


@pytest.mark.parametrize("engine", ENGINES)
def test_exact_power_ties_resolve_identically(engine):
    """Two variants per task at the same power but different shares: the
    power-sorted TFS holds runs of exactly tied rows."""
    tied = (
        RefTask("x", period=10.0, data=20.0, init_interval=1.0,
                variants=(RefVariant(1, 2.0, 5.0), RefVariant(2, 4.0, 5.0))),
        RefTask("y", period=10.0, data=40.0, init_interval=1.0,
                variants=(RefVariant(1, 4.0, 4.0), RefVariant(2, 8.0, 4.0))),
    )
    _check_many([RefInstance(tasks=tied), RefInstance(tasks=tied[::-1])], engine,
                count_all_rejects=True)
    rng = np.random.default_rng(42)
    insts = [RefInstance(tasks=tuple(_tie_tasks(rng)), fleet=_random_fleet(rng))
             for _ in range(10)]
    _check_many(insts, engine, block_size=7, count_all_rejects=True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("block_size", [1, 7, 64, None], ids=["b1", "b7", "b64", "ramp"])
def test_block_size_invariance_in_batch(engine, block_size):
    rng = np.random.default_rng(5)
    insts = _random_instances(rng, 4, max_tasks=3)
    got = _check_many(insts, engine, block_size=block_size, count_all_rejects=True)
    ramp = PADPSFRScheduler(fleet_from(BASE), engine=engine).schedule_many(
        instances_from(insts), count_all_rejects=True
    )
    for g, w in zip(got, ramp, strict=True):
        _assert_same(g, w)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("k", [1, 2])
def test_resilience_with_an_instance_that_cannot_survive(engine, k):
    """resilience=k over mixed fleets, one of which has n_f <= k: that
    instance is infeasible, its batchmates as in the reference."""
    rng = np.random.default_rng(30 + k)
    insts = _random_instances(rng, 5, max_tasks=3, max_devices=5)
    insts.append(RefInstance(tasks=(TASK_A,), fleet=RefFleetSpec(n_f=k, t_slr=60.0, t_cfg=1.0)))
    got = _check_many(insts, engine, count_all_rejects=True, resilience=k)
    assert not got[-1].feasible and got[-1].n_tfs == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_preemptive_resume_cost_in_batch(engine):
    rng = np.random.default_rng(44)
    insts = _random_instances(rng, 6)
    insts.append(RefInstance(tasks=tuple(ref_examples.example1_tasks()),
                             fleet=ref_examples.example1_fleet()))
    got = _check_many(insts, engine, count_all_rejects=True,
                      repay_init=False, t_capture=4.5, t_store=5.0)
    assert got[-1].feasible


def test_bare_task_sequences_inherit_scheduler_fleet():
    sched = PADPSFRScheduler(fleet_from(BASE), engine="torch")
    (res,) = sched.schedule_many([tasks_from((TASK_A,))])
    _assert_same(res, sched.schedule(tasks_from((TASK_A,))))


def test_shard_is_accepted_and_ignored():
    rng = np.random.default_rng(21)
    insts = instances_from(_random_instances(rng, 5, max_tasks=3))
    sched = PADPSFRScheduler(fleet_from(BASE), engine="torch")
    plain = sched.schedule_many(insts, count_all_rejects=True)
    for shard in ("auto", 2):
        for got, want in zip(sched.schedule_many(insts, shard=shard, count_all_rejects=True),
                             plain, strict=True):
            _assert_same(got, want)


def test_bad_resilience_raises():
    sched = PADPSFRScheduler(fleet_from(BASE), engine="torch")
    for k in (-1, True, 1.5):
        with pytest.raises(ValueError, match="resilience"):
            sched.schedule_many([tasks_from((TASK_A,))], resilience=k)


# ---------------------------------------------------------------------------
# the lockstep many-walk: raw and trimmed branches
# ---------------------------------------------------------------------------


def _walk_with(backend_name, insts, monkeypatch, **kw):
    """Run the many-walk on one backend, recording each round's surface."""
    backend = get_backend(backend_name)
    rounds = []
    raw_hook, trimmed_hook = backend.dispatch_blocks_raw, backend.dispatch_blocks

    def raw(batch, opts=None, *, shard=None):
        out = raw_hook(batch, opts, shard=shard)
        rounds.append(("raw" if out is not None else "none", len(batch)))
        return out

    def trimmed(batch, opts=None, *, shard=None):
        rounds.append(("trimmed", len(batch)))
        return trimmed_hook(batch, opts, shard=shard)

    monkeypatch.setattr(backend, "dispatch_blocks_raw", raw)
    monkeypatch.setattr(backend, "dispatch_blocks", trimmed)
    sched = PADPSFRScheduler(fleet_from(BASE), engine="torch", block_size=5)
    walks = [sched._instance_walk(i, inst, n_batch=len(insts), resilience=kw.get("resilience", 0))
             for i, inst in enumerate(insts)]
    stats = WalkStats()
    port_scheduler._walk_many_tfs_blocks(walks, backend=backend, count_all_rejects=True,
                                         walk_stats=stats, **kw)
    monkeypatch.undo()
    results = [(w.winner[2] if w.winner else -1, w.rejects,
                w.winner[0].variant_idx if w.winner else None) for w in walks]
    return results, rounds, stats


@pytest.mark.parametrize("kw", [{}, {"resilience": 1}], ids=["plain", "resilience1"])
def test_many_walk_raw_and_trimmed_branches_agree(monkeypatch, kw):
    """The torch engine takes the raw branch, one raw dispatch per round;
    the scalar engine's raw surface answers None, so every round goes
    through the trimmed branch.  Both leave the same walks behind, equal
    to the reference's schedule_many."""
    rng = np.random.default_rng(3)
    ref_insts = _random_instances(rng, 6, max_tasks=3, max_devices=4)
    ref_insts = [i for i in ref_insts if i.fleet.n_f > kw.get("resilience", 0)]
    insts = instances_from(ref_insts)
    got_raw, rounds_raw, stats = _walk_with("torch", insts, monkeypatch, **kw)
    got_trim, rounds_trim, _ = _walk_with("scalar", insts, monkeypatch, **kw)
    assert got_raw == got_trim
    assert rounds_raw and {r[0] for r in rounds_raw} == {"raw"}
    assert [r[0] for r in rounds_trim] == ["none", "trimmed"] * (len(rounds_trim) // 2)
    assert len(rounds_trim) == 2 * len(rounds_raw)
    assert stats.rows == sum(stats.block_sizes) > 0
    want = RefScheduler(BASE, engine="numpy", block_size=5).schedule_many(
        ref_insts, count_all_rejects=True, **kw
    )
    assert [(w.chosen_rank, w.n_placement_rejects,
             w.combo.variant_idx if w.combo else None) for w in want] == got_raw


def test_many_walk_coalesces_block_sizes():
    """Rounds cover _MANY_BLOCK_SCALE solo blocks, capped per round."""
    sizes = port_scheduler._coalesced_sizes(iter([1, 64, 512, 65536]), 1000)
    assert list(sizes) == [8, 512, 1000, 65536]
    rng = np.random.default_rng(6)
    insts = instances_from(_random_instances(rng, 3, max_tasks=3))
    stats = WalkStats()
    PADPSFRScheduler(fleet_from(BASE), engine="torch", block_size=2).schedule_many(
        insts, count_all_rejects=True, walk_stats=stats
    )
    assert max(stats.block_sizes) <= 16 and stats.rows == sum(stats.block_sizes)


def test_convert_instances_keep_inherited_fleets():
    inst = instance_from(RefInstance(tasks=(TASK_A,)))
    assert inst.fleet is None and inst.tasks == tasks_from((TASK_A,))
    inst = instance_from(RefInstance(tasks=(TASK_A, TASK_B), fleet=BASE))
    assert inst.fleet == fleet_from(BASE) and len(inst.tasks) == 2


# ---------------------------------------------------------------------------
# place_batch, metrics and baselines on backend="torch"
# ---------------------------------------------------------------------------


def _bp_fields(bp):
    return [bp.feasible, bp.placed_tasks, bp.n_splits, bp.devices_used]


@pytest.mark.parametrize("kw", [{}, {"repay_init": False, "t_capture": 4.5, "t_store": 5.0}],
                         ids=["padpsfr", "preemptive-resume"])
def test_place_batch_matches_reference(kw):
    rng = np.random.default_rng(13)
    for _ in range(20):
        tasks, fleet = _random_tasks(rng), _random_fleet(rng)
        feas = ref_core.search_feasible(tasks, fleet)
        order = feas.tfs_indices_by_power()
        if order.size == 0:
            continue
        shares, iis = feas.shares_matrix(order), [t.init_interval for t in tasks]
        want = ref_core.place_batch(shares, iis, fleet, **kw)
        got = port_core.place_batch(shares, iis, fleet_from(fleet), backend="torch", **kw)
        for g, w in zip(_bp_fields(got), _bp_fields(want), strict=True):
            np.testing.assert_array_equal(g, w)
        combos = [feas.combo_at(int(i)) for i in order[:9]]
        want = ref_core.place_combos_batch(combos, tasks, fleet, **kw)
        port_feas = port_core.search_feasible(tasks_from(tasks), fleet_from(fleet))
        got = port_core.place_combos_batch(
            [port_feas.combo_at(int(i)) for i in order[:9]], tasks_from(tasks),
            fleet_from(fleet), backend="torch", **kw,
        )
        for g, w in zip(_bp_fields(got), _bp_fields(want), strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_placement", [True, False])
def test_sweep_fleet_figs_5_to_7_match_reference(with_placement):
    """Figs 5-7 on Example 1 (homogeneous) and on a heterogeneous base."""
    tasks = ref_examples.example1_tasks()
    hetero = ref_core.FleetSpec.heterogeneous(
        (ref_core.DeviceProfile(t_slr=96.0, t_cfg=6.0, klass="fpga"),
         ref_core.DeviceProfile(t_slr=80.0, t_cfg=0.0, klass="gpu"))
    )
    for base in (ref_examples.example1_fleet(), hetero):
        args = (dict(n_f_values=[3, 4, 5, 6], t_cfg_values=[2.0, 6.0, 10.0],
                     with_placement=with_placement))
        want = ref_core.sweep_fleet(tasks, base, **args)
        got = port_core.sweep_fleet(tasks_from(tasks), fleet_from(base), backend="torch", **args)
        assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert port_core.trr(3, 12) == ref_core.trr(3, 12) and port_core.trr(0, 0) == 0.0
    fleet = ref_examples.example1_fleet()
    assert port_core.system_workload(50.0, fleet_from(fleet)) == ref_core.system_workload(50.0, fleet)
    assert port_core.avg_task_weight([1.0, 2.0], [4.0, 8.0]) == ref_core.avg_task_weight(
        [1.0, 2.0], [4.0, 8.0]
    )


def test_count_placeable_matches_reference():
    tasks, fleet = ref_examples.example1_tasks(), ref_examples.example1_fleet()
    for n_f in (4, 5, 6):
        f = fleet.with_devices(n_f)
        for kw in ({}, {"t_capture": 12.0, "t_store": 12.0, "repay_init": False}):
            want = ref_core.count_placeable(tasks, f, **kw)
            got = port_core.count_placeable(tasks_from(tasks), fleet_from(f), backend="torch", **kw)
            assert got == want
    assert fleet_from(fleet.with_devices(5)) == fleet_from(fleet).with_devices(5)
    assert fleet_from(fleet.with_t_cfg(2.0)) == fleet_from(fleet).with_t_cfg(2.0)


@pytest.mark.parametrize("count_all", [True, False])
def test_preemptive_dpfair_schedule_matches_reference(count_all):
    tasks, fleet = ref_examples.example1_tasks(), ref_examples.example1_fleet()
    for t_cap in (0.0, 4.5, 12.0):
        want = ref_core.preemptive_dpfair_schedule(
            tasks, fleet, t_capture=t_cap, t_store=t_cap, count_all_rejects=count_all
        )
        got = port_core.preemptive_dpfair_schedule(
            tasks_from(tasks), fleet_from(fleet), t_capture=t_cap, t_store=t_cap,
            count_all_rejects=count_all, backend="torch",
        )
        _assert_same(got, want)


def test_greedy_and_erfair_baselines_match_reference():
    rng = np.random.default_rng(19)
    cases = [(ref_examples.example1_tasks(), ref_examples.example1_fleet())]
    cases += [(_random_tasks(rng), _random_fleet(rng)) for _ in range(10)]
    for tasks, fleet in cases:
        pt, pf = tasks_from(tasks), fleet_from(fleet)
        for name in ("edf_schedule", "llf_schedule"):
            want = getattr(ref_core, name)(tasks, fleet)
            got = getattr(port_core, name)(pt, pf)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for q in (1.0, 10.0):
            assert port_core.erfair_context_switches(pt, pf, q) == (
                ref_core.erfair_context_switches(tasks, fleet, q)
            )


def test_select_lowest_power_batched_matches_reference():
    tasks, fleet = ref_examples.example1_tasks(), ref_examples.example1_fleet()
    want = ref_core.select_lowest_power_batched(
        ref_core.search_feasible(tasks, fleet).iter_tfs_by_power(), tasks, fleet,
        count_all_rejects=True, block_size=37,
    )
    pt, pf = tasks_from(tasks), fleet_from(fleet)
    got = port_core.select_lowest_power_batched(
        port_core.search_feasible(pt, pf).iter_tfs_by_power(), pt, pf,
        count_all_rejects=True, block_size=37, backend="torch",
    )
    assert (got[0].variant_idx, got[2], got[3]) == (want[0].variant_idx, want[2], want[3])
    assert (got[2], got[3]) == (4, 146)


def test_entry_points_default_to_the_card(monkeypatch):
    """No silent fallback: without a CUDA device the default engine of
    schedule_many's scheduler, place_batch, sweep_fleet, count_placeable
    and preemptive_dpfair_schedule raises, pointing at engine='torch'."""
    from repro_torch.core.placement_backends import base as port_base

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_base, "_INSTANCES", {})
    tasks, fleet = tasks_from((TASK_A, TASK_B)), fleet_from(BASE)
    calls = [
        lambda: PADPSFRScheduler(fleet).schedule_many([tasks]),
        lambda: port_core.place_batch(np.full((2, 2), 5.0), [1.0, 1.0], fleet),
        lambda: port_core.sweep_fleet(tasks, fleet, [2], [1.0]),
        lambda: port_core.count_placeable(tasks, fleet),
        lambda: port_core.preemptive_dpfair_schedule(tasks, fleet, t_capture=1.0, t_store=1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="engine='torch'"):
            call()
