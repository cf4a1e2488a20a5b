"""Delta replanning: warm-start the Alg 1+2 walk from a previous plan.

A long-running fleet (:mod:`repro_torch.service`) sees task arrivals, task
exits and device failures continuously; re-running the full power-sorted
TFS walk from scratch on every event is wasted work when almost
everything about the instance is unchanged.  This module makes one
``schedule()`` pay for the events that follow it:

* :func:`schedule_recorded` runs the normal streaming walk but snapshots
  a :class:`PlanState` — every emitted TFS row (power, folded eq-7 share
  sum, variant choice), every placement verdict the walk actually
  resolved, and the live :class:`~repro_torch.core.feasibility.BlockEnumerator`
  (the surviving branch-and-bound frontier) at the point the walk
  stopped.
* :func:`replan` reschedules a new task tuple / fleet from that state.
  Three deltas take a warm path — an **arrival** (tasks appended to the
  state's root task tuple), an **exit** (one task removed) and a
  **device failure** (one device dropped, reference ``t_slr``
  preserved); anything else falls back to a fresh recorded walk that
  still seeds the projected previous winner as an *incumbent* upper
  power bound.

Every warm path reduces the event to the same shape: build the exact
set of new-TFS rows with total power at or below an incumbent bound
``P_inc`` (each row carrying the bit-exact left-to-right float64 folds a
cold enumeration would produce), order them by the cold emission key
``(total_power, TSS flat index)``, transfer recorded placement verdicts
where provably sound, and walk the ordered candidates through the
backend dispatching only the unknowns.  The first placeable row is the
cold winner at the cold rank with the cold plan — bit-identical,
including under ``resilience=k`` (``tests/test_torch_service.py`` pins
this over randomized event traces, engines and k, against the JAX
package's replanner as well as cold walks).

Soundness facts per delta
-------------------------

**Arrival** (``T' = root + appended``): eq-7's budget shrinks and the
heterogeneous overhead bound grows as tasks are appended, so every
workable row of ``T'`` restricts to a workable row of the root — the new
TFS is a filtered cross product of already-enumerated root rows with the
appended tasks' variants.  Recorded *rejects* transfer to every
extension (the placement simulator walks tasks in order, so a failing
prefix fails forever); placeable verdicts do not.

**Exit** (task at position ``p`` removed): the budget *grows*, so the
new TFS is the recorded rows projected onto the surviving columns
(dedup over the dropped variant axis) **plus** a gap: rows whose every
extension broke the old budget and were therefore never enumerated.
The gap walk is a fresh enumeration of the shrunken task set whose
subtrees are pruned whenever provably *covered* by the recording —
covered means some extension passed the old eq-7, and because the eq-7
pass is antitone in the folded share sum (heterogeneous overhead is
monotone), it suffices to test the removed task's minimum-share variant.
Recorded placeable verdicts transfer to the projection only when ``p``
is the last position (the simulator's first ``n-1`` steps are exactly
the shrunken instance's walk).  Rejects transfer through the recorded
**death depth**: the placement simulator walks tasks in order, so its
primary sweep dying at depth ``d`` (``d`` tasks fully placed, task
``d`` unplaceable) is a fact about tasks ``0..d`` and the fleet alone
— a recorded row that died at ``d < p`` rejects on the shrunken
instance too, whatever sits after position ``p``.  Rows that died at
or past ``p`` (or whose reject came from the resilience survivor
sweep, which reports depth ``n``) never transfer.

**Failure** (device dropped, same reference ``t_slr`` so recorded share
folds keep their meaning): task set and variants are unchanged, so
candidates are the recorded rows re-checked against the shrunken
fleet's eq-7.  On a homogeneous fleet the budget is float-monotone in
``n_f`` so the new TFS is a subset of the old (no gap walk) and the
smaller fleet is a device-prefix of the old — recorded rejects transfer
for any ``k``.  On a heterogeneous fleet rejects transfer only when the
*last* device dropped with ``k=0`` (survivor prefix), and a covered-gap
walk against the old fleet's eq-7 recovers rows the old enumeration
pruned.

State carry-over
----------------

Each warm replan emits a *live* state, not a thin one: the ordered
candidate band with its learned verdicts becomes the new ``rec_*``
arrays, ``complete_below`` records the band's coverage bound (``P_inc``,
or ``inf`` when the source state was exhaustive and no incumbent
bounded the walk), and arrival states keep a one-hop ``base`` pointer
to the exhaustive root so consecutive arrivals re-run the cross product
against the root's full recording (``appended`` grows by one task per
event) instead of going cold.  ``origin`` tags the path that built the
state (``cold`` / ``warm_arrival`` / ``warm_exit`` / ``warm_failure``)
— :class:`repro_torch.service.SchedulerService` maps it to telemetry and
bounds chain staleness with a background re-record policy keyed on
:attr:`PlanState.frontier_coverage`.

Devices
-------

Everything here is host float64 numpy: the recorded arrays, the eq-7
folds, the emission order and the single-row probes.  Only placement
sweeps go to the engine — the recorded walk's blocks and the warm paths'
candidate blocks (``backend.place_block``, the sweep kernel on
``"cuda"``).  A :class:`PlanState` holds no device tensor.  On the
asynchronous ``"cuda"`` engine the recorded walk enqueues one block past
the winner and abandons it; :class:`_Recorder` saw that block emitted but
never resolved, so its rows stay ``VERDICT_UNKNOWN`` with depth ``-1``.
A ``"cuda"`` state may therefore hold more rows than an eager engine's
(and a different :attr:`PlanState.frontier_coverage`), but every verdict
it holds is a truth, so the plans it leads to are the same.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from .feasibility import (
    BlockEnumerator,
    _emission_order,
    _suffix_max_bounds,
    config_overhead_lower_bound,
)
from .placement import place_combo, place_shares
from .placement_backends import PlacementBackend, PlacementOptions
from .scheduler import (
    ScheduleResult,
    WalkStats,
    _block_size_schedule,
    _resilience_infeasible_result,
    _walk_tfs_blocks,
)
from .task import FleetSpec, Task, TaskSetCombo, combo_count

__all__ = [
    "PlanState",
    "VERDICT_REJECT",
    "VERDICT_PLACEABLE",
    "VERDICT_UNKNOWN",
    "schedule_recorded",
    "replan",
]

# Per-row placement verdicts recorded by the walk.  A recorded verdict is
# always a *truth* about (tasks, fleet, options) — transfers across
# events only happen where the soundness facts above allow, so chained
# warm states never launder a guess into a fact.
VERDICT_REJECT = 0
VERDICT_PLACEABLE = 1
VERDICT_UNKNOWN = 2

_WARM_BLOCK = 4096  # dispatch block size for the candidate mini-walk
_WARM_PROBE = 6  # scalar-oracle prefix probes before block dispatch
_EXIT_CAP = 65536  # phase-1 parent-row cap for the exit projection

# Adaptive guard for the arrival cross product: candidate generation
# touches prod(appended variant counts) * recorded-rows floats; past
# this, a fresh bounded walk is cheaper than the projection.
_APPEND_CELL_CAP = 64_000_000


@dataclasses.dataclass
class PlanState:
    """Everything a later :func:`replan` can reuse from one walk.

    ``rec_*`` arrays hold rows of the instance's power-ordered TFS
    exactly as emitted (power and eq-7 share sum are the enumerator's
    own left-to-right folds).  Together with ``enum`` (which resumes
    emission where the recording stopped; ``None`` once drained or for
    warm states) they cover every TFS row with total power ``<=
    complete_below`` — ``inf`` for an exhaustive or unbounded cold walk,
    the incumbent band for warm states, ``-inf`` for a thin state with
    no coverage claim.  ``enum`` is private mutable state — replanners
    only ever touch a :meth:`BlockEnumerator.clone` of it.

    ``origin`` names the path that built the state; ``base`` points a
    warm-arrival state back at the exhaustive root it projected from
    (one hop, never a chain) with ``appended`` holding the tasks beyond
    the root's tuple.
    """

    tasks: tuple[Task, ...]
    fleet: FleetSpec
    engine: str  # backend name whose verdicts rec_verdict holds
    placement_kw: dict
    result: ScheduleResult = dataclasses.field(repr=False)
    rec_pow: np.ndarray = dataclasses.field(repr=False)  # (R,) float64
    rec_sumshr: np.ndarray = dataclasses.field(repr=False)  # (R,) float64
    rec_chosen: np.ndarray = dataclasses.field(repr=False)  # (R, n_t) int64
    rec_verdict: np.ndarray = dataclasses.field(repr=False)  # (R,) int8
    # (R,) int16 — tasks the *primary* placement sweep fully placed when
    # the row was dispatched (-1 = never dispatched / fleet changed since).
    # A row that died at depth d rejects on every instance sharing tasks
    # 0..d on the same fleet — the exit path's reject-transfer key.
    rec_depth: np.ndarray = dataclasses.field(repr=False)
    enum: BlockEnumerator | None = dataclasses.field(repr=False)
    complete_below: float = np.inf
    origin: str = "cold"
    base: "PlanState | None" = dataclasses.field(default=None, repr=False)
    appended: tuple[Task, ...] = ()

    @property
    def n_recorded(self) -> int:
        return int(self.rec_pow.size)

    @property
    def frontier_coverage(self) -> float:
        """How much of a fresh exhaustive recording this state retains,
        in [0, 1].  Chain states inherit their root's coverage (the root
        is what their replans consume); a banded state is worth at most
        half an exhaustive one (band reuse works, appends from it
        usually cannot), scaled by its known-verdict fraction.  The
        service's re-record policy triggers below a threshold."""
        if self.base is not None:
            return self.base.frontier_coverage
        if self.complete_below == -np.inf:
            return 0.0
        if self.complete_below == np.inf:
            return 1.0
        if not self.n_recorded:
            return 0.0
        known = float((self.rec_verdict != VERDICT_UNKNOWN).mean())
        return 0.5 * known


class _Recorder:
    """Accumulates emitted blocks + resolved verdicts during one walk."""

    def __init__(self, n_t: int) -> None:
        self._n_t = n_t
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._verdicts: dict[int, np.ndarray] = {}  # rank_base -> int8 block
        self._depths: dict[int, np.ndarray] = {}  # rank_base -> int16 block
        self._bases: list[int] = []
        self._total = 0

    def on_emit(self, blk) -> None:
        self._chunks.append((blk.total_power, blk.sum_shr, blk.variant_idx))
        self._bases.append(self._total)
        self._total += len(blk)

    def on_verdict(
        self, base: int, feasible: np.ndarray, placed: np.ndarray
    ) -> None:
        self._verdicts[base] = np.where(
            feasible, VERDICT_PLACEABLE, VERDICT_REJECT
        ).astype(np.int8)
        self._depths[base] = placed.astype(np.int16)

    def arrays(
        self,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if not self._chunks:
            return (
                np.empty(0),
                np.empty(0),
                np.empty((0, self._n_t), dtype=np.int64),
                np.empty(0, dtype=np.int8),
                np.empty(0, dtype=np.int16),
            )
        pow_ = np.concatenate([c[0] for c in self._chunks])
        sumshr = np.concatenate([c[1] for c in self._chunks])
        chosen = np.concatenate([c[2] for c in self._chunks], axis=0)
        verdict = np.full(self._total, VERDICT_UNKNOWN, dtype=np.int8)
        for base, v in self._verdicts.items():
            verdict[base : base + v.size] = v
        depth = np.full(self._total, -1, dtype=np.int16)
        for base, d in self._depths.items():
            depth[base : base + d.size] = d
        return pow_, sumshr, chosen, verdict, depth


def _eq7_leaf_mask(
    fleet: FleetSpec, n_t: int, w: np.ndarray, resilience: int = 0
) -> np.ndarray:
    """The enumerator's leaf-level eq-7 test, bit-identical (same float64
    comparisons as :meth:`BlockEnumerator._passes` on a completed row).
    ``resilience`` switches to the worst-case survivor fleet's budget,
    matching the enumerator's resilience-mode pruning."""
    bfleet = fleet.survivors(resilience) if resilience and n_t else fleet
    ok = w <= bfleet.workable_budget(n_t) + 1e-9
    if bfleet.is_heterogeneous and ok.any():
        overhead = config_overhead_lower_bound(bfleet, n_t, w)
        ok &= ~(w > bfleet.capacity - overhead + 1e-9)
    return ok


def _combo_from_idx(
    idx: Sequence[int],
    share_vecs: Sequence[np.ndarray],
    power_vecs: Sequence[np.ndarray],
) -> TaskSetCombo:
    return TaskSetCombo(
        tuple(int(j) for j in idx),
        tuple(float(v[j]) for v, j in zip(share_vecs, idx, strict=True)),
        tuple(float(v[j]) for v, j in zip(power_vecs, idx, strict=True)),
    )


def schedule_recorded(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    backend: PlacementBackend,
    *,
    block_size: int | None = None,
    count_all_rejects: bool = False,
    walk_stats: WalkStats | None = None,
    incumbent_power: float | None = None,
    exhaustive: bool = False,
    **placement_kw,
) -> ScheduleResult:
    """The streaming ``schedule()`` walk, with :class:`PlanState` capture.

    Identical winner/rank/reject bookkeeping to the cold streaming path —
    the only additions are the recorder taps and the optional
    ``incumbent_power`` bound, which prunes rows *after* the winner-to-be
    (emission is power-ordered, so every row up to and including the
    winner survives the bound and the result is unchanged).

    ``exhaustive`` keeps walking past the winner so *every* TFS row gets
    a recorded placement verdict and the enumerator drains dry.  The
    reported result is still bit-identical to the cold default (rank
    rejects, same winner); what changes is the state's warmth — a later
    arrival replan needs no band drain and dispatches only extensions of
    known-placeable rows.  Pay once, replan cheap thereafter: this is the
    service layer's steady-state mode.

    Example — the :meth:`~repro_torch.core.scheduler.PADPSFRScheduler.schedule`
    doctest's instance, recorded exhaustively on the plain engine (every
    TFS row placeable, both tasks placed on each):

        >>> from repro_torch.core.placement_backends import get_backend
        >>> from repro_torch.core.task import FleetSpec, Task, TaskVariant
        >>> def v(th, pw):
        ...     return TaskVariant(cu=1, throughput=th, power=pw)
        >>> tasks = [
        ...     Task("a", period=10.0, data=20.0, init_interval=1.0,
        ...          variants=(v(2.0, 5.0), v(4.0, 8.0))),
        ...     Task("b", period=10.0, data=40.0, init_interval=1.0,
        ...          variants=(v(4.0, 4.0), v(8.0, 6.0))),
        ... ]
        >>> fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
        >>> res = schedule_recorded(tasks, fleet, get_backend("torch"), exhaustive=True)
        >>> st = res.plan_state
        >>> st.rec_pow.tolist(), st.rec_chosen.tolist()
        ([11.0, 12.0, 14.0], [[0, 1], [1, 0], [1, 1]])
        >>> st.rec_verdict.tolist(), st.rec_depth.tolist(), st.frontier_coverage
        ([1, 1, 1], [2, 2, 2], 1.0)
    """
    tasks = tuple(tasks)
    k_res = int(placement_kw.get("resilience", 0))
    if k_res >= fleet.n_f and tasks:
        # A fleet that cannot survive k failures admits nothing; answered
        # here (not just in the facade) because replans re-enter after
        # fleet shrinkage.  Thin state: the next replan walks fresh.
        res = _resilience_infeasible_result(tasks)
        res.plan_state = _thin_state(tasks, fleet, backend, placement_kw, res)
        return res
    enum = BlockEnumerator(tasks, fleet, resilience=k_res)
    complete_below = np.inf
    if incumbent_power is not None:
        enum.prune_above(incumbent_power)
        complete_below = float(incumbent_power)
    sizes = _block_size_schedule(block_size)
    rec = _Recorder(len(tasks))

    def blocks():
        while True:
            blk = enum.next_block(next(sizes))
            if blk is None:
                return
            rec.on_emit(blk)
            yield blk.shares, blk

    combo, plan, rank, rejects = _walk_tfs_blocks(
        blocks(),
        lambda blk, r: blk.materialize(r),
        tasks,
        fleet,
        backend=backend,
        count_all_rejects=count_all_rejects or exhaustive,
        walk_stats=walk_stats,
        on_verdict=rec.on_verdict,
        **placement_kw,
    )
    if exhaustive and not count_all_rejects and combo is not None:
        rejects = rank  # mirror the cold default's stop-at-winner count
    res = ScheduleResult(
        feasible=combo is not None,
        combo=combo,
        plan=plan,
        chosen_rank=rank,
        n_tss=combo_count(tasks),
        n_tfs=-1,
        n_tnfs=-1,
        n_placement_rejects=rejects,
        total_power=combo.total_power if combo else float("inf"),
    )
    rec_pow, rec_sumshr, rec_chosen, rec_verdict, rec_depth = rec.arrays()
    res.plan_state = PlanState(
        tasks=tasks,
        fleet=fleet,
        engine=backend.name,
        placement_kw=dict(placement_kw),
        result=res,
        rec_pow=rec_pow,
        rec_sumshr=rec_sumshr,
        rec_chosen=rec_chosen,
        rec_verdict=rec_verdict,
        rec_depth=rec_depth,
        enum=enum,
        complete_below=complete_below,
    )
    return res


def replan(
    state: PlanState,
    tasks: Sequence[Task],
    *,
    backend: PlacementBackend,
    fleet: FleetSpec | None = None,
    block_size: int | None = None,
    walk_stats: WalkStats | None = None,
    record_exhaustive: bool = False,
    **placement_kw,
) -> ScheduleResult:
    """Reschedule ``tasks`` (on ``fleet``) reusing whatever ``state``
    makes sound.

    Warm dispatch, in preference order (backend/options must match the
    state's, so recorded verdicts and folds are meaningful):

    * ``tasks`` extends the state's *root* task tuple on an unchanged
      fleet — cross-product arrival path (consecutive arrivals chain
      through the root via :attr:`PlanState.base`, so the second and
      later arrivals stay warm too);
    * ``tasks`` removes exactly one of ``state.tasks`` on an unchanged
      fleet — projection exit path;
    * ``tasks`` unchanged but ``fleet`` drops one device of
      ``state.fleet`` (same reference ``t_slr``) — failure path.

    Anything else — or a warm path declining because the state's band
    cannot cover the event — falls back to an incumbent-seeded fresh
    recorded walk (``record_exhaustive=True`` makes that walk drain the
    enumerator so the fallback restores full warmth, the service
    layer's choice).  Always bit-identical to a cold ``schedule(tasks)``
    on the target fleet.
    """
    tasks = tuple(tasks)
    if fleet is None:
        fleet = state.fleet
    if tasks == state.tasks and fleet == state.fleet:
        return state.result
    compatible = (
        backend.name == state.engine and dict(placement_kw) == state.placement_kw
    )
    if compatible and fleet == state.fleet:
        root = state.base if state.base is not None else state
        nb = len(root.tasks)
        if root.fleet == fleet and len(tasks) >= nb and tasks[:nb] == root.tasks:
            if len(tasks) == nb:
                return root.result
            out = _replan_append(
                root,
                tasks[nb:],
                cur_tasks=state.tasks,
                cur_result=state.result,
                backend=backend,
                walk_stats=walk_stats,
                **placement_kw,
            )
            if out is not None:
                return out
        if tasks and len(tasks) == len(state.tasks) - 1:
            p = _removed_position(state.tasks, tasks)
            if p is not None:
                out = _replan_exit(
                    state, p, backend=backend, walk_stats=walk_stats, **placement_kw
                )
                if out is not None:
                    return out
                # Arrival-chained state losing a *root* task: the chain
                # state's band rarely covers the exit horizon, but the
                # (usually exhaustive) root does.  Project the exit out
                # of the root, then re-append the chain's arrivals —
                # both hops warm, both exact.
                if state.base is not None and p < nb and nb >= 2 and state.appended:
                    # Band headroom for the re-append hop: its incumbent
                    # is at most the current winner minus the exiting
                    # task's chosen variant, and its band reaches down
                    # by the appended tasks' cheapest variants.
                    mb = None
                    if state.result.feasible:
                        tot = state.result.total_power
                        pw_p = float(
                            state.tasks[p].powers()[
                                state.result.combo.variant_idx[p]
                            ]
                        )
                        min_app = sum(
                            float(t.powers().min()) for t in state.appended
                        )
                        mb = tot - pw_p - min_app + 1e-6 * max(1.0, abs(tot))
                    mid = _replan_exit(
                        root,
                        p,
                        backend=backend,
                        walk_stats=walk_stats,
                        min_band=mb,
                        **placement_kw,
                    )
                    if mid is not None and mid.plan_state is not None:
                        out = _replan_append(
                            mid.plan_state,
                            state.appended,
                            cur_tasks=state.tasks,
                            cur_result=state.result,
                            backend=backend,
                            walk_stats=walk_stats,
                            origin="warm_exit",
                            **placement_kw,
                        )
                        if out is not None:
                            return out
    elif compatible and tasks == state.tasks:
        dropped = _dropped_device(state.fleet, fleet)
        if dropped is not None:
            out = _replan_failure(
                state,
                fleet,
                dropped,
                backend=backend,
                walk_stats=walk_stats,
                **placement_kw,
            )
            if out is not None:
                return out
            # Same two-hop rescue as the exit chain: replay the failure
            # against the exhaustive root, then re-append the chain's
            # arrivals on the shrunken fleet.
            if state.base is not None and state.appended:
                mb = None
                if state.result.feasible:
                    tot = state.result.total_power
                    min_app = sum(
                        float(t.powers().min()) for t in state.appended
                    )
                    mb = tot - min_app + 1e-6 * max(1.0, abs(tot))
                mid = _replan_failure(
                    state.base,
                    fleet,
                    dropped,
                    backend=backend,
                    walk_stats=walk_stats,
                    min_band=mb,
                    **placement_kw,
                )
                if mid is not None and mid.plan_state is not None:
                    out = _replan_append(
                        mid.plan_state,
                        state.appended,
                        cur_tasks=state.tasks,
                        cur_result=state.result,
                        backend=backend,
                        walk_stats=walk_stats,
                        origin="warm_failure",
                        **placement_kw,
                    )
                    if out is not None:
                        return out
    return _replan_general(
        state,
        tasks,
        fleet,
        backend=backend,
        block_size=block_size,
        walk_stats=walk_stats,
        exhaustive=record_exhaustive,
        **placement_kw,
    )


def _removed_position(
    old: tuple[Task, ...], new: tuple[Task, ...]
) -> int | None:
    """Position ``p`` with ``old`` minus ``old[p]`` == ``new``, else None."""
    p = len(new)
    for i, (a, b) in enumerate(zip(old, new, strict=False)):
        if a != b:
            p = i
            break
    return p if old[:p] + old[p + 1 :] == new else None


def _dropped_device(old: FleetSpec, new: FleetSpec) -> int | None:
    """Index of the single device whose removal turns ``old`` into
    ``new``, or None when the edit is not a one-device drop (or changes
    the reference ``t_slr`` — recorded share folds would be meaningless).

    On a homogeneous fleet every device is interchangeable, so the
    *last* index is reported; ties in a heterogeneous fleet also prefer
    the last matching index (it is the one position whose drop keeps the
    survivor set a prefix, enabling reject transfer at ``k=0``)."""
    if new.n_f != old.n_f - 1 or new.n_f < 1 or new.t_slr != old.t_slr:
        return None
    if not old.is_heterogeneous:
        if not new.is_heterogeneous and (
            dataclasses.replace(old, n_f=new.n_f, name=new.name) == new
        ):
            return new.n_f
        return None
    if not new.is_heterogeneous:
        return None
    devs = old.devices
    for i in range(old.n_f - 1, -1, -1):
        if new.devices != devs[:i] + devs[i + 1 :]:
            continue
        # The scalar t_cfg must also be what a pure drop recomputes.
        if FleetSpec.heterogeneous(new.devices, name=new.name) == new:
            return i
        return None
    return None


def _probe_row(
    shares_row: np.ndarray,
    tasks: Sequence[Task],
    fleet: FleetSpec,
    opts: PlacementOptions,
    walk_stats: WalkStats | None = None,
) -> tuple[bool, int]:
    """Scalar-oracle placement probe: ``(feasible, primary death depth)``,
    counted in ``walk_stats.probe_rows``.

    Every engine agrees bit-for-bit with ``place_shares`` (the engine
    contract, asserted in ``tests/test_torch_placement_sweep.py``), so a
    one-row probe asks the oracle on the host instead of paying a block
    sweep's fixed cost (a launch and two copies on ``"cuda"``).

    Depth counts the tasks the *primary* sweep fully placed — ``n_t``
    when placement walked past the last task (whatever the resilience
    survivor sweep then said), matching the block backends'
    ``placed_tasks`` semantics.
    """
    plan = place_shares(
        [float(s) for s in shares_row],
        [t.init_interval for t in tasks],
        fleet,
        t_capture=opts.t_capture,
        t_store=opts.t_store,
        repay_init=opts.repay_init,
        resilience=opts.resilience,
    )
    if walk_stats is not None:
        walk_stats.probe_rows += 1
    depth = min(plan.unplaced) if plan.unplaced else len(tasks)
    return bool(plan.feasible), depth


def _replan_general(
    state: PlanState,
    tasks: tuple[Task, ...],
    fleet: FleetSpec,
    *,
    backend: PlacementBackend,
    block_size: int | None,
    walk_stats: WalkStats | None,
    exhaustive: bool = False,
    **placement_kw,
) -> ScheduleResult:
    """Bulk deltas and declined warm paths: fresh recorded walk, seeded
    with the old winner projected onto the new task tuple as an
    incumbent.

    The projection keeps each surviving task's previous variant choice;
    it is only a *bound*, verified from scratch (eq. 7 + a placement
    probe) against the new instance and fleet, so no monotonicity
    assumption about the delta is needed — if the probe fails, the walk
    simply runs unbounded and the replan degrades to a plain cold
    recorded walk.  ``exhaustive`` skips the incumbent bound entirely:
    the point is then a full re-recording (the service's re-anchoring
    fallback), and a pruned walk could not claim ``complete_below=inf``.
    """
    incumbent = None
    k_res = int(placement_kw.get("resilience", 0))
    if not exhaustive and state.result.feasible and k_res < fleet.n_f:
        prev = {
            t.name: j
            for t, j in zip(state.tasks, state.result.combo.variant_idx, strict=True)
        }
        if all(t.name in prev and prev[t.name] < t.nv for t in tasks):
            share_vecs = [t.shares(fleet.t_slr) for t in tasks]
            power_vecs = [t.powers() for t in tasks]
            idx = [prev[t.name] for t in tasks]
            combo = _combo_from_idx(idx, share_vecs, power_vecs)
            w = np.asarray([float(sum(combo.shares))])
            if _eq7_leaf_mask(fleet, len(tasks), w, k_res)[0] and _probe_row(
                np.asarray(combo.shares), tasks, fleet, PlacementOptions(**placement_kw),
                walk_stats,
            )[0]:
                incumbent = combo.total_power
    res = schedule_recorded(
        tasks,
        fleet,
        backend,
        block_size=block_size,
        walk_stats=walk_stats,
        incumbent_power=incumbent,
        exhaustive=exhaustive,
        **placement_kw,
    )
    if incumbent is not None and not res.feasible:
        # The bound is the combo's compensated ``sum()`` of powers; when
        # the incumbent row's own left fold lies an ulp above it, the
        # enumerator prunes that row and the walk comes back empty
        # although a placeable row was just verified.  Walk unbounded.
        res = schedule_recorded(
            tasks,
            fleet,
            backend,
            block_size=block_size,
            walk_stats=walk_stats,
            exhaustive=exhaustive,
            **placement_kw,
        )
    return res


def _thin_state(
    tasks: tuple[Task, ...],
    fleet: FleetSpec,
    backend: PlacementBackend,
    placement_kw: dict,
    res: ScheduleResult,
    origin: str = "cold",
) -> PlanState:
    """State with no recording/frontier (``complete_below = -inf``): the
    next replan from it silently takes the general fresh-walk path."""
    return PlanState(
        tasks=tasks,
        fleet=fleet,
        engine=backend.name,
        placement_kw=dict(placement_kw),
        result=res,
        rec_pow=np.empty(0),
        rec_sumshr=np.empty(0),
        rec_chosen=np.empty((0, len(tasks)), dtype=np.int64),
        rec_verdict=np.empty(0, dtype=np.int8),
        rec_depth=np.empty(0, dtype=np.int16),
        enum=None,
        complete_below=-np.inf,
        origin=origin,
    )


def _drain_band(
    state: PlanState, band_hi: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Recorded rows plus the snapshot frontier drained through
    ``band_hi`` (power-inclusive), as one emission-ordered array set.

    Sound whenever ``band_hi <= state.complete_below`` — the recording
    and the frontier then jointly cover every TFS row in the band.  The
    drain touches only a :meth:`BlockEnumerator.clone`; drained rows get
    UNKNOWN verdicts and ``-1`` depths (the original walk never
    dispatched them)."""
    chunks_pow = [state.rec_pow]
    chunks_sumshr = [state.rec_sumshr]
    chunks_chosen = [state.rec_chosen]
    chunks_verdict = [state.rec_verdict]
    chunks_depth = [state.rec_depth]
    if state.enum is not None and not state.enum.exhausted:
        resume = state.enum.clone()
        if np.isfinite(band_hi):
            resume.prune_above(band_hi)
        while True:
            blk = resume.next_block(65536)
            if blk is None:
                break
            chunks_pow.append(blk.total_power)
            chunks_sumshr.append(blk.sum_shr)
            chunks_chosen.append(blk.variant_idx)
            chunks_verdict.append(np.full(len(blk), VERDICT_UNKNOWN, dtype=np.int8))
            chunks_depth.append(np.full(len(blk), -1, dtype=np.int16))

    def _cat(chunks, axis=0):  # skip the full copy when nothing was drained
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=axis)

    return (
        _cat(chunks_pow),
        _cat(chunks_sumshr),
        _cat(chunks_chosen),
        _cat(chunks_verdict),
        _cat(chunks_depth),
    )


def _walk_candidates(
    cand_chosen: np.ndarray,
    cand_verdict: np.ndarray,
    cand_depth: np.ndarray,
    tasks: tuple[Task, ...],
    fleet: FleetSpec,
    backend: PlacementBackend,
    opts: PlacementOptions,
    walk_stats: WalkStats | None,
) -> tuple[int, np.ndarray, np.ndarray]:
    """Walk emission-ordered candidate rows to the first placeable one.

    Every verdict in ``cand_verdict`` is a *truth* about this exact
    (tasks, fleet, options) instance, so the walk can stop at the first
    known-PLACEABLE row without dispatching it and skip every
    known-REJECT row (they only count toward the winner's rank by
    position).  UNKNOWN rows before the stop point are dispatched in
    power order, exactly the rows a cold walk would have dispatched.

    Returns ``(win, verdicts, depths)``: the winner's candidate index
    (``-1`` when nothing places) plus the verdict and death-depth arrays
    updated with everything the walk learned.
    """
    n_t = len(tasks)
    out = cand_verdict.copy()
    dep = cand_depth.copy()
    kp = np.flatnonzero(cand_verdict == VERDICT_PLACEABLE)
    stop = int(kp[0]) if kp.size else cand_chosen.shape[0]
    win = stop if stop < cand_chosen.shape[0] else -1
    todo = np.flatnonzero(cand_verdict[:stop] == VERDICT_UNKNOWN)
    if not todo.size:
        return win, out, dep
    share_vecs = tuple(t.shares(fleet.t_slr) for t in tasks)
    iis = [t.init_interval for t in tasks]
    # Scalar prefix probe: most warm walks settle within a handful of
    # rows, where the scalar oracle (bit-identical by the engine
    # contract) costs a fraction of a vectorized sweep's fixed overhead.
    # Only if the prefix does not settle it does the block path below
    # take over for the remaining rows.
    head = todo[: min(_WARM_PROBE, todo.size)]
    probed = 0
    for i in head:
        probed += 1
        row = np.array([share_vecs[c][cand_chosen[i, c]] for c in range(n_t)])
        ok, d = _probe_row(row, tasks, fleet, opts, walk_stats)
        dep[i] = d
        if ok:
            out[i] = VERDICT_PLACEABLE
            win = int(i)
            break
        out[i] = VERDICT_REJECT
    if walk_stats is not None and probed:
        walk_stats.rows += probed
        walk_stats.block_sizes.append(probed)
    if probed and out[head[probed - 1]] == VERDICT_PLACEABLE:
        return win, out, dep
    todo = todo[probed:]
    if not todo.size:
        return win, out, dep
    t_slr_arr, t_cfg_arr = fleet.t_slr_arr, fleet.t_cfg_arr
    for lo in range(0, todo.size, _WARM_BLOCK):
        sel = todo[lo : lo + _WARM_BLOCK]
        shares = np.empty((sel.size, n_t))
        ch = cand_chosen[sel]
        for c in range(n_t):
            shares[:, c] = share_vecs[c][ch[:, c]]
        bp = backend.place_block(shares, iis, t_slr_arr, t_cfg_arr, opts)
        if walk_stats is not None:
            walk_stats.rows += sel.size
            walk_stats.block_sizes.append(sel.size)
        r = int(bp.first_feasible())
        if r >= 0:
            out[sel[:r]] = VERDICT_REJECT
            out[sel[r]] = VERDICT_PLACEABLE
            dep[sel[: r + 1]] = bp.placed_tasks[: r + 1].astype(np.int16)
            win = int(sel[r])
            break
        out[sel] = VERDICT_REJECT
        dep[sel] = bp.placed_tasks.astype(np.int16)
    return win, out, dep


def _finish_warm(
    tasks: tuple[Task, ...],
    fleet: FleetSpec,
    backend: PlacementBackend,
    placement_kw: dict,
    cand_pow: np.ndarray,
    cand_sumshr: np.ndarray,
    cand_chosen: np.ndarray,
    cand_verdict: np.ndarray,
    cand_depth: np.ndarray,
    win: int,
    P_inc: float,
    origin: str,
    base: PlanState | None,
    appended: tuple[Task, ...],
    share_vecs: Sequence[np.ndarray],
    power_vecs: Sequence[np.ndarray],
) -> ScheduleResult | None:
    """Result + carried-over state shared by all three warm paths; None
    means *fall back*.

    The candidates are the *exact* new TFS restricted to total power
    ``<= P_inc`` in exact emission order, so: winner index == cold rank
    == cold stop-at-winner reject count, and when nothing places the
    candidate count equals the full |TFS| a cold infeasible walk would
    have dispatched (``P_inc`` is infinite then).  The candidate band
    with its learned verdicts *is* the new state (state carry-over):
    coverage holds below ``P_inc`` — below everything, when the source
    state was exhaustive and the walk unbounded.

    A finite ``P_inc`` is the incumbent combo's ``total_power``, a
    ``sum()`` of its powers — compensated (Neumaier) summation since
    Python 3.12 — while candidate powers are the enumerator's plain
    left-to-right folds.  The two can differ by an ulp, and when the
    incumbent's own fold lies one ulp above ``P_inc`` its row (and the
    cold winner, at or past it) falls outside the candidates.  No row
    then places, and the path declines rather than answer wrong; the
    caller's fresh walk finds the winner.
    """
    if win < 0:
        if np.isfinite(P_inc):
            return None  # the incumbent's row fell outside its own bound
        res = ScheduleResult(
            feasible=False,
            combo=None,
            plan=None,
            chosen_rank=-1,
            n_tss=combo_count(tasks),
            n_tfs=-1,
            n_tnfs=-1,
            n_placement_rejects=int(cand_pow.size),
            total_power=float("inf"),
        )
    else:
        combo = _combo_from_idx(cand_chosen[win], share_vecs, power_vecs)
        plan = place_combo(combo, tasks, fleet, **placement_kw)
        res = ScheduleResult(
            feasible=True,
            combo=combo,
            plan=plan,
            chosen_rank=win,
            n_tss=combo_count(tasks),
            n_tfs=-1,
            n_tnfs=-1,
            n_placement_rejects=win,
            total_power=combo.total_power,
        )
    res.plan_state = PlanState(
        tasks=tasks,
        fleet=fleet,
        engine=backend.name,
        placement_kw=dict(placement_kw),
        result=res,
        rec_pow=cand_pow,
        rec_sumshr=cand_sumshr,
        rec_chosen=cand_chosen,
        rec_verdict=cand_verdict,
        rec_depth=cand_depth,
        enum=None,
        complete_below=float(P_inc) if np.isfinite(P_inc) else np.inf,
        origin=origin,
        base=base,
        appended=appended,
    )
    return res


def _replan_append(
    root: PlanState,
    appended: tuple[Task, ...],
    *,
    cur_tasks: tuple[Task, ...],
    cur_result: ScheduleResult,
    backend: PlacementBackend,
    walk_stats: WalkStats | None,
    origin: str = "warm_arrival",
    **placement_kw,
) -> ScheduleResult | None:
    """Warm path for arrivals: ``tasks = root.tasks + appended``; None
    means *fall back*.

    Generalises the single-arrival cross product to any number of
    appended tasks so consecutive arrivals replay against the same
    exhaustive root (``cur_tasks``/``cur_result`` — the live state the
    service holds, usually ``root + appended[:-1]`` — only seed the
    incumbent).  Every comparison uses the exact float64 folds a cold
    enumeration of the extended set would produce, so winner, rank and
    plan are bit-identical to cold.  ``origin`` tags the emitted state
    (the exit chain re-enters here and wants ``"warm_exit"``).
    """
    fleet = root.fleet
    tasks2 = root.tasks + appended
    n2 = len(tasks2)
    nb = len(root.tasks)
    opts = PlacementOptions(**placement_kw)
    k = opts.resilience
    share_vecs = tuple(t.shares(fleet.t_slr) for t in tasks2)
    power_vecs = tuple(t.powers() for t in tasks2)
    shr_app = share_vecs[nb:]
    pow_app = power_vecs[nb:]

    # --- incumbent: the current winner, extended with the cheapest
    # placeable variant of the (at most one) task it does not cover.
    # Variants probed in ascending power; eq. 7 first (cheap), then one
    # single-row oracle probe.  A failed probe does NOT force a
    # fallback: the walk below simply runs unbounded when the root is
    # exhaustive — the common shape of an arrival the saturated fleet
    # cannot admit, where the recorded rejects prove infeasibility
    # almost for free.
    P_inc = np.inf
    if cur_result.feasible:
        prev = {
            t.name: int(j)
            for t, j in zip(cur_tasks, cur_result.combo.variant_idx, strict=True)
        }
        missing = [
            i
            for i, t in enumerate(tasks2)
            if t.name not in prev or prev[t.name] >= t.nv
        ]
        if len(missing) <= 1:
            idx = [prev.get(t.name, 0) for t in tasks2]
            probe_vs = (
                np.argsort(power_vecs[missing[0]], kind="stable")
                if missing
                else np.zeros(1, dtype=np.int64)
            )
            for vv in probe_vs:
                if missing:
                    idx[missing[0]] = int(vv)
                combo = _combo_from_idx(idx, share_vecs, power_vecs)
                w = np.asarray([float(sum(combo.shares))])
                if not _eq7_leaf_mask(fleet, n2, w, k)[0]:
                    continue
                if _probe_row(np.asarray(combo.shares), tasks2, fleet, opts, walk_stats)[0]:
                    P_inc = combo.total_power
                    break

    # Root rows that could extend into a candidate at or below P_inc.
    # Over-inclusive margin: the exact per-candidate filter is below.
    min_app = sum(float(p.min()) for p in pow_app)
    if np.isfinite(P_inc):
        band_hi = P_inc - min_app + 1e-9 * max(1.0, abs(P_inc))
    else:
        band_hi = np.inf
    if band_hi > root.complete_below:
        return None  # recording + frontier don't cover the band: fall back
    all_pow, all_sumshr, all_chosen, all_verdict, all_depth = _drain_band(
        root, band_hi
    )
    n_ext = 1
    for t in appended:
        n_ext *= t.nv
    if n_ext * max(all_pow.size, 1) > _APPEND_CELL_CAP:
        return None  # deep chain over a huge recording: fresh walk wins

    # --- candidates: every recorded/drained root row crossed with every
    # appended-variant tuple, filtered by the exact eq-7 fold and the
    # incumbent bound.  Reject parents transfer (reject monotonicity);
    # everything else dispatches as UNKNOWN.
    cps: list[np.ndarray] = []
    css: list[np.ndarray] = []
    cch: list[np.ndarray] = []
    cvd: list[np.ndarray] = []
    cdp: list[np.ndarray] = []
    for vt in itertools.product(*(range(t.nv) for t in appended)):
        cp = all_pow
        cs = all_sumshr
        for m, v in enumerate(vt):
            cp = cp + pow_app[m][v]
            cs = cs + shr_app[m][v]
        keep = (cp <= P_inc) & _eq7_leaf_mask(fleet, n2, cs, k)
        sel = np.flatnonzero(keep)
        if not sel.size:
            continue
        vt_cols = np.repeat(
            np.asarray(vt, dtype=np.int64)[None, :], sel.size, axis=0
        )
        cps.append(cp[sel])
        css.append(cs[sel])
        cch.append(np.concatenate([all_chosen[sel], vt_cols], axis=1))
        pv = all_verdict[sel]
        cvd.append(
            np.where(pv == VERDICT_REJECT, VERDICT_REJECT, VERDICT_UNKNOWN).astype(
                np.int8
            )
        )
        # A death inside the shared prefix (tasks are appended at the
        # end) stays a death for every extension; depths at or past the
        # root's length describe completed prefixes, not facts here.
        pd = all_depth[sel]
        cdp.append(np.where((pd >= 0) & (pd < nb), pd, -1).astype(np.int16))
    if cps:
        cand_pow = np.concatenate(cps)
        cand_sumshr = np.concatenate(css)
        cand_chosen = np.concatenate(cch, axis=0)
        cand_verdict = np.concatenate(cvd)
        cand_depth = np.concatenate(cdp)
    else:
        cand_pow = np.empty(0)
        cand_sumshr = np.empty(0)
        cand_chosen = np.empty((0, n2), dtype=np.int64)
        cand_verdict = np.empty(0, dtype=np.int8)
        cand_depth = np.empty(0, dtype=np.int16)
    order = _emission_order(cand_pow, cand_chosen)
    cand_pow = cand_pow[order]
    cand_sumshr = cand_sumshr[order]
    cand_chosen = cand_chosen[order]
    cand_verdict = cand_verdict[order]
    cand_depth = cand_depth[order]
    win, verd, dep = _walk_candidates(
        cand_chosen,
        cand_verdict,
        cand_depth,
        tasks2,
        fleet,
        backend,
        opts,
        walk_stats,
    )
    return _finish_warm(
        tasks2,
        fleet,
        backend,
        placement_kw,
        cand_pow,
        cand_sumshr,
        cand_chosen,
        verd,
        dep,
        win,
        P_inc,
        origin,
        root,
        appended,
        share_vecs,
        power_vecs,
    )

def _replan_exit(
    state: PlanState,
    p: int,
    *,
    backend: PlacementBackend,
    walk_stats: WalkStats | None,
    min_band: float | None = None,
    **placement_kw,
) -> ScheduleResult | None:
    """Warm path for one task exit (position ``p``); None means fall back.

    Projects the recorded rows onto the surviving task axes — drop
    column ``p``, re-fold power and eq-7 share sums left-to-right over
    the surviving columns (the exact association a cold enumeration of
    the shrunken set uses), dedup over the dropped variant axis — then
    closes the enumeration *gap* (shrunken-TFS rows none of whose
    extensions fit the old budget) with a covered-subtree-pruned fresh
    walk.  Recorded placeable verdicts transfer to projections only when
    the exiting task was last in placement order; rejects transfer
    whenever the recorded row's primary sweep died *before* position
    ``p`` (prefix death — see the module docstring).

    ``min_band`` widens the candidate band past the incumbent (the exit
    chain asks for enough headroom that re-appending the chain's
    arrivals finds its band already recorded); extra rows sort after the
    winner, so the result is unaffected — only the emitted state grows.
    """
    fleet = state.fleet
    n = len(state.tasks)
    tasks2 = state.tasks[:p] + state.tasks[p + 1 :]
    n2 = n - 1
    if n2 == 0:
        return None  # empty survivor set has no walk to warm-start
    opts = PlacementOptions(**placement_kw)
    k = opts.resilience
    removed = state.tasks[p]
    share_vecs = tuple(t.shares(fleet.t_slr) for t in tasks2)
    power_vecs = tuple(t.powers() for t in tasks2)
    pow_p = removed.powers()
    shr_min = float(removed.shares(fleet.t_slr).min())

    # --- incumbent: the old winner minus the exiting task, re-verified
    # from scratch (the greedy simulator is not monotone under removals).
    P_inc = np.inf
    if state.result.feasible:
        prev = state.result.combo
        idx2 = [int(j) for i, j in enumerate(prev.variant_idx) if i != p]
        combo = _combo_from_idx(idx2, share_vecs, power_vecs)
        w = np.asarray([float(sum(combo.shares))])
        if _eq7_leaf_mask(fleet, n2, w, k)[0] and _probe_row(
            np.asarray(combo.shares), tasks2, fleet, opts, walk_stats
        )[0]:
            P_inc = combo.total_power
    band = P_inc if min_band is None else max(P_inc, float(min_band))

    # Horizon: every extension of an in-band projected row — and of any
    # gap row's covering extension — has total power at most the band
    # plus the exiting task's costliest variant.  Recording coverage
    # through H decides band membership *and* gap coverage exactly.
    pmax = float(pow_p.max())
    if np.isfinite(band):
        H = band + pmax + 1e-9 * max(1.0, abs(band) + pmax)
    else:
        H = np.inf
    if H > state.complete_below:
        return None
    all_pow, all_sumshr, all_chosen, all_verdict, all_depth = _drain_band(
        state, H
    )

    # --- projection: coarse power prefilter, then exact per-column
    # refolds over the surviving axes, then the exact eq-7 and incumbent
    # filters, then dedup over the dropped variant axis.  The prefilter
    # compares each row's total minus its dropped variant's power — that
    # differs from the exact refolded survivor sum only by fold
    # association (ulps), so padding the threshold by a relative 1e-7
    # guarantees no row the exact ``keep`` filter would accept is lost.
    #
    # Banded phases: the post-exit winner usually sits far below the
    # incumbent band (a removal frees capacity), while the band's width
    # exists to seed the carry-over state.  Projecting and deduping the
    # whole band on every event would dwarf the walk itself on large
    # recordings, so phase 1 caps the candidate set at the ``_EXIT_CAP``
    # cheapest recorded parents; every candidate left out has a strictly
    # higher survivor power than any phase-1 winner, so a winner found
    # in phase 1 is the global one with the exact cold rank.  Only a
    # winnerless phase 1 falls through to the full band.  The emitted
    # ``complete_below`` is the band the returning phase actually
    # covered, so the carry-over state stays honest either way.
    approx2 = None
    tol_max = 0.0
    if np.isfinite(band) and all_pow.size:
        if removed.nv == 1:
            approx2 = all_pow - float(pow_p[0])  # no per-row gather needed
        else:
            approx2 = all_pow - pow_p[all_chosen[:, p]]
        tol_max = 1e-7 * max(1.0, float(np.max(np.abs(all_pow))))
    phases: list[tuple[float, float]] = []
    if approx2 is not None and approx2.size > _EXIT_CAP:
        b_sel = float(np.partition(approx2, _EXIT_CAP)[_EXIT_CAP])
        b_cov = b_sel - tol_max
        if min_band is not None and b_cov < float(min_band):
            b_cov = float(min_band)
            b_sel = b_cov + tol_max
        if b_cov < band:
            phases.append((b_sel, b_cov))
    phases.append((np.inf, band))

    # --- gap walk: shrunken-set rows whose every extension broke the old
    # budget.  A subtree is covered (pruned) when even its largest
    # completion, extended with the exiting task's *minimum*-share
    # variant, passes the old eq-7 — the pass is antitone in the folded
    # sum, so that one variant decides the existential.  Survivor leaves
    # get the exact insert-fold test below.
    _, shr_hi2 = _suffix_max_bounds(share_vecs) if n2 else (None, np.zeros(1))

    def covered(d: int, pshr: np.ndarray) -> np.ndarray:
        u = pshr + shr_hi2[d] + shr_min
        u = u + (np.abs(u) + 1.0) * 1e-12
        return _eq7_leaf_mask(fleet, n, u, k)

    for b_sel, b_cov in phases:
        last_phase = b_cov >= band or not np.isfinite(band)
        if approx2 is None:
            idxc = np.arange(all_pow.size)
        elif last_phase:
            tol = 1e-7 * np.maximum(1.0, np.abs(all_pow))
            idxc = np.flatnonzero(approx2 <= band + tol)
        else:
            idxc = np.flatnonzero(approx2 <= b_sel)
        ch2 = all_chosen[idxc][:, [c for c in range(n) if c != p]]
        pw2 = np.zeros(idxc.size)
        w2 = np.zeros(idxc.size)
        for m in range(n2):
            col = ch2[:, m]
            pw2 = pw2 + power_vecs[m][col]
            w2 = w2 + share_vecs[m][col]
        keep = (pw2 <= b_cov) & _eq7_leaf_mask(fleet, n2, w2, k)
        sel = idxc[keep]
        ch2 = ch2[keep]
        pw2 = pw2[keep]
        w2 = w2[keep]
        if removed.nv == 1:
            # One dropped variant => distinct parents stay distinct on
            # the surviving axes: the dedup is the identity.
            uniq = first = inv = np.arange(ch2.shape[0])
        elif ch2.shape[0]:
            flat = np.ravel_multi_index(
                tuple(ch2[:, m] for m in range(n2)), tuple(t.nv for t in tasks2)
            )
            uniq, first, inv = np.unique(
                flat, return_index=True, return_inverse=True
            )
        else:
            uniq = first = inv = np.empty(0, dtype=np.int64)
        proj_pow = pw2[first]
        proj_sumshr = w2[first]
        proj_chosen = ch2[first]
        proj_depth = np.full(uniq.size, -1, dtype=np.int16)
        if uniq.size:
            # Verdict transfer, best-of-group over the dropped variant
            # axis (rows in a dedup group agree on every surviving
            # column, hence share the whole placement prefix):
            #   0  PLACEABLE — only when the exiting task was last (the
            #      simulator's first n-1 steps are exactly the shrunken
            #      instance's walk);
            #   1  REJECT — the recorded primary sweep died at depth
            #      d < p, a fact about the unchanged prefix alone;
            #   2  UNKNOWN.
            # 0 and 1 cannot collide within a group (the shared prefix
            # cannot both place fully and die before p).
            dsel = all_depth[sel]
            dep_rej = (dsel >= 0) & (dsel < p)
            code = np.where(dep_rej, 1, 2).astype(np.int8)
            if p == n - 1:
                code[all_verdict[sel] == VERDICT_PLACEABLE] = 0
            best = np.full(uniq.size, 2, dtype=np.int8)
            np.minimum.at(best, inv, code)
            proj_verdict = np.where(
                best == 0,
                VERDICT_PLACEABLE,
                np.where(best == 1, VERDICT_REJECT, VERDICT_UNKNOWN),
            ).astype(np.int8)
            if dep_rej.any():
                acc = np.full(uniq.size, np.iinfo(np.int16).max, dtype=np.int16)
                np.minimum.at(acc, inv[dep_rej], dsel[dep_rej])
                proj_depth = np.where(best == 1, acc, -1).astype(np.int16)
        else:
            proj_verdict = np.full(uniq.size, VERDICT_UNKNOWN, dtype=np.int8)

        genum = BlockEnumerator(
            tasks2,
            fleet,
            resilience=k,
            incumbent_power=float(b_cov) if np.isfinite(b_cov) else None,
            cover_prune=covered,
        )
        gpow: list[np.ndarray] = []
        gsum: list[np.ndarray] = []
        gch: list[np.ndarray] = []
        while True:
            blk = genum.next_block(65536)
            if blk is None:
                break
            acc = np.zeros(len(blk))
            for m in range(p):
                acc = acc + share_vecs[m][blk.variant_idx[:, m]]
            acc = acc + shr_min
            for m in range(p, n2):
                acc = acc + share_vecs[m][blk.variant_idx[:, m]]
            g = ~_eq7_leaf_mask(fleet, n, acc, k)
            if g.any():
                gpow.append(blk.total_power[g])
                gsum.append(blk.sum_shr[g])
                gch.append(blk.variant_idx[g])
        if gpow:
            cand_pow = np.concatenate([proj_pow] + gpow)
            cand_sumshr = np.concatenate([proj_sumshr] + gsum)
            cand_chosen = np.concatenate([proj_chosen] + gch, axis=0)
            cand_verdict = np.concatenate(
                [proj_verdict]
                + [np.full(a.size, VERDICT_UNKNOWN, dtype=np.int8) for a in gpow]
            )
            cand_depth = np.concatenate(
                [proj_depth]
                + [np.full(a.size, -1, dtype=np.int16) for a in gpow]
            )
        else:
            cand_pow, cand_sumshr = proj_pow, proj_sumshr
            cand_chosen, cand_verdict = proj_chosen, proj_verdict
            cand_depth = proj_depth
        order = _emission_order(cand_pow, cand_chosen)
        cand_pow = cand_pow[order]
        cand_sumshr = cand_sumshr[order]
        cand_chosen = cand_chosen[order]
        cand_verdict = cand_verdict[order]
        cand_depth = cand_depth[order]
        win, verd, dep = _walk_candidates(
            cand_chosen,
            cand_verdict,
            cand_depth,
            tasks2,
            fleet,
            backend,
            opts,
            walk_stats,
        )
        if win < 0 and not last_phase:
            continue  # winner above the phase-1 band: run the full band
        return _finish_warm(
            tasks2,
            fleet,
            backend,
            placement_kw,
            cand_pow,
            cand_sumshr,
            cand_chosen,
            verd,
            dep,
            win,
            b_cov,
            "warm_exit",
            None,
            (),
            share_vecs,
            power_vecs,
        )
    return None  # unreachable: the full-band phase always returns


def _replan_failure(
    state: PlanState,
    new_fleet: FleetSpec,
    dropped: int,
    *,
    backend: PlacementBackend,
    walk_stats: WalkStats | None,
    min_band: float | None = None,
    **placement_kw,
) -> ScheduleResult | None:
    """Warm path for one dropped device; None means fall back.

    Task set and variants are unchanged, so the recorded rows — powers,
    folds, variant choices — describe the new instance verbatim; only
    the eq-7 membership test moves to the shrunken fleet.  Homogeneous
    fleets need no gap walk (the budget is float-monotone in ``n_f``,
    so the new TFS is a subset of the old) and keep every recorded
    reject (the smaller fleet is a device prefix — with ``resilience=k``
    its worst-case survivors are a prefix of the old survivors too).
    Heterogeneous drops keep rejects only for the last device at
    ``k=0`` and recover old-eq-7-pruned rows with a covered gap walk.
    """
    old = state.fleet
    tasks = state.tasks
    n = len(tasks)
    opts = PlacementOptions(**placement_kw)
    k = opts.resilience
    if k >= new_fleet.n_f:
        return None  # shrunken below the guarantee: general path answers
    share_vecs = tuple(t.shares(new_fleet.t_slr) for t in tasks)
    power_vecs = tuple(t.powers() for t in tasks)

    # --- incumbent: the old winner re-verified against the new fleet.
    P_inc = np.inf
    if state.result.feasible:
        combo = state.result.combo
        w = np.asarray([float(sum(combo.shares))])
        if _eq7_leaf_mask(new_fleet, n, w, k)[0] and _probe_row(
            np.asarray(combo.shares), tasks, new_fleet, opts, walk_stats
        )[0]:
            P_inc = combo.total_power
    # The failure chain widens the band past the incumbent so the
    # re-append of the chain's arrivals finds its rows recorded; extra
    # rows sort after the winner and cannot change the result.
    band = P_inc if min_band is None else max(P_inc, float(min_band))
    if band > state.complete_below:
        return None
    all_pow, all_sumshr, all_chosen, all_verdict, _ = _drain_band(state, band)

    mask = _eq7_leaf_mask(new_fleet, n, all_sumshr, k)
    if np.isfinite(band):
        mask &= all_pow <= band
    sel = np.flatnonzero(mask)
    cand_pow = all_pow[sel]
    cand_sumshr = all_sumshr[sel]
    cand_chosen = all_chosen[sel]
    # Recorded death depths describe the *old* fleet's sweep — a fleet
    # change invalidates them, so every carried row restarts at -1.
    cand_depth = np.full(sel.size, -1, dtype=np.int16)
    transfer = (not old.is_heterogeneous) or (dropped == old.n_f - 1 and k == 0)
    if transfer:
        cand_verdict = np.where(
            all_verdict[sel] == VERDICT_REJECT, VERDICT_REJECT, VERDICT_UNKNOWN
        ).astype(np.int8)
    else:
        cand_verdict = np.full(sel.size, VERDICT_UNKNOWN, dtype=np.int8)

    if old.is_heterogeneous:
        # --- gap walk: rows the *old* fleet's tighter eq-7 pruned but the
        # new fleet admits (device mixes can tighten non-monotonically).
        # A subtree is covered when even its largest completion passes
        # the old eq-7; survivor leaves get the exact old-fold test.
        _, shr_hi = _suffix_max_bounds(share_vecs)

        def covered(d: int, pshr: np.ndarray) -> np.ndarray:
            u = pshr + shr_hi[d]
            u = u + (np.abs(u) + 1.0) * 1e-12
            return _eq7_leaf_mask(old, n, u, k)

        genum = BlockEnumerator(
            tasks,
            new_fleet,
            resilience=k,
            incumbent_power=float(band) if np.isfinite(band) else None,
            cover_prune=covered,
        )
        gpow: list[np.ndarray] = []
        gsum: list[np.ndarray] = []
        gch: list[np.ndarray] = []
        while True:
            blk = genum.next_block(65536)
            if blk is None:
                break
            g = ~_eq7_leaf_mask(old, n, blk.sum_shr, k)
            if g.any():
                gpow.append(blk.total_power[g])
                gsum.append(blk.sum_shr[g])
                gch.append(blk.variant_idx[g])
        if gpow:
            cand_pow = np.concatenate([cand_pow] + gpow)
            cand_sumshr = np.concatenate([cand_sumshr] + gsum)
            cand_chosen = np.concatenate([cand_chosen] + gch, axis=0)
            cand_verdict = np.concatenate(
                [cand_verdict]
                + [np.full(a.size, VERDICT_UNKNOWN, dtype=np.int8) for a in gpow]
            )
            cand_depth = np.full(cand_pow.size, -1, dtype=np.int16)
            order = _emission_order(cand_pow, cand_chosen)
            cand_pow = cand_pow[order]
            cand_sumshr = cand_sumshr[order]
            cand_chosen = cand_chosen[order]
            cand_verdict = cand_verdict[order]
    # (No merge -> no reorder: recorded rows are already emission-ordered
    # and filtering preserves that.)
    win, verd, dep = _walk_candidates(
        cand_chosen,
        cand_verdict,
        cand_depth,
        tasks,
        new_fleet,
        backend,
        opts,
        walk_stats,
    )
    return _finish_warm(
        tasks,
        new_fleet,
        backend,
        placement_kw,
        cand_pow,
        cand_sumshr,
        cand_chosen,
        verd,
        dep,
        win,
        band,
        "warm_failure",
        None,
        (),
        share_vecs,
        power_vecs,
    )
