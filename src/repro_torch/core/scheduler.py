"""Algorithm 2 top level + the PADPS-FR scheduler facade.

``select_lowest_power`` walks the power-sorted TFS and returns the first
combination whose placement simulation succeeds — by construction the
minimum-power feasible configuration (paper §III-A2).  The facade walks
the TFS in vectorized blocks through a pluggable placement backend
(:mod:`repro_torch.core.placement_backends`): ``engine="cuda"`` (the
default) sweeps each block with the hand-written CUDA kernel on the card,
``"torch"`` runs the same sweep in plain torch on the CPU, and
``"scalar"`` is the exact one-row-at-a-time oracle.

Block handoff is array-native end to end: the exhaustive path gathers
blocks with :meth:`FeasibilityResult.shares_matrix`, the streaming path
pulls whole :class:`repro_torch.core.feasibility.ComboBlock` batches from
the vectorized branch-and-bound enumerator — no per-row objects until the
single winning row.  Blocks follow a geometric size ramp
(:func:`block_ramp`) so early-winner instances stop after a few cheap
small blocks, and backends with asynchronous dispatch (``"cuda"``) are
double-buffered: block k+1 is enumerated and enqueued while block k's
verdicts come back.  The facade bundles Alg 1 + Alg 2 + Alg 3 and reports
the statistics the paper quotes (|TSS|, |TFS|, |TNFS|, placement rejects,
chosen index).

``schedule(record_state=True)`` snapshots the walk into a
:class:`repro_torch.core.replan.PlanState`, from which
:meth:`PADPSFRScheduler.replan` re-plans arrivals, exits and device
failures warm (:mod:`repro_torch.core.replan`).

:meth:`PADPSFRScheduler.schedule_many` runs many independent instances as
one lockstep walk: each round packs every live instance's next block into
one :class:`InstanceBatch` and sweeps it in one launch of the instance-axis
kernel on ``"cuda"`` (the plain batched sweep on ``"torch"``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Iterable, Iterator, Sequence

import numpy as np

from .feasibility import (
    FeasibilityResult,
    iter_feasible_pruned,
    iter_feasible_pruned_blocks,
    search_feasible,
)
from .placement import PlacementPlan, place_combo
from .placement_backends import (
    InstanceBatch,
    PlacementBackend,
    PlacementOptions,
    dispatch_instance_blocks,
    get_backend,
    resolve_engine,
)
from .task import FleetSpec, Task, TaskSetCombo, combo_count

__all__ = [
    "ScheduleInstance",
    "ScheduleResult",
    "WalkStats",
    "block_ramp",
    "select_lowest_power",
    "select_lowest_power_batched",
    "PADPSFRScheduler",
]

DEFAULT_BLOCK_SIZE = 4096

# Adaptive walk defaults: early blocks small so a shallow winner exits
# after a few cheap dispatches, late blocks large so deep walks amortise
# per-block overhead (enumeration, copies, launches).
RAMP_START = 64
RAMP_CAP = 65536
RAMP_FACTOR = 8

# How many blocks may be in flight at once when the backend supports
# asynchronous dispatch: one syncing + one enqueued (double buffering).
PIPELINE_DEPTH = 2


def block_ramp(
    start: int = RAMP_START, cap: int = RAMP_CAP, factor: int = RAMP_FACTOR
) -> Iterator[int]:
    """Geometric block-size schedule: ``start``, growing ×``factor`` to
    ``cap``, then ``cap`` forever."""
    size = start
    while True:
        yield size
        size = min(size * factor, cap)


@dataclasses.dataclass
class WalkStats:
    """Per-phase host wall-clock breakdown of one Alg-2 block walk.

    ``enumerate_us`` is time producing blocks (Alg-1 streaming or TFS
    gathers), ``place_us`` time dispatching backend sweeps (on ``"cuda"``:
    pinned staging, enqueueing the copies and the launch), ``sync_us`` time
    waiting for verdicts to come back, and ``materialize_us`` the winning
    row's scalar plan.  ``block_sizes`` records the adaptive ramp actually
    dispatched.  ``probe_rows`` counts the rows a re-plan placed with the
    scalar oracle on the host instead (incumbent checks and the warm
    walks' prefix probe; the prefix probe's rows also count in ``rows``).
    """

    enumerate_us: float = 0.0
    place_us: float = 0.0
    sync_us: float = 0.0
    materialize_us: float = 0.0
    rows: int = 0
    probe_rows: int = 0
    block_sizes: list[int] = dataclasses.field(default_factory=list)

    @property
    def total_us(self) -> float:
        return (
            self.enumerate_us + self.place_us + self.sync_us + self.materialize_us
        )

    def as_dict(self) -> dict:
        return {
            "enumerate_us": self.enumerate_us,
            "place_us": self.place_us,
            "sync_us": self.sync_us,
            "materialize_us": self.materialize_us,
            "rows": self.rows,
            "probe_rows": self.probe_rows,
            "n_blocks": len(self.block_sizes),
            "block_sizes": list(self.block_sizes),
        }


@dataclasses.dataclass(frozen=True)
class ScheduleInstance:
    """One independent scheduling problem for :meth:`PADPSFRScheduler.schedule_many`.

    ``fleet=None`` inherits the scheduler's own fleet — the common
    what-if shape (same pod, many candidate task mixes); an explicit
    fleet models a different pod sharing the batched sweep.
    """

    tasks: tuple[Task, ...]
    fleet: FleetSpec | None = None

    def __post_init__(self):
        object.__setattr__(self, "tasks", tuple(self.tasks))


@dataclasses.dataclass
class ScheduleResult:
    feasible: bool
    combo: TaskSetCombo | None
    plan: PlacementPlan | None
    chosen_rank: int  # 0-based rank in power-sorted TFS (-1 if none)
    n_tss: int
    n_tfs: int
    n_tnfs: int
    n_placement_rejects: int  # TFS rows Alg 2 rejected before success
    total_power: float
    # Warm-start snapshot (``schedule(record_state=True)`` / ``replan``):
    # recorded TFS rows + the resumable enumerator, for delta replanning.
    plan_state: "object | None" = dataclasses.field(default=None, repr=False)

    def summary(self, tasks: Sequence[Task] | None = None) -> str:
        if not self.feasible:
            return (
                f"INFEASIBLE: |TSS|={self.n_tss} |TFS|={self.n_tfs} "
                f"|TNFS|={self.n_tnfs}; all TFS rows failed placement"
            )
        assert self.combo is not None
        desc = self.combo.describe(tasks) if tasks else str(self.combo.variant_idx)
        return (
            f"|TSS|={self.n_tss} |TFS|={self.n_tfs} |TNFS|={self.n_tnfs} "
            f"placement-rejects={self.n_placement_rejects} "
            f"chosen-rank={self.chosen_rank} power={self.total_power:g} "
            f"shares={[round(s, 4) for s in self.combo.shares]} [{desc}]"
        )


def select_lowest_power(
    combos_by_power: Iterable[TaskSetCombo],
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    count_all_rejects: bool = False,
    **placement_kw,
) -> tuple[TaskSetCombo | None, PlacementPlan | None, int, int]:
    """Alg 2 lines 2-10: first placeable combo in ascending-power order.

    The paper's walk as written — one full scalar placement simulation per
    row, no blocking, no backend indirection; kept as the independent
    reference for the block walk.  Returns (combo, plan, rank,
    rejects_before_success).  With ``count_all_rejects`` the walk continues
    past the winner to count every placement-rejected TFS row (the paper's
    "156 rejected" statistic).
    """
    rejects = 0
    winner: tuple[TaskSetCombo, PlacementPlan, int] | None = None
    for rank, combo in enumerate(combos_by_power):
        plan = place_combo(combo, tasks, fleet, **placement_kw)
        if plan.feasible:
            if winner is None:
                winner = (combo, plan, rank)
            if not count_all_rejects:
                break
        else:
            rejects += 1
    if winner is None:
        return None, None, -1, rejects
    return winner[0], winner[1], winner[2], rejects


def select_lowest_power_batched(
    combos_by_power: Iterable[TaskSetCombo],
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    count_all_rejects: bool = False,
    block_size: int = DEFAULT_BLOCK_SIZE,
    backend: str | PlacementBackend = "cuda",
    walk_stats: WalkStats | None = None,
    **placement_kw,
) -> tuple[TaskSetCombo | None, PlacementPlan | None, int, int]:
    """Alg 2 over vectorized TFS blocks — same contract as
    :func:`select_lowest_power`.

    Chops a per-row :class:`TaskSetCombo` stream into fixed blocks for the
    placement backend (``"cuda"`` by default; ``"torch"`` on the CPU).  The
    scheduler facade feeds the walk from the block-native enumerator
    instead, which skips the per-row objects; this entry point serves
    external combo streams.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")

    def blocks():
        stream = iter(combos_by_power)
        while True:
            block = list(itertools.islice(stream, block_size))
            if not block:
                return
            yield [c.shares for c in block], block

    return _walk_tfs_blocks(
        blocks(),
        lambda block, r: block[r],
        tasks,
        fleet,
        backend=backend,
        count_all_rejects=count_all_rejects,
        walk_stats=walk_stats,
        **placement_kw,
    )


def _walk_tfs_blocks(
    block_iter,
    materialize,
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    backend: str | PlacementBackend,
    count_all_rejects: bool,
    walk_stats: WalkStats | None = None,
    on_verdict=None,
    **placement_kw,
) -> tuple[TaskSetCombo | None, PlacementPlan | None, int, int]:
    """Shared Alg-2 walk over batched TFS blocks, pipelined.

    ``block_iter`` yields ``(shares_rows, ref)`` pairs (a (B, n_t)
    array-like plus an opaque block reference); ``materialize(ref, row)``
    produces the winning row's :class:`TaskSetCombo`.  Winner/rank/reject
    bookkeeping lives only here — backend-agnostic by construction — so
    no two engines can drift apart.

    Dispatch is double-buffered: each block is enqueued via the backend's
    ``dispatch_block`` (see :mod:`repro_torch.core.placement_backends.base`;
    asynchronous on ``"cuda"``, eager elsewhere) and its verdict resolved
    only once the next block is in flight, so host enumeration and device
    sweeps overlap.  Blocks resolve strictly in rank order, so the
    bookkeeping is identical to the synchronous walk.  Blocks enqueued but
    abandoned once the winner is known are simply dropped: their device
    buffers are stream-ordered and their host buffers held by the resolver.

    ``on_verdict(rank_base, feasible, placed_tasks)`` — when given — is
    called with every resolved block's boolean verdict vector and the
    primary sweep's per-row placed-task counts (including the winning
    block's, before the walk stops).  Abandoned blocks never reach it: the
    delta replanner (:mod:`repro_torch.core.replan`) records those rows as
    *unknown* rather than inventing verdicts.
    """
    if isinstance(backend, str):
        backend = get_backend(backend)
    iis = [t.init_interval for t in tasks]
    t_slr_arr = fleet.t_slr_arr
    t_cfg_arr = fleet.t_cfg_arr
    opts = PlacementOptions(**placement_kw)
    stats = walk_stats if walk_stats is not None else WalkStats()
    # Eager backends compute at dispatch time, so holding a second block
    # in flight would only enumerate/place one ramp-larger block past the
    # winner for nothing; depth > 1 pays off only with async dispatch,
    # which backends declare via `async_dispatch` (base.py).
    depth = PIPELINE_DEPTH if backend.async_dispatch else 1
    now = time.perf_counter

    rejects = 0
    winner: tuple[TaskSetCombo, PlacementPlan, int] | None = None
    rank_base = 0
    # (resolve, ref, rank_base, n_rows) for blocks enqueued but not synced.
    pending: collections.deque = collections.deque()

    def resolve_oldest() -> bool:
        """Sync the oldest in-flight block; True once the winner is known."""
        nonlocal rejects, winner
        resolve, ref, base, n_rows = pending.popleft()
        t0 = now()
        bp = resolve()
        stats.sync_us += (now() - t0) * 1e6
        if on_verdict is not None:
            on_verdict(base, bp.feasible, bp.placed_tasks)
        if winner is None:
            r = bp.first_feasible()
            if r >= 0:
                t0 = now()
                combo = materialize(ref, r)
                plan = place_combo(combo, tasks, fleet, **placement_kw)
                stats.materialize_us += (now() - t0) * 1e6
                winner = (combo, plan, base + r)
                rejects += r  # rows before the first feasible are all rejects
                if count_all_rejects:
                    rejects += int((~bp.feasible[r:]).sum())
                return True
            rejects += n_rows
        else:
            rejects += int((~bp.feasible).sum())
        return winner is not None

    stream = iter(block_iter)
    while True:
        t0 = now()
        item = next(stream, None)
        stats.enumerate_us += (now() - t0) * 1e6
        if item is None:
            break
        shares, ref = item
        n_rows = len(shares)
        t0 = now()
        resolve = backend.dispatch_block(shares, iis, t_slr_arr, t_cfg_arr, opts)
        stats.place_us += (now() - t0) * 1e6
        stats.rows += n_rows
        stats.block_sizes.append(n_rows)
        pending.append((resolve, ref, rank_base, n_rows))
        rank_base += n_rows
        while len(pending) >= depth:
            if resolve_oldest() and not count_all_rejects:
                # Later in-flight blocks hold strictly higher-rank rows;
                # their verdicts are irrelevant once the winner is known.
                pending.clear()
                break
        if winner is not None and not count_all_rejects:
            break
    while pending:
        if resolve_oldest() and not count_all_rejects:
            pending.clear()
    if winner is None:
        return None, None, -1, rejects
    return winner[0], winner[1], winner[2], rejects


def _validate_resilience(placement_kw: dict) -> int:
    """Extract and validate the ``resilience`` placement option.

    Raised here — at the scheduler facade — so a bad ``resilience`` fails
    loudly at ``schedule()`` time instead of deep inside an enumerator or
    backend sweep.  ``k >= n_f`` is *not* an error (fleets shrink under
    failures); the caller answers it with an infeasible result.
    """
    k = placement_kw.get("resilience", 0)
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)) or k < 0:
        raise ValueError(
            f"resilience must be a non-negative integer, got {k!r}"
        )
    return int(k)


def _resilience_infeasible_result(tasks: Sequence[Task]) -> ScheduleResult:
    """The ``k >= n_f`` answer: no combo can survive losing every device.

    The resilient TFS is empty by definition, so ``n_tfs == 0`` and every
    TSS row is unworkable — returned as a result rather than raised so a
    fleet that shrinks below ``k`` degrades instead of crashing.
    """
    n_tss = combo_count(tasks)
    return ScheduleResult(
        feasible=False,
        combo=None,
        plan=None,
        chosen_rank=-1,
        n_tss=n_tss,
        n_tfs=0,
        n_tnfs=n_tss,
        n_placement_rejects=0,
        total_power=float("inf"),
    )


def _block_size_schedule(block_size: int | None) -> Iterator[int]:
    """The walk's block sizes: a fixed size, or the geometric ramp."""
    if block_size is None:
        return block_ramp()
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return itertools.repeat(block_size)


_GATHER_CHUNK = 4096

# Lockstep many-walk block coalescing: each round block covers this many
# solo-schedule blocks, bounded so one packed round (B instances x R
# rows) stays under _MANY_ROUND_ROWS total rows of float64 shares.
_MANY_BLOCK_SCALE = 8
_MANY_ROUND_ROWS = 1 << 18


def _coalesced_sizes(sizes: Iterator[int], rcap: int) -> Iterator[int]:
    """The many-walk's round-block schedule: the solo schedule, coalesced.

    Each round block covers ``_MANY_BLOCK_SCALE`` solo blocks — one
    round's fixed cost is shared by the whole batch, so the batched
    walk's sweet spot is a coarser granularity than a solo walk's, but
    not *too* coarse: rows past the winner are wasted sweep work, so the
    factor stays moderate.  Clamped to ``rcap`` rows so a packed round
    stays within the row budget, and never below the solo size (a user
    who pinned big blocks keeps them).  Verdicts, ranks and reject counts
    are block-size invariant, so this only changes how many rounds a walk
    takes — never what it returns.
    """
    for s in sizes:
        yield max(s, min(s * _MANY_BLOCK_SCALE, rcap))


def _sorted_tfs_blocks(feas: FeasibilityResult, sizes: Iterator[int]):
    """Yield ``(shares_rows, idx_rows)`` blocks of the power-sorted TFS.

    Shares are gathered through :meth:`FeasibilityResult.shares_matrix`
    in chunks of ``_GATHER_CHUNK`` sorted rows and sliced per block, so a
    small fixed block size pays one fancy-indexed gather per few hundred
    blocks instead of one per block.  Block boundaries (and therefore all
    rank/reject bookkeeping) are exactly those of a per-block gather; only
    the copy granularity changes.
    """
    order = feas.tfs_indices_by_power()
    lo = 0
    buf = None
    buf_lo = 0
    while lo < order.size:
        hi = min(lo + next(sizes), order.size)
        if buf is None or hi > buf_lo + buf.shape[0]:
            buf_lo = lo
            end = max(hi, min(lo + _GATHER_CHUNK, order.size))
            buf = feas.shares_matrix(order[lo:end])
        yield buf[lo - buf_lo : hi - buf_lo], order[lo:hi]
        lo = hi


def _select_from_feasibility(
    feas: FeasibilityResult,
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    count_all_rejects: bool = False,
    block_size: int | None = DEFAULT_BLOCK_SIZE,
    backend: str | PlacementBackend,
    walk_stats: WalkStats | None = None,
    **placement_kw,
) -> tuple[TaskSetCombo | None, PlacementPlan | None, int, int]:
    """Exhaustive path: batched sweeps over flat TFS indices.

    Avoids materialising per-row :class:`TaskSetCombo` objects entirely —
    each block is one fancy-indexed shares-matrix gather
    (:meth:`FeasibilityResult.shares_matrix`) handed whole to the backend.
    """
    return _walk_tfs_blocks(
        _sorted_tfs_blocks(feas, _block_size_schedule(block_size)),
        lambda idx, r: feas.combo_at(int(idx[r])),
        tasks,
        fleet,
        backend=backend,
        count_all_rejects=count_all_rejects,
        walk_stats=walk_stats,
        **placement_kw,
    )


def _select_streaming_blocks(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    *,
    count_all_rejects: bool = False,
    block_size: int | None = None,
    backend: str | PlacementBackend,
    walk_stats: WalkStats | None = None,
    **placement_kw,
) -> tuple[TaskSetCombo | None, PlacementPlan | None, int, int]:
    """Streaming path: block-native branch-and-bound feeding the walk.

    :func:`iter_feasible_pruned_blocks` yields whole power-ordered
    :class:`ComboBlock` batches (arrays, no per-row objects); only the
    winning row is materialised as a :class:`TaskSetCombo`.
    """
    sizes = _block_size_schedule(block_size)

    def blocks():
        for blk in iter_feasible_pruned_blocks(
            tasks, fleet, sizes,
            resilience=placement_kw.get("resilience", 0),
        ):
            yield blk.shares, blk

    return _walk_tfs_blocks(
        blocks(),
        lambda blk, r: blk.materialize(r),
        tasks,
        fleet,
        backend=backend,
        count_all_rejects=count_all_rejects,
        walk_stats=walk_stats,
        **placement_kw,
    )


@dataclasses.dataclass
class _InstanceWalk:
    """One instance's private bookkeeping inside the lockstep many-walk.

    Mirrors :func:`_walk_tfs_blocks`' locals exactly — same rank/reject
    accounting, same per-instance block-size ramp — so a batch of one is
    field-identical to a solo walk.
    """

    index: int  # position in the caller's instance list
    tasks: tuple[Task, ...]
    fleet: FleetSpec
    stream: Iterator  # yields (shares_rows, ref)
    materialize: object  # (ref, row) -> TaskSetCombo
    feas: FeasibilityResult | None  # exhaustive-path counts, else None
    iis: list[float] = dataclasses.field(default_factory=list)
    slr_arr: np.ndarray | None = None  # fleet.t_slr_arr, hoisted once
    cfg_arr: np.ndarray | None = None  # fleet.t_cfg_arr, hoisted once
    rank_base: int = 0
    rejects: int = 0
    winner: "tuple[TaskSetCombo, PlacementPlan, int] | None" = None
    done: bool = False  # winner known and no full-reject count requested


def _walk_many_tfs_blocks(
    walks: "list[_InstanceWalk]",
    *,
    backend: PlacementBackend,
    count_all_rejects: bool,
    shard: int | str | None = None,
    walk_stats: WalkStats | None = None,
    **placement_kw,
) -> None:
    """Lockstep Alg-2 walk over many instances' TFS blocks.

    Each round pulls the next block from every live instance's own
    stream (each on its own size ramp, exactly as a solo walk would),
    packs them into one :class:`InstanceBatch`, and dispatches the whole
    round through the backend's raw fleet-parallel surface — on
    ``"cuda"`` one kernel launch per round (two under ``resilience=k``)
    instead of one per instance-block.  A round the raw surface cannot
    take (padded width 0) goes through the trimmed surface
    (:func:`dispatch_instance_blocks`).  Rounds are double-buffered like
    the solo walk's blocks when the backend dispatches asynchronously.

    Per-instance winner/rank/reject bookkeeping is byte-for-byte the
    solo walk's (``resolve_oldest``'s accounting applied to that
    instance's slice of the round), and blocks of one instance resolve
    strictly in that instance's rank order — so each ``_InstanceWalk``
    finishes exactly as if it had walked alone.  Results are left on the
    walks (``winner``/``rejects``); the caller builds ``ScheduleResult``s.
    """
    opts = PlacementOptions(**placement_kw)
    stats = walk_stats if walk_stats is not None else WalkStats()
    # Same declared-pipelining rule as the solo walk: eager engines get depth 1.
    depth = PIPELINE_DEPTH if backend.async_dispatch else 1
    now = time.perf_counter

    # (raw, resolver, entries) per round; entries = [(walk, ref, base, n_rows)].
    pending: collections.deque = collections.deque()

    def apply_verdict(w, ref, base, n_rows, has_feas, first, n_feas, feas_row):
        """One entry's solo-walk bookkeeping, from precomputed reductions.

        ``feas_row`` is a zero-arg thunk for the entry's live (n_rows,)
        feasibility vector — only the rare winning-block path under
        ``count_all_rejects`` actually needs the per-row bits.
        """
        if w.done:
            return  # abandoned in-flight block of a finished walk
        if w.winner is None:
            if has_feas:
                r = first
                t0 = now()
                combo = w.materialize(ref, r)
                plan = place_combo(combo, w.tasks, w.fleet, **placement_kw)
                stats.materialize_us += (now() - t0) * 1e6
                w.winner = (combo, plan, base + r)
                w.rejects += r
                if count_all_rejects:
                    w.rejects += int((~feas_row()[r:]).sum())
                else:
                    w.done = True
            else:
                w.rejects += n_rows
        else:
            w.rejects += n_rows - n_feas

    def resolve_round() -> None:
        raw, resolver, entries = pending.popleft()
        t0 = now()
        results = resolver()
        stats.sync_us += (now() - t0) * 1e6
        if raw:
            # Raw surface: one vectorized reduction pass over the round's
            # (B, R) verdict block instead of B trimmed result objects;
            # rows beyond each entry's live count are padding and masked.
            nb = len(entries)
            feas2d = results[0][:nb].astype(bool, copy=False)
            n_rows_arr = np.fromiter((e[3] for e in entries), dtype=np.int64, count=nb)
            live2d = feas2d & (np.arange(feas2d.shape[1]) < n_rows_arr[:, None])
            has_l = live2d.any(axis=1).tolist()
            first_l = np.argmax(live2d, axis=1).tolist()
            nfeas_l = live2d.sum(axis=1).tolist()
            for k, (w, ref, base, n_rows) in enumerate(entries):
                apply_verdict(
                    w, ref, base, n_rows, has_l[k], first_l[k], nfeas_l[k],
                    lambda k=k, n=n_rows: live2d[k, :n],
                )
        else:
            for (w, ref, base, n_rows), bp in zip(entries, results, strict=True):
                r = bp.first_feasible()
                apply_verdict(
                    w, ref, base, n_rows, r >= 0, r,
                    int(bp.feasible.sum()), lambda bp=bp: bp.feasible,
                )

    live = list(walks)
    while live:
        entries = []
        blocks = []
        t0 = now()
        for w in live[:]:
            if w.done:
                live.remove(w)
                continue
            item = next(w.stream, None)
            if item is None:
                live.remove(w)  # stream exhausted; verdicts may be in flight
                continue
            shares, ref = item
            n_rows = len(shares)
            entries.append((w, ref, w.rank_base, n_rows))
            blocks.append((shares, w.iis, w.slr_arr, w.cfg_arr))
            w.rank_base += n_rows
            stats.rows += n_rows
            stats.block_sizes.append(n_rows)
        stats.enumerate_us += (now() - t0) * 1e6
        if not entries:
            break
        t0 = now()
        batch = InstanceBatch.pack(blocks)
        raw = backend.dispatch_blocks_raw(batch, opts, shard=shard)
        if raw is not None:
            pending.append((True, raw, entries))
        else:
            resolver = dispatch_instance_blocks(backend, batch, opts, shard=shard)
            pending.append((False, resolver, entries))
        stats.place_us += (now() - t0) * 1e6
        while len(pending) >= depth:
            resolve_round()
    while pending:
        resolve_round()


class PADPSFRScheduler:
    """Power-Aware DP-fair Scheduling with Full Reconfiguration.

    The paper's contribution as a reusable component: construct with a
    :class:`FleetSpec`, call :meth:`schedule` with the periodic task set.
    ``exhaustive=None`` auto-selects the vectorised exhaustive engine for
    small variant products and the block-native branch-and-bound streaming
    engine for large ones.  ``engine`` selects the placement backend
    through the registry (:mod:`repro_torch.core.placement_backends`):
    ``"cuda"`` (the default: the hand-written kernel on the card; raises
    ``RuntimeError`` without a CUDA device), ``"torch"`` (the plain sweep
    on the CPU) or ``"scalar"``.  ``"scalar"`` runs the paper's
    row-at-a-time walk (:func:`select_lowest_power`) directly — early exit
    at the winner, bookkeeping independent of the block walk — so
    scalar-vs-block parity tests cross-check two separate Alg-2
    implementations.

    ``block_size=None`` (the default) walks the TFS on the geometric
    ramp (:func:`block_ramp`); pass an int to pin a fixed block size.
    Results are invariant either way.
    """

    def __init__(
        self,
        fleet: FleetSpec,
        *,
        exhaustive: bool | None = None,
        exhaustive_limit: int = 2_000_000,
        engine: str = "cuda",
        block_size: int | None = None,
    ) -> None:
        if block_size is not None and block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.fleet = fleet
        self.exhaustive = exhaustive
        self.exhaustive_limit = exhaustive_limit
        self.engine = resolve_engine(engine)  # raises on unknown names
        self.block_size = block_size
        self._backend = get_backend(self.engine)  # raises if the hardware is missing

    def feasibility(
        self, tasks: Sequence[Task], *, resilience: int = 0
    ) -> FeasibilityResult:
        return search_feasible(tasks, self.fleet, resilience=resilience)

    def _use_exhaustive(self, tasks: Sequence[Task]) -> bool:
        if self.exhaustive is not None:
            return self.exhaustive
        return combo_count(tasks) <= self.exhaustive_limit

    def schedule(
        self,
        tasks: Sequence[Task],
        *,
        count_all_rejects: bool = False,
        walk_stats: WalkStats | None = None,
        record_state: bool = False,
        record_exhaustive: bool = False,
        **placement_kw,
    ) -> ScheduleResult:
        """Run Alg 1 + Alg 2 + Alg 3 on ``tasks``: enumerate the workable
        combos (eq. 7), walk them in ascending total power through the
        placement backend, and return the first placeable combo with its
        full per-device plan.

        ``placement_kw`` are the :class:`PlacementOptions`: ``repay_init``,
        ``t_capture``/``t_store`` (the preemptive baseline's resume cost)
        and ``resilience=k``, which requires the chosen combo to stay
        placeable after *any* k device failures: eq. 7 tightens to the
        worst-case survivor fleet's budget and every candidate row must
        pass a second sweep on ``fleet.survivors(k)``.  The winning plan
        carries its survivor placement as ``plan.backup``.  ``k >= n_f``
        returns an infeasible result rather than raising.

        With ``record_state=True`` the walk additionally snapshots every
        enumerated row, its placement verdict, and the live
        branch-and-bound frontier into ``result.plan_state`` — the
        warm-start input :meth:`replan` needs.  Recording always uses the
        streaming block-native walk (results are bit-identical to the
        exhaustive path either way, but ``n_tfs``/``n_tnfs`` are not
        counted and report ``-1``).  ``record_exhaustive=True``
        additionally walks *past* the winner so every TFS row carries a
        placement verdict — slower once, but later arrival replans skip
        dispatch for all recorded rejects (the service layer's
        steady-state mode).  On ``"cuda"`` the block enqueued past the
        winner is abandoned unresolved, so its rows are recorded with
        unknown verdicts.

        Example (the eq-5 shares here are 30 or 15 per task against a
        2-device budget of ``2*30 - 3*1 = 57``):

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
            >>> res = PADPSFRScheduler(fleet, engine="torch").schedule(tasks)
            >>> res.feasible, res.combo.variant_idx, res.total_power
            (True, (0, 1), 11.0)
        """
        tasks = tuple(tasks)
        resilience = _validate_resilience(placement_kw)
        if resilience >= self.fleet.n_f and tasks:
            return _resilience_infeasible_result(tasks)
        if record_state:
            from . import replan as _replan

            return _replan.schedule_recorded(
                tasks,
                self.fleet,
                self._backend,
                block_size=self.block_size,
                count_all_rejects=count_all_rejects,
                walk_stats=walk_stats,
                exhaustive=record_exhaustive,
                **placement_kw,
            )
        use_exhaustive = self._use_exhaustive(tasks)
        feas = (
            search_feasible(tasks, self.fleet, resilience=resilience)
            if use_exhaustive
            else None
        )
        if self.engine == "scalar":
            # The paper's walk as written: one scalar simulation per row
            # with early exit at the winner, and winner/rank/reject
            # bookkeeping entirely independent of _walk_tfs_blocks — this
            # is what the cross-engine parity tests pin the block walk to.
            stream: Iterator[TaskSetCombo] = (
                feas.iter_tfs_by_power()
                if feas is not None
                else iter_feasible_pruned(tasks, self.fleet, resilience=resilience)
            )
            combo, plan, rank, rejects = select_lowest_power(
                stream,
                tasks,
                self.fleet,
                count_all_rejects=count_all_rejects,
                **placement_kw,
            )
        elif feas is not None:
            combo, plan, rank, rejects = _select_from_feasibility(
                feas,
                tasks,
                self.fleet,
                count_all_rejects=count_all_rejects,
                block_size=self.block_size,
                backend=self._backend,
                walk_stats=walk_stats,
                **placement_kw,
            )
        else:
            combo, plan, rank, rejects = _select_streaming_blocks(
                tasks,
                self.fleet,
                count_all_rejects=count_all_rejects,
                block_size=self.block_size,
                backend=self._backend,
                walk_stats=walk_stats,
                **placement_kw,
            )
        n_tss = combo_count(tasks)
        n_tfs = feas.n_tfs if feas is not None else -1
        n_tnfs = feas.n_tnfs if feas is not None else -1
        return ScheduleResult(
            feasible=combo is not None,
            combo=combo,
            plan=plan,
            chosen_rank=rank,
            n_tss=n_tss,
            n_tfs=n_tfs,
            n_tnfs=n_tnfs,
            n_placement_rejects=rejects,
            total_power=combo.total_power if combo else float("inf"),
        )

    def _coerce_instance(self, inst) -> ScheduleInstance:
        if isinstance(inst, ScheduleInstance):
            return inst
        return ScheduleInstance(tasks=tuple(inst))

    def _instance_walk(
        self,
        index: int,
        inst: ScheduleInstance,
        n_batch: int = 1,
        resilience: int = 0,
    ) -> _InstanceWalk:
        """Build one instance's block stream for the lockstep many-walk.

        Same source selection and same block producers as :meth:`schedule`
        (exhaustive shares-matrix gathers or the streaming block-native
        enumerator, each on its own geometric ramp) so a batch of one
        replays the solo walk exactly.

        For ``n_batch > 1`` the size schedule is coalesced
        (:func:`_coalesced_sizes`): a round's fixed cost — pack, staging,
        launch, resolve — is shared by the whole batch.  Verdicts, ranks
        and reject counts are block-size *invariant*, so coalescing never
        changes results — only ``WalkStats.block_sizes`` records the
        coarser schedule.
        """
        tasks = inst.tasks
        fleet = inst.fleet if inst.fleet is not None else self.fleet
        sizes = _block_size_schedule(self.block_size)
        if n_batch > 1:
            sizes = _coalesced_sizes(sizes, max(1, _MANY_ROUND_ROWS // n_batch))
        if self._use_exhaustive(tasks):
            feas = search_feasible(tasks, fleet, resilience=resilience)
            stream = _sorted_tfs_blocks(feas, sizes)
            materialize = lambda idx, r: feas.combo_at(int(idx[r]))  # noqa: E731
        else:
            feas = None

            def blocks():
                for blk in iter_feasible_pruned_blocks(
                    tasks, fleet, sizes, resilience=resilience
                ):
                    yield blk.shares, blk

            stream = blocks()
            materialize = lambda blk, r: blk.materialize(r)  # noqa: E731
        return _InstanceWalk(
            index=index,
            tasks=tasks,
            fleet=fleet,
            stream=stream,
            materialize=materialize,
            feas=feas,
            iis=[t.init_interval for t in tasks],
            slr_arr=fleet.t_slr_arr,
            cfg_arr=fleet.t_cfg_arr,
        )

    def schedule_many(
        self,
        instances: Sequence["ScheduleInstance | Sequence[Task]"],
        *,
        shard: int | str | None = None,
        count_all_rejects: bool = False,
        walk_stats: WalkStats | None = None,
        **placement_kw,
    ) -> list[ScheduleResult]:
        """Schedule many independent instances as one batched program.

        ``instances`` is a sequence of :class:`ScheduleInstance` (or bare
        task sequences, which inherit this scheduler's fleet).  Each
        round of the lockstep walk packs every live instance's next TFS
        block into one :class:`InstanceBatch` and sweeps them through the
        backend's fleet-parallel surface — on ``"cuda"`` one launch of the
        instance-axis kernel per round (two under ``resilience=k``)
        instead of one launch per instance-block.

        Guarantees (tested per engine in ``tests/test_torch_fleet_parallel.py``):

        * ``schedule_many([])`` returns ``[]``;
        * ``schedule_many([i])[0]`` equals ``schedule(i.tasks)`` field
          for field, for every engine;
        * results are per-instance — an infeasible instance yields its
          own ``feasible=False`` result without disturbing, or being
          disturbed by, its batchmates;
        * verdicts are bit-identical to the loop of solo schedules
          regardless of batch composition.

        ``shard`` is accepted and ignored: one launch runs on one card.
        The scalar engine has no batched surface and simply loops solo
        schedules.  ``walk_stats`` aggregates all instances' phases into
        one :class:`WalkStats` (block sizes interleave round-robin).

            >>> from repro_torch.core.task import FleetSpec, Task, TaskVariant
            >>> def v(th, pw):
            ...     return TaskVariant(cu=1, throughput=th, power=pw)
            >>> a = Task("a", period=10.0, data=20.0, init_interval=1.0,
            ...          variants=(v(2.0, 5.0), v(4.0, 8.0)))
            >>> b = Task("b", period=10.0, data=40.0, init_interval=1.0,
            ...          variants=(v(4.0, 4.0), v(8.0, 6.0)))
            >>> fleet = FleetSpec(n_f=2, t_slr=30.0, t_cfg=1.0)
            >>> sched = PADPSFRScheduler(fleet, engine="torch")
            >>> lo, hi = sched.schedule_many([[a], [a, b]])
            >>> (lo.total_power, hi.total_power)
            (5.0, 11.0)
        """
        insts = [self._coerce_instance(x) for x in instances]
        if not insts:
            return []
        resilience = _validate_resilience(placement_kw)
        if self.engine == "scalar":
            # The row-at-a-time oracle has no block surface to batch; a
            # loop of solo schedules *is* its fleet-parallel semantics.
            return [self._solo_schedule(i, count_all_rejects, placement_kw) for i in insts]
        # Instances whose (own) fleet cannot survive k failures are
        # answered up front, exactly like the solo path — no walk entry.
        results: list[ScheduleResult | None] = [None] * len(insts)
        walks = []
        for i, inst in enumerate(insts):
            fleet = inst.fleet if inst.fleet is not None else self.fleet
            if resilience >= fleet.n_f and inst.tasks:
                results[i] = _resilience_infeasible_result(inst.tasks)
            else:
                walks.append(
                    self._instance_walk(i, inst, n_batch=len(insts), resilience=resilience)
                )
        _walk_many_tfs_blocks(
            walks,
            backend=self._backend,
            count_all_rejects=count_all_rejects,
            shard=shard,
            walk_stats=walk_stats,
            **placement_kw,
        )
        for w in walks:
            combo, plan, rank = w.winner if w.winner is not None else (None, None, -1)
            results[w.index] = ScheduleResult(
                feasible=combo is not None,
                combo=combo,
                plan=plan,
                chosen_rank=rank,
                n_tss=combo_count(w.tasks),
                n_tfs=w.feas.n_tfs if w.feas is not None else -1,
                n_tnfs=w.feas.n_tnfs if w.feas is not None else -1,
                n_placement_rejects=w.rejects,
                total_power=combo.total_power if combo else float("inf"),
            )
        return results

    def _solo_schedule(
        self, inst: ScheduleInstance, count_all_rejects: bool, placement_kw: dict
    ) -> ScheduleResult:
        """One instance through :meth:`schedule`, honouring its fleet."""
        sched = self
        if inst.fleet is not None and inst.fleet is not self.fleet:
            sched = PADPSFRScheduler(
                inst.fleet,
                exhaustive=self.exhaustive,
                exhaustive_limit=self.exhaustive_limit,
                engine=self.engine,
                block_size=self.block_size,
            )
        return sched.schedule(
            inst.tasks, count_all_rejects=count_all_rejects, **placement_kw
        )

    def replan(
        self,
        state,
        tasks: Sequence[Task],
        *,
        fleet: FleetSpec | None = None,
        record_exhaustive: bool = False,
        walk_stats: WalkStats | None = None,
        **placement_kw,
    ) -> ScheduleResult:
        """Reschedule ``tasks`` warm-starting from a previous plan.

        ``state`` is the :class:`repro_torch.core.replan.PlanState` recorded by
        ``schedule(..., record_state=True)`` (or by a previous
        :meth:`replan`).  Three deltas take a warm path: task *arrivals*
        (``tasks`` extends the recorded root's tasks) reuse the recorded
        rows and the surviving branch-and-bound frontier; a single task
        *exit* projects the recorded rows onto the surviving task axes
        and walks only the thin power band the projection cannot cover;
        a single *device failure* (``fleet`` shrinks by one device)
        re-checks the recorded rows against the shrunken fleet's eq-7
        budget, transferring recorded reject verdicts where monotonicity
        makes that sound.  Every warm path emits a fresh carry-over
        ``PlanState``, so consecutive warm events chain.  Any other delta
        falls back to a fresh recorded walk seeded with the previous
        winner as an incumbent power bound; ``record_exhaustive=True``
        makes that fallback a full exhaustive re-record.  Either way the
        returned plan is bit-identical to a cold :meth:`schedule` of the
        same task tuple on the same fleet — only the latency differs.
        See :mod:`repro_torch.core.replan` for the mechanism and the soundness
        argument.

        Example — continue from the :meth:`schedule` doctest's instance,
        with a third task arriving:

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
            >>> sched = PADPSFRScheduler(fleet, engine="torch")
            >>> res = sched.schedule(tasks, record_state=True)
            >>> c = Task("c", period=10.0, data=30.0, init_interval=1.0,
            ...          variants=(v(6.0, 3.0), v(12.0, 9.0)))
            >>> warm = sched.replan(res.plan_state, tasks + [c])
            >>> warm.feasible, warm.combo.variant_idx, warm.total_power
            (True, (1, 1, 0), 17.0)
            >>> cold = sched.schedule(tasks + [c])
            >>> (warm.combo, warm.total_power, warm.chosen_rank) == (
            ...     cold.combo, cold.total_power, cold.chosen_rank)
            True
        """
        from . import replan as _replan

        return _replan.replan(
            state,
            tuple(tasks),
            backend=self._backend,
            fleet=fleet if fleet is not None else self.fleet,
            block_size=self.block_size,
            record_exhaustive=record_exhaustive,
            walk_stats=walk_stats,
            **placement_kw,
        )
