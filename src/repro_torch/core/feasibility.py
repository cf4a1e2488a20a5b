"""Algorithm 1 — Searching of Feasible Task Sets (paper §III-A1).

Builds the TSS (all ``prod(nv_i)`` variant combinations), applies the
workability condition (eq. 7)

    sum_shr  <=  n_f * t_slr - n_t * t_cfg

and partitions TSS into TFS (fit) / TNFS (not fit).

Three engines are provided:

* ``search_feasible`` — the paper's exhaustive enumeration, vectorised:
  the sum-of-shares over the Cartesian product is an outer-sum computed
  by numpy broadcasting instead of the paper's nested loops.
* ``iter_feasible_pruned`` — branch-and-bound enumeration in ascending
  power order that never materialises TSS; used when ``prod(nv_i)`` is
  too large to hold (the paper's algorithm is O(prod nv_i) memory).
* ``iter_feasible_pruned_blocks`` — the same search, block-native: the
  frontier lives in numpy arrays and whole power-ordered
  :class:`ComboBlock` batches come out at once, ready for a placement
  backend's ``place_block`` — no per-row heap pushes or
  :class:`TaskSetCombo` objects on the hot path.

All three engines emit the TFS in the *same* total order — ascending
total power, exact-power ties broken by TSS flat (C-order) index — so
the scheduler's chosen rank and reject counts are engine-independent
even when distinct combos share a power value.

Enumeration runs on the host in numpy, for every placement engine: only
the Alg-2 sweep over each emitted block goes to the device.  The float64
operations and their order are the JAX package's, so the emitted blocks
are bit-identical to its enumerators'.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Iterable, Iterator, Sequence

import numpy as np

from .task import FleetSpec, Task, TaskSetCombo, combo_count, validate_tasks

__all__ = [
    "FeasibilityResult",
    "ComboBlock",
    "BlockEnumerator",
    "search_feasible",
    "iter_feasible_pruned",
    "iter_feasible_pruned_blocks",
    "outer_sum",
    "config_overhead_lower_bound",
]


@dataclasses.dataclass
class FeasibilityResult:
    """TFS/TNFS split plus the arrays needed downstream (Alg 2)."""

    tasks: tuple[Task, ...]
    fleet: FleetSpec
    n_combos: int  # |TSS|
    # Arrays over the full TSS, flattened in C order of variant indices.
    sum_shr: np.ndarray  # (n_combos,)
    total_power: np.ndarray  # (n_combos,)
    fit_mask: np.ndarray  # (n_combos,) bool — eq. 7
    budget: float  # RHS of eq. 7

    @property
    def n_tfs(self) -> int:
        return int(self.fit_mask.sum())

    @property
    def n_tnfs(self) -> int:
        return self.n_combos - self.n_tfs

    def combo_at(self, flat_index: int) -> TaskSetCombo:
        """Materialise one TSS row from its flat index."""
        nvs = [t.nv for t in self.tasks]
        idx = np.unravel_index(flat_index, nvs)
        shares = tuple(
            float(t.shares(self.fleet.t_slr)[j]) for t, j in zip(self.tasks, idx, strict=True)
        )
        powers = tuple(float(t.variants[j].power) for t, j in zip(self.tasks, idx, strict=True))
        return TaskSetCombo(tuple(int(j) for j in idx), shares, powers)

    def _share_columns(self) -> "tuple[list[np.ndarray], list[int]]":
        """Per-task eq-5 share vectors (and nv list), computed once.

        :meth:`shares_matrix` runs once per dispatched block on the
        scheduler's hot path — recomputing ``t.shares`` (a fresh
        exec-times array per call) for every gather dominated deep
        walks, and dominated the whole batched ``schedule_many`` floor.
        """
        cached = getattr(self, "_share_cols", None)
        if cached is None:
            cached = (
                [t.shares(self.fleet.t_slr) for t in self.tasks],
                [t.nv for t in self.tasks],
            )
            self._share_cols = cached
        return cached

    def shares_matrix(self, flat_indices: np.ndarray) -> np.ndarray:
        """Materialise a block of TSS rows as a ``(B, n_t)`` shares matrix.

        The vectorised counterpart of :meth:`combo_at` — one fancy-indexed
        gather per task instead of B Python round-trips; this is what feeds
        a placement backend's ``place_block``.
        """
        flat_indices = np.asarray(flat_indices, dtype=np.int64)
        cols, nvs = self._share_columns()
        idx = np.unravel_index(flat_indices, nvs)
        out = np.empty((flat_indices.size, len(cols)), dtype=np.float64)
        for i, (col, ji) in enumerate(zip(cols, idx, strict=True)):
            np.take(col, ji, out=out[:, i])
        return out

    def tfs_indices_by_power(self) -> np.ndarray:
        """Flat indices of TFS rows, ascending total power (Alg 2 line 1).

        Exact-power ties are broken by ascending flat (C-order TSS) index
        — the stable sort below — so the ordering is deterministic and
        matches the streamed engines (``iter_feasible_pruned*``) exactly.
        """
        tfs = np.flatnonzero(self.fit_mask)
        # Stable sort: ties broken by TSS enumeration (flat-index) order,
        # matching the paper's "Assc. Sort on TFS" over the generated list.
        order = np.argsort(self.total_power[tfs], kind="stable")
        return tfs[order]

    def iter_tfs_by_power(self) -> Iterator[TaskSetCombo]:
        for i in self.tfs_indices_by_power():
            yield self.combo_at(int(i))


def outer_sum(vectors: Sequence[np.ndarray]) -> np.ndarray:
    """Sum over the Cartesian product of 1-D vectors, returned flat (C order).

    outer_sum([a, b, c])[i*len(b)*len(c) + j*len(c) + k] == a[i]+b[j]+c[k]

    The result buffer is allocated once at its final ``prod(len(v))`` size
    and each level accumulates in place through a strided view, so peak
    memory is one f64 output array (the old broadcast-per-level fold held
    the previous level alive while materialising the next — up to 1.5x
    the output at the last level).  The accumulation order is the same
    left-to-right fold, so results are bit-identical.
    """
    sizes = [np.asarray(v).shape[0] for v in vectors]
    total = int(np.prod(sizes, dtype=np.int64)) if sizes else 1
    out = np.zeros(total, dtype=np.float64)
    if total == 0:
        return out  # a zero-length factor: the Cartesian product is empty
    stride = total
    for level, v in enumerate(vectors):
        v = np.asarray(v, dtype=np.float64)
        stride //= v.shape[0]
        view = out.reshape(-1, v.shape[0], stride)
        if level == 0:
            view[...] = v[None, :, None]
        else:
            view += v[None, :, None]
    return out


def config_overhead_lower_bound(
    fleet: FleetSpec, n_t: int, sum_shr: np.ndarray, extra_cfgs: int = 1
) -> np.ndarray:
    """Per-class refinement of the eq. 7 configuration charge, vectorised.

    For a heterogeneous fleet the paper's flat ``(n_t + 1) * t_cfg`` charge
    has no single ``t_cfg``.  The sound necessary-condition charge is a
    *lower bound* on the total reconfiguration time any placement of a
    combo with total share ``W = sum_shr`` must pay:

    * a combo needs at least ``d(W)`` devices, where ``d(W)`` is the
      smallest count of devices (taken largest-capacity-first) whose
      ``t_slr_j`` sum covers ``W`` — and every used device pays at least
      one of its own ``t_cfg_j`` (lower-bounded by the ``d(W)`` cheapest
      cfgs in the fleet);
    * there are at least ``max(n_t + extra_cfgs, d(W))`` configuration
      events in total; events beyond the per-device minimum pay at least
      the fleet-wide cheapest ``t_cfg``.

    On a homogeneous fleet with ``d(W) <= n_t + extra_cfgs`` this reduces
    exactly to the paper's ``(n_t + extra_cfgs) * t_cfg``.

    Soundness: with ``extra_cfgs=0`` every placement really pays at least
    this overhead (each task one cfg, each necessarily-used device one of
    its own cfgs), so rejection is a strict necessary condition.  The
    default ``extra_cfgs=1`` inherits the paper's one-split allowance —
    like eq. 7 itself it can reject a combo that happens to place with no
    split (the documented Example-1 deviation); it is the same charge the
    homogeneous pre-filter applies, refined per device class.
    """
    sum_shr = np.asarray(sum_shr, dtype=np.float64)
    m = n_t + extra_cfgs
    cap_desc = np.sort(fleet.t_slr_arr)[::-1]
    cfg_asc = np.sort(fleet.t_cfg_arr)
    cfg_min = float(cfg_asc[0]) if cfg_asc.size else 0.0
    # d(W): min devices whose (descending) capacities cover W.
    cum_cap = np.cumsum(cap_desc)
    d = np.searchsorted(cum_cap, sum_shr - 1e-9) + 1
    d = np.minimum(d, fleet.n_f)
    # Sum of the d cheapest per-device cfgs, one per necessarily-used device.
    cum_cfg = np.concatenate([[0.0], np.cumsum(cfg_asc)])
    per_device = cum_cfg[d]
    extra_events = np.maximum(m - d, 0)
    return per_device + extra_events * cfg_min


def search_feasible(
    tasks: Sequence[Task], fleet: FleetSpec, *, resilience: int = 0
) -> FeasibilityResult:
    """Algorithm 1, vectorised. Materialises |TSS| f64 arrays (twice).

    Safe up to ~10^8 combinations on a 32 GB host; beyond that use
    ``iter_feasible_pruned``.

    Heterogeneous fleets additionally apply the per-class configuration
    charge of :func:`config_overhead_lower_bound` (eq. 7 generalises to
    ``sum_shr <= sum_j t_slr_j - overhead_lb``); homogeneous fleets keep
    the paper's flat charge so the published Example-1/3 counts hold.

    ``resilience=k`` tightens eq. 7 to the *worst-case survivor fleet*
    (``fleet.survivors(k)``): a k-resilient verdict requires placement on
    the surviving ``n_f - k`` devices, so their smaller budget is the
    sound necessary condition — shares stay computed against the full
    fleet's reference ``t_slr`` (eq. 5 is a task property, not a fleet
    head-count property).  Raises ``ValueError`` when ``k >= n_f`` (the
    scheduler answers that case with an infeasible result up front).
    """
    tasks = tuple(tasks)
    validate_tasks(tasks)
    n_t = len(tasks)
    n_combos = combo_count(tasks)
    if n_combos > 200_000_000:
        raise ValueError(
            f"|TSS|={n_combos:,} too large to materialise; "
            "use iter_feasible_pruned()"
        )
    # n_t == 0 is vacuously resilient (nothing to place), so the empty
    # task set skips the survivor tightening even when k >= n_f.
    bfleet = fleet.survivors(resilience) if resilience and n_t else fleet
    share_vecs = [t.shares(fleet.t_slr) for t in tasks]
    power_vecs = [t.powers() for t in tasks]
    sum_shr = outer_sum(share_vecs)
    total_power = outer_sum(power_vecs)
    budget = bfleet.workable_budget(n_t)
    fit = sum_shr <= budget + 1e-9  # eq. 7 (tolerant <=)
    if bfleet.is_heterogeneous:
        overhead = config_overhead_lower_bound(bfleet, n_t, sum_shr)
        fit &= sum_shr <= bfleet.capacity - overhead + 1e-9
    return FeasibilityResult(
        tasks=tasks,
        fleet=fleet,
        n_combos=n_combos,
        sum_shr=sum_shr,
        total_power=total_power,
        fit_mask=fit,
        budget=budget,
    )


def _suffix_min_bounds(vecs: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Suffix minima plus a strictly-admissible float underestimate.

    ``suf[d]`` is the minimum achievable sum over tasks ``d..n_t-1``
    (backward cumsum of per-task minima).  Prefix sums accumulate
    *forward*, so ``suf`` can exceed the true forward-folded completion
    sum by a few ulps of association error — enough to break best-first
    pop order or prune an on-the-boundary leaf.  ``lo`` subtracts a
    relative margin dwarfing any accumulated rounding, making
    ``prefix + lo[d]`` a certain lower bound on every completion; the
    margin is orders of magnitude below the 1e-9 eq-7 tolerance, so it
    admits no spurious rows.  ``lo[n_t] == 0.0`` exactly: leaf-depth
    checks and priorities stay bit-identical to the exhaustive engine's.
    """
    mins = np.asarray([v.min() for v in vecs], dtype=np.float64)
    suf = np.concatenate([np.cumsum(mins[::-1])[::-1], [0.0]])
    lo = suf - (np.abs(suf) + 1.0) * 1e-12
    lo[-1] = 0.0
    return suf, lo


def _suffix_max_bounds(vecs: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Suffix maxima plus a certain float *over*estimate — the mirror of
    :func:`_suffix_min_bounds` for cover pruning.

    ``suf[d]`` is the maximum achievable sum over tasks ``d..n_t-1``;
    ``hi`` adds a relative margin dwarfing any fold-association error, so
    ``prefix + hi[d]`` certainly bounds every completion's forward-folded
    sum from above.  ``hi[n_t] == 0.0`` exactly (nothing left to add).
    Used by the delta replanner's removal-gap enumeration: a subtree
    whose *over*estimated completion still passes the old instance's
    eq. 7 is provably covered by the old recording and can be pruned.
    """
    maxs = np.asarray([v.max() for v in vecs], dtype=np.float64)
    suf = np.concatenate([np.cumsum(maxs[::-1])[::-1], [0.0]])
    hi = suf + (np.abs(suf) + 1.0) * 1e-12
    hi[-1] = 0.0
    return suf, hi


def _emission_order(pp: np.ndarray, ch: np.ndarray) -> np.ndarray:
    """Permutation sorting rows by the cold emission key.

    Same key as :func:`_sort_emission` — ``(total_power, flat TSS
    index)``, the flat index realised as a lexsort over the variant
    columns — but returned as an index permutation so callers can
    reorder side arrays (verdicts, provenance) along with the rows.
    """
    order = np.argsort(pp, kind="stable")
    pps = pp[order]
    eq = pps[1:] == pps[:-1]
    if eq.any():
        n_t = ch.shape[1]
        starts = np.flatnonzero(np.concatenate([[True], ~eq]))
        ends = np.append(starts[1:], pps.size)
        for a, b in zip(starts, ends, strict=True):
            if b - a > 1:
                sub = ch[order[a:b]]
                o = np.lexsort(tuple(sub[:, k] for k in range(n_t - 1, -1, -1)))
                order[a:b] = order[a:b][o]
    return order


def _scalar_overhead_lb(fleet: FleetSpec, n_t: int, extra_cfgs: int = 1):
    """Scalar-call twin of :func:`config_overhead_lower_bound`.

    Precomputes the capacity/cfg cumsums once and answers single-``W``
    queries with a bisect — bit-identical to the vectorised version (same
    float64 operations in the same order), cheap enough for the per-node
    pushes of the Python heap enumerator.
    """
    cap_desc = np.sort(fleet.t_slr_arr)[::-1]
    cfg_asc = np.sort(fleet.t_cfg_arr)
    cfg_min = float(cfg_asc[0]) if cfg_asc.size else 0.0
    cum_cap = np.cumsum(cap_desc).tolist()
    cum_cfg = np.concatenate([[0.0], np.cumsum(cfg_asc)]).tolist()
    m = n_t + extra_cfgs
    n_f = fleet.n_f

    def overhead(w: float) -> float:
        d = min(bisect.bisect_left(cum_cap, w - 1e-9) + 1, n_f)
        return cum_cfg[d] + max(m - d, 0) * cfg_min

    return overhead


def iter_feasible_pruned(
    tasks: Sequence[Task], fleet: FleetSpec, *, resilience: int = 0
) -> Iterator[TaskSetCombo]:
    """Yield TFS combos in ascending total-power order WITHOUT building TSS.

    Best-first search over the variant lattice: each frontier node fixes the
    variant of a prefix of tasks; its priority is its exact prefix power plus
    a certain lower bound on the suffix power.  A node is pruned when its
    prefix share plus the minimum achievable suffix share already violates
    eq. 7, and — on heterogeneous fleets — when the capacity-aware min-cost
    device-cover refinement (:func:`config_overhead_lower_bound`) already
    rejects every completion; both prefix bounds are exact at leaf depth,
    so the streamed TFS equals the exhaustive ``fit_mask`` row set.
    Memory is O(frontier), not O(|TSS|).

    Exact-power ties are broken by the chosen variant-index tuple
    (lexicographic == TSS flat C order), so the emission order matches
    :meth:`FeasibilityResult.tfs_indices_by_power` combo for combo.

    ``resilience=k`` prunes against the worst-case survivor fleet's
    budget instead (see :func:`search_feasible`) so the streamed TFS
    matches the exhaustive engine's resilience-mode ``fit_mask``.

    This is the reference engine for fleet-scale scheduling; the block
    walk uses the vectorised :func:`iter_feasible_pruned_blocks`.
    """
    tasks = tuple(tasks)
    validate_tasks(tasks)
    n_t = len(tasks)
    bfleet = fleet.survivors(resilience) if resilience and n_t else fleet
    budget = bfleet.workable_budget(n_t)

    shares = [t.shares(fleet.t_slr) for t in tasks]
    powers = [t.powers() for t in tasks]
    _, suf_pow_lo = _suffix_min_bounds(powers) if n_t else (None, np.zeros(1))
    _, suf_shr_lo = _suffix_min_bounds(shares) if n_t else (None, np.zeros(1))

    hetero = bfleet.is_heterogeneous
    capacity = bfleet.capacity
    overhead_lb = _scalar_overhead_lb(bfleet, n_t) if hetero else None

    # Node: (priority, chosen tuple, depth, prefix_pow, prefix_shr).  The
    # chosen tuple is the tiebreak: a prefix sorts before its extensions
    # and full-length tuples compare in TSS flat order, which (with the
    # strictly-admissible priorities) makes the pop order of leaves the
    # exact (total_power, flat_index) order of the materialised TFS.
    heap: list = []

    def push(depth: int, chosen: tuple[int, ...], ppow: float, pshr: float) -> None:
        w_min = pshr + suf_shr_lo[depth]
        if w_min > budget + 1e-9:
            return  # bound: no completion can satisfy eq. 7
        if hetero and w_min > capacity - overhead_lb(w_min) + 1e-9:
            return  # bound: the eq-7 device-cover refinement rejects all
        heapq.heappush(heap, (ppow + suf_pow_lo[depth], chosen, depth, ppow, pshr))

    push(0, (), 0.0, 0.0)
    while heap:
        _, chosen, depth, ppow, pshr = heapq.heappop(heap)
        if depth == n_t:
            # Both prefix bounds were exact at leaf depth (zero suffix),
            # so every popped leaf is a genuine TFS row.
            shr = tuple(float(shares[k][j]) for k, j in enumerate(chosen))
            pw = tuple(float(powers[k][j]) for k, j in enumerate(chosen))
            yield TaskSetCombo(chosen, shr, pw)
            continue
        for j in range(tasks[depth].nv):
            push(
                depth + 1,
                chosen + (j,),
                ppow + float(powers[depth][j]),
                pshr + float(shares[depth][j]),
            )


@dataclasses.dataclass
class ComboBlock:
    """A block of power-ordered TFS rows as arrays — the streaming twin of
    :meth:`FeasibilityResult.shares_matrix` over a slice of
    :meth:`FeasibilityResult.tfs_indices_by_power`.

    ``shares`` feeds a placement backend's ``place_block`` whole; a
    :class:`TaskSetCombo` is materialised (``materialize(row)``) only for
    the single winning row, exactly like the exhaustive block walk.
    ``sum_shr`` carries each row's left-to-right-folded total share — the
    exact value the eq-7 leaf test saw — so a recorded walk
    (:mod:`repro_torch.core.replan`) can re-apply eq. 7 to row *extensions*
    bit-identically to a cold enumeration of the extended task set.
    """

    variant_idx: np.ndarray  # (B, n_t) int64 — variant choice per task
    shares: np.ndarray  # (B, n_t) float64 — eq-5 shares, task-major
    total_power: np.ndarray  # (B,) float64 — bit-identical to outer_sum rows
    sum_shr: np.ndarray | None = None  # (B,) float64 — folded eq-7 LHS
    _share_vecs: tuple = dataclasses.field(default=(), repr=False)
    _power_vecs: tuple = dataclasses.field(default=(), repr=False)

    def __len__(self) -> int:
        return int(self.variant_idx.shape[0])

    def materialize(self, row: int) -> TaskSetCombo:
        idx = self.variant_idx[row]
        shr = tuple(float(v[j]) for v, j in zip(self._share_vecs, idx, strict=True))
        pw = tuple(float(v[j]) for v, j in zip(self._power_vecs, idx, strict=True))
        return TaskSetCombo(tuple(int(j) for j in idx), shr, pw)


class _Frontier:
    """Struct-of-arrays frontier with O(popped) pops and amortised appends.

    Rows live in capacity-doubling buffers; ``pop_smallest`` extracts the
    M cheapest rows (argpartition on the float bound only) and refills the
    holes with rows swapped in from the tail, so a pop copies O(M) rows —
    not the whole frontier, which made tiny-block walks quadratic.
    Frontier-internal row order is irrelevant: emission order is decided
    by the exact leaf keys, the bound only gates it.
    """

    def __init__(self, n_t: int, cap: int = 1024) -> None:
        self.n = 0
        self._n_t = n_t
        self.bound = np.empty(cap)
        self.ppow = np.empty(cap)
        self.pshr = np.empty(cap)
        self.depth = np.empty(cap, dtype=np.int64)
        self.chosen = np.empty((cap, n_t), dtype=np.int64)

    def _grow(self, need: int) -> None:
        cap = self.bound.shape[0]
        if self.n + need <= cap:
            return
        new_cap = max(cap * 2, self.n + need)
        for name in ("bound", "ppow", "pshr", "depth"):
            arr = getattr(self, name)
            buf = np.empty(new_cap, dtype=arr.dtype)
            buf[: self.n] = arr[: self.n]
            setattr(self, name, buf)
        buf = np.empty((new_cap, self._n_t), dtype=np.int64)
        buf[: self.n] = self.chosen[: self.n]
        self.chosen = buf

    def append(self, bound, ppow, pshr, depth: int, chosen) -> None:
        m = bound.shape[0]
        self._grow(m)
        lo, hi = self.n, self.n + m
        self.bound[lo:hi] = bound
        self.ppow[lo:hi] = ppow
        self.pshr[lo:hi] = pshr
        self.depth[lo:hi] = depth
        self.chosen[lo:hi] = chosen
        self.n = hi

    def min_bound(self) -> float:
        return float(self.bound[: self.n].min()) if self.n else np.inf

    def clone(self) -> "_Frontier":
        """Independent copy (buffers trimmed to the live rows)."""
        out = _Frontier.__new__(_Frontier)
        out.n = self.n
        out._n_t = self._n_t
        cap = max(self.n, 1)
        out.bound = self.bound[:cap].copy()
        out.ppow = self.ppow[:cap].copy()
        out.pshr = self.pshr[:cap].copy()
        out.depth = self.depth[:cap].copy()
        out.chosen = self.chosen[:cap].copy()
        return out

    def keep_where(self, mask: np.ndarray) -> None:
        """Drop live rows where ``mask`` is False (bound-pruning on resume)."""
        sel = np.flatnonzero(mask[: self.n])
        m = sel.size
        self.bound[:m] = self.bound[sel]
        self.ppow[:m] = self.ppow[sel]
        self.pshr[:m] = self.pshr[sel]
        self.depth[:m] = self.depth[sel]
        self.chosen[:m] = self.chosen[sel]
        self.n = m

    def pop_smallest(self, m: int):
        n = self.n
        m = min(m, n)
        if m == n:
            sel = np.arange(n)
        else:
            sel = np.argpartition(self.bound[:n], m - 1)[:m]
        out = (
            self.ppow[sel].copy(),
            self.pshr[sel].copy(),
            self.depth[sel].copy(),
            self.chosen[sel].copy(),
        )
        if m < n:
            # Swap tail rows into the popped holes: O(m), order-agnostic.
            in_tail = sel >= n - m
            holes = sel[~in_tail]
            tail_keep = np.ones(m, dtype=bool)
            tail_keep[sel[in_tail] - (n - m)] = False
            tail = (n - m) + np.flatnonzero(tail_keep)
            self.bound[holes] = self.bound[tail]
            self.ppow[holes] = self.ppow[tail]
            self.pshr[holes] = self.pshr[tail]
            self.depth[holes] = self.depth[tail]
            self.chosen[holes] = self.chosen[tail]
        self.n = n - m
        return out


def _sort_emission(
    pp: np.ndarray, ps: np.ndarray, ch: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Order an emission run by ``(total_power, flat TSS index)``.

    Stable argsort on the float powers, then a lexicographic
    variant-index fixup applied only to runs of *exactly* equal power —
    so the common no-tie case never pays an n_t-key lexsort.
    """
    order = np.argsort(pp, kind="stable")
    pp, ps, ch = pp[order], ps[order], ch[order]
    eq = pp[1:] == pp[:-1]
    if eq.any():
        n_t = ch.shape[1]
        starts = np.flatnonzero(np.concatenate([[True], ~eq]))
        ends = np.append(starts[1:], pp.size)
        for a, b in zip(starts, ends, strict=True):
            if b - a > 1:
                sub = ch[a:b]
                o = np.lexsort(tuple(sub[:, k] for k in range(n_t - 1, -1, -1)))
                ch[a:b] = sub[o]
                ps[a:b] = ps[a:b][o]
    return pp, ps, ch


def _drain_chunks(
    chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]], n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pop exactly ``n`` rows off the front of a list of (pp, ps, chosen) runs."""
    pp_parts, ps_parts, ch_parts, got = [], [], [], 0
    while got < n:
        pp, ps, ch = chunks[0]
        need = n - got
        if pp.size <= need:
            pp_parts.append(pp)
            ps_parts.append(ps)
            ch_parts.append(ch)
            got += pp.size
            chunks.pop(0)
        else:
            pp_parts.append(pp[:need])
            ps_parts.append(ps[:need])
            ch_parts.append(ch[:need])
            chunks[0] = (pp[need:], ps[need:], ch[need:])
            got = n
    return (
        np.concatenate(pp_parts),
        np.concatenate(ps_parts),
        np.concatenate(ch_parts, axis=0),
    )


def _size_stream(block_sizes: int | Iterable[int] | None) -> Iterator[int]:
    """Normalise a block-size spec into an endless iterator of sizes."""
    if block_sizes is None:
        block_sizes = 4096
    if isinstance(block_sizes, int):
        if block_sizes < 1:
            raise ValueError(f"block_size must be >= 1, got {block_sizes}")
        return itertools.repeat(block_sizes)

    def gen():
        last = None
        for s in block_sizes:
            s = int(s)
            if s < 1:
                raise ValueError(f"block_size must be >= 1, got {s}")
            last = s
            yield s
        if last is None:
            raise ValueError("block_sizes iterable produced no sizes")
        while True:
            yield last

    return gen()


class BlockEnumerator:
    """Stateful block-native TFS enumerator — the resumable core of
    :func:`iter_feasible_pruned_blocks`.

    The same best-first branch-and-bound search as
    :func:`iter_feasible_pruned`, vectorised: the frontier is a
    struct-of-arrays (priority, prefix power/share, depth, chosen-index
    matrix) and every round pops the cheapest nodes *in bulk*
    (``argpartition``), expands each depth group with one broadcast add
    per task, and prunes children with the vectorised eq-7 prefix bounds
    — including the heterogeneous capacity-aware device-cover refinement
    of :func:`config_overhead_lower_bound`, which shrinks the TFS every
    placement backend has to scan.  Completed rows buffer until no
    frontier node could still produce a cheaper row, then come out
    lexsorted by ``(total_power, flat_index)`` — the exact
    :meth:`FeasibilityResult.tfs_indices_by_power` order, asserted
    combo-for-combo in ``tests/test_block_enumeration.py``.

    Being an explicit object (rather than a generator) gives the delta
    replanner (:mod:`repro_torch.core.replan`) two handles:

    * **snapshot/restore** — :meth:`clone` copies the live frontier,
      buffered leaves and ready runs, so a walk can *resume* exactly where
      a previous one stopped;
    * **incumbent-bound pruning** — :meth:`prune_above` installs an upper
      bound on total power (a known-placeable plan's power): frontier
      nodes whose admissible bound exceeds it can never produce a better
      row and are dropped, before and during expansion.

    ``next_block(want)`` returns the next ``want`` rows in emission order
    as a :class:`ComboBlock` (short only when the walk is exhausted), or
    ``None`` when nothing remains.
    """

    def __init__(
        self,
        tasks: Sequence[Task],
        fleet: FleetSpec,
        *,
        min_expand: int = 16384,
        incumbent_power: float | None = None,
        resilience: int = 0,
        cover_prune=None,
    ) -> None:
        tasks = tuple(tasks)
        validate_tasks(tasks)
        self.tasks = tasks
        self.fleet = fleet
        self.n_t = n_t = len(tasks)
        self.min_expand = min_expand
        self.incumbent_power = (
            float(incumbent_power) if incumbent_power is not None else np.inf
        )
        self.resilience = int(resilience)
        # Optional subtree-coverage hook for the delta replanner's removal
        # gap walk: ``cover_prune(depth, pshr)`` returns a boolean mask of
        # prefix nodes *all* of whose completions are provably present in
        # a previous recording — those subtrees are dropped, so the walk
        # enumerates only the rows projection could have missed.  Dropping
        # covered rows never loses a row the caller cannot recover (they
        # are recovered from the recording), and keeping an uncovered row
        # is always sound: the hook must only return True on certainty.
        self.cover_prune = cover_prune
        # eq. 7 prunes against the worst-case survivor fleet when a
        # resilience guarantee is requested (see search_feasible): its
        # budget is a necessary condition for the survivor sweep, hence
        # for the combined primary-AND-backup verdict.  Shares keep the
        # *original* fleet's reference t_slr.
        bfleet = (
            fleet.survivors(self.resilience) if self.resilience and n_t else fleet
        )
        self.budget = bfleet.workable_budget(n_t)
        self.share_vecs = tuple(t.shares(fleet.t_slr) for t in tasks)
        self.power_vecs = tuple(t.powers() for t in tasks)
        self._bfleet = bfleet
        self._hetero = bfleet.is_heterogeneous
        self._capacity = bfleet.capacity
        self.rows_emitted = 0

        # Completed rows buffer as (pp, ps, chosen) chunks until emittable;
        # the cheap min-per-chunk cache gates nothing-to-emit rounds.
        self._leaf_chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._leaf_min = np.inf
        self._ready: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._n_ready = 0
        self._empty_set_pending = False

        if n_t == 0:
            # The empty task set has exactly one (empty) combo.
            self._frontier = _Frontier(0)
            self._empty_set_pending = bool(self._passes(np.zeros(1))[0]) and (
                0.0 <= self.incumbent_power
            )
            if self._empty_set_pending and self.cover_prune is not None:
                self._empty_set_pending = not bool(
                    self.cover_prune(0, np.zeros(1))[0]
                )
            return

        _, self._pow_lo = _suffix_min_bounds(self.power_vecs)
        _, self._shr_lo = _suffix_min_bounds(self.share_vecs)

        # Frontier: internal nodes only.  ``chosen`` columns beyond a
        # node's depth are 0 and ignored.
        self._frontier = _Frontier(n_t)
        root_bound = 0.0 + self._pow_lo[0]
        root_covered = self.cover_prune is not None and bool(
            self.cover_prune(0, np.zeros(1))[0]
        )
        if (
            self._passes(np.asarray([0.0 + self._shr_lo[0]]))[0]
            and not (root_bound > self.incumbent_power)
            and not root_covered
        ):
            self._frontier.append(
                np.asarray([root_bound]),
                np.zeros(1),
                np.zeros(1),
                0,
                np.zeros((1, n_t), dtype=np.int64),
            )

    # -- construction helpers ------------------------------------------------

    def clone(self) -> "BlockEnumerator":
        """Independent copy of the live search state (frontier, buffered
        leaves, ready runs) sharing the immutable per-task arrays.  The
        clone resumes emission exactly where this enumerator stands; the
        original is untouched — this is the frontier snapshot a
        :class:`repro_torch.core.replan.PlanState` keeps between replans."""
        out = BlockEnumerator.__new__(BlockEnumerator)
        out.__dict__.update(self.__dict__)
        out._frontier = self._frontier.clone()
        # Chunk/run arrays are never mutated in place after creation, so a
        # shallow list copy keeps the clone independent.
        out._leaf_chunks = list(self._leaf_chunks)
        out._ready = list(self._ready)
        return out

    def prune_above(self, incumbent_power: float) -> None:
        """Install an incumbent upper bound on total power.

        Drops every frontier node whose admissible bound — and every
        buffered/ready row whose exact power — exceeds ``incumbent_power``;
        subsequent expansions prune children the same way.  Rows with
        power exactly equal to the bound are kept (the incumbent row
        itself must still be emitted).  Sound because frontier bounds are
        strict underestimates of any completion's power."""
        inc = float(incumbent_power)
        self.incumbent_power = min(self.incumbent_power, inc)
        if self._frontier.n:
            self._frontier.keep_where(
                self._frontier.bound[: self._frontier.n] <= inc
            )
        kept_chunks = []
        self._leaf_min = np.inf
        for pp, ps, ch in self._leaf_chunks:
            m = pp <= inc
            if m.any():
                pp, ps, ch = pp[m], ps[m], ch[m]
                kept_chunks.append((pp, ps, ch))
                self._leaf_min = min(self._leaf_min, float(pp.min()))
        self._leaf_chunks = kept_chunks
        kept_ready = []
        self._n_ready = 0
        for pp, ps, ch in self._ready:
            k = int(np.searchsorted(pp, inc, side="right"))
            if k:
                kept_ready.append((pp[:k], ps[:k], ch[:k]))
                self._n_ready += k
        self._ready = kept_ready

    # -- search internals ----------------------------------------------------

    def _passes(self, w: np.ndarray) -> np.ndarray:
        ok = w <= self.budget + 1e-9
        if self._hetero and ok.any():
            overhead = config_overhead_lower_bound(self._bfleet, self.n_t, w)
            ok &= ~(w > self._capacity - overhead + 1e-9)
        return ok

    def _build_block(
        self, pp: np.ndarray, ps: np.ndarray, ch: np.ndarray
    ) -> ComboBlock:
        if self.n_t:
            shr = np.stack(
                [self.share_vecs[k][ch[:, k]] for k in range(self.n_t)], axis=1
            )
        else:
            shr = np.zeros((pp.shape[0], 0), dtype=np.float64)
        self.rows_emitted += pp.shape[0]
        return ComboBlock(
            variant_idx=ch,
            shares=shr,
            total_power=pp,
            sum_shr=ps,
            _share_vecs=self.share_vecs,
            _power_vecs=self.power_vecs,
        )

    def _expand_round(self, want: int) -> None:
        """One bulk best-first step: pop, expand, prune, gate-emit."""
        frontier = self._frontier
        tasks, n_t = self.tasks, self.n_t
        inc = self.incumbent_power
        # Pop the cheapest M frontier nodes (bulk best-first step).
        M = int(min(frontier.n, max(want, self.min_expand)))
        pop_ppow, pop_pshr, pop_depth, pop_chosen = frontier.pop_smallest(M)

        for d in np.unique(pop_depth):
            d = int(d)
            g = pop_depth == d
            nv = tasks[d].nv
            # One broadcast add per (depth group, task): child prefixes.
            ppow_c = (pop_ppow[g][:, None] + self.power_vecs[d][None, :]).ravel()
            pshr_c = (pop_pshr[g][:, None] + self.share_vecs[d][None, :]).ravel()
            chosen_c = np.repeat(pop_chosen[g], nv, axis=0)
            chosen_c[:, d] = np.tile(
                np.arange(nv, dtype=np.int64), int(g.sum())
            )
            ok = self._passes(pshr_c + self._shr_lo[d + 1])
            if inc != np.inf:
                # Incumbent bound: the admissible power bound (exact at
                # leaf depth) already exceeds a known-placeable plan.
                ok &= ppow_c + self._pow_lo[d + 1] <= inc
            if self.cover_prune is not None and ok.any():
                ok &= ~self.cover_prune(d + 1, pshr_c)
            if not ok.any():
                continue
            ppow_c, pshr_c, chosen_c = ppow_c[ok], pshr_c[ok], chosen_c[ok]
            if d + 1 == n_t:
                self._leaf_chunks.append((ppow_c, pshr_c, chosen_c))
                self._leaf_min = min(self._leaf_min, float(ppow_c.min()))
            else:
                frontier.append(
                    ppow_c + self._pow_lo[d + 1], ppow_c, pshr_c, d + 1, chosen_c
                )

        # A buffered leaf is emittable once every remaining frontier node's
        # (strictly admissible) bound exceeds its exact power: no cheaper
        # row can appear later, so the emission order is final.
        fmin = frontier.min_bound()
        if self._leaf_min < fmin:
            leaf_pp = np.concatenate([c[0] for c in self._leaf_chunks])
            leaf_ps = np.concatenate([c[1] for c in self._leaf_chunks])
            leaf_ch = np.concatenate([c[2] for c in self._leaf_chunks], axis=0)
            emit = leaf_pp < fmin
            self._ready.append(
                _sort_emission(leaf_pp[emit], leaf_ps[emit], leaf_ch[emit])
            )
            self._n_ready += int(emit.sum())
            held = ~emit
            if held.any():
                self._leaf_chunks = [
                    (leaf_pp[held], leaf_ps[held], leaf_ch[held])
                ]
                self._leaf_min = float(leaf_pp[held].min())
            else:
                self._leaf_chunks = []
                self._leaf_min = np.inf

    def _flush_leaves(self) -> None:
        if not self._leaf_chunks:
            return
        leaf_pp = np.concatenate([c[0] for c in self._leaf_chunks])
        leaf_ps = np.concatenate([c[1] for c in self._leaf_chunks])
        leaf_ch = np.concatenate([c[2] for c in self._leaf_chunks], axis=0)
        self._ready.append(_sort_emission(leaf_pp, leaf_ps, leaf_ch))
        self._n_ready += leaf_pp.size
        self._leaf_chunks = []
        self._leaf_min = np.inf

    # -- emission ------------------------------------------------------------

    def next_block(self, want: int) -> ComboBlock | None:
        """The next ``want`` emission-ordered rows, or ``None`` at the end.

        Blocks are full-size while the walk can still produce rows; only
        the final block is short.  Successive calls with varying ``want``
        reproduce :func:`iter_feasible_pruned_blocks` with the same size
        stream exactly."""
        if want < 1:
            raise ValueError(f"block size must be >= 1, got {want}")
        if self.n_t == 0:
            if not self._empty_set_pending:
                return None
            self._empty_set_pending = False
            return self._build_block(
                np.zeros(1), np.zeros(1), np.zeros((1, 0), dtype=np.int64)
            )
        while self._frontier.n and self._n_ready < want:
            self._expand_round(want)
        if not self._frontier.n:
            self._flush_leaves()
        if not self._n_ready:
            return None
        take = min(want, self._n_ready)
        pp, ps, ch = _drain_chunks(self._ready, take)
        self._n_ready -= take
        return self._build_block(pp, ps, ch)

    @property
    def exhausted(self) -> bool:
        """True when no further row can be emitted."""
        return not (
            self._frontier.n
            or self._n_ready
            or self._leaf_chunks
            or self._empty_set_pending
        )


def iter_feasible_pruned_blocks(
    tasks: Sequence[Task],
    fleet: FleetSpec,
    block_sizes: int | Iterable[int] | None = None,
    *,
    min_expand: int = 16384,
    resilience: int = 0,
) -> Iterator[ComboBlock]:
    """Yield the TFS as power-ordered :class:`ComboBlock` array batches.

    Generator facade over :class:`BlockEnumerator` (see its docstring for
    the search itself).  ``block_sizes`` is an int, an iterable (e.g. the
    scheduler's geometric ramp — early blocks small so a shallow winner
    stops the walk cheaply, later blocks large to amortise dispatch), or
    None for a constant 4096.  The final block may be short.

    Example — stream the feasible rows of a 2-task instance:

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
        >>> for blk in iter_feasible_pruned_blocks(tasks, fleet, 4):
        ...     for r in range(len(blk)):
        ...         print(blk.variant_idx[r], blk.total_power[r])
        [0 1] 11.0
        [1 0] 12.0
        [1 1] 14.0

    Rows arrive in ascending total power; the one combo whose summed
    share violates eq. 7 — both tasks in their big-share variant, 60
    against a workable budget of 57 — is pruned without ever being
    materialised.
    """
    sizes = _size_stream(block_sizes)
    enum = BlockEnumerator(
        tasks, fleet, min_expand=min_expand, resilience=resilience
    )
    want = next(sizes)
    while True:
        blk = enum.next_block(want)
        if blk is None:
            return
        yield blk
        want = next(sizes)
