"""Placement-backend contract and registry.

The Alg-2 hot path — *is this TFS row placeable on the fleet?* for a block
of ``B`` power-sorted rows at once — is pluggable.  A backend is any object
implementing :class:`PlacementBackend`:

    place_block(shares, iis, t_slr, t_cfg, opts) -> BatchPlacement

where ``shares`` is the ``(B, n_t)`` float64 shares matrix (one TFS row per
line, tasks in the paper's fixed order), ``iis`` the ``(n_t,)`` per-task
initialization intervals, ``t_slr`` / ``t_cfg`` the ``(n_f,)`` per-device
capacities and reconfiguration costs, and ``opts`` a
:class:`PlacementOptions` carrying the baseline-model knobs
(``t_capture``/``t_store``/``repay_init`` — see
:func:`repro_torch.core.placement.place_shares`).  Blocks arrive as host
numpy arrays (enumeration runs on the host) and verdicts go back as host
numpy arrays; what a backend does in between — plain torch on the CPU, a
CUDA kernel on the card — is its own business.

Every backend must reproduce the scalar oracle's verdicts **bit-for-bit**:
the arithmetic replays the same float64 operations in the same order
(``avail = (c - t_cfg_j) - extra``; ``c' = avail - rem``).  The H100 has
float64 in hardware, so the CUDA engine keeps this contract on the card.

Block-enumeration handoff contract
----------------------------------

The walk (``repro_torch.core.scheduler._walk_tfs_blocks``) feeds backends
whole blocks of *power-ordered* TFS rows and owns all winner/rank/reject
bookkeeping; a backend only ever sees a shares matrix.  The two block
producers are interchangeable by construction:

* exhaustive — ``FeasibilityResult.shares_matrix`` gathers a slice of
  ``tfs_indices_by_power()``;
* streaming — ``feasibility.iter_feasible_pruned_blocks`` yields
  :class:`repro_torch.core.feasibility.ComboBlock` batches straight from
  the vectorized branch-and-bound frontier.

Both emit the same total order (ascending total power, exact ties by TSS
flat index) and the same float64 share values, so a backend's verdicts —
and therefore the chosen rank — cannot depend on which producer ran or on
how the stream was chopped into blocks.  Block sizes follow the walk's
geometric ramp (``scheduler.block_ramp``); a backend must accept any
``B >= 1`` and may not carry state between blocks.

Fleet-parallel batching
-----------------------

The batched unit of work is an :class:`InstanceBatch`: B independent
instances' blocks stacked on a leading instance axis and padded to common
``(R, n_t, n_f)`` extents, with per-instance effective counts
(``n_t_eff``/``n_f_eff``/``n_rows``) marking the live region of each
slice.  Every backend spells out::

    place_blocks(batch, opts, *, shard=None)    -> list[BatchPlacement]
    dispatch_blocks(batch, opts, *, shard=None) -> () -> list[BatchPlacement]
    dispatch_blocks_raw(batch, opts, *, shard=None) -> resolver | None

Each returned :class:`BatchPlacement` is trimmed to that instance's
``n_rows`` and must be **bit-identical** to a solo ``place_block`` on the
trimmed instance (``batch.instance_view(i)``) — padding may never leak
into verdicts.  The canonical reference is :func:`place_instance_blocks`,
the loop over instances.  ``shard`` is accepted and ignored: one launch
runs on one card.  Padding rules (also the rules ``pack`` applies):

* rows ``r >= n_rows[i]``: zero shares; their verdicts are computed but
  meaningless, and are sliced off before a trimmed result is built;
* task columns ``t >= n_t_eff[i]``: never read — the sweep's task cursor
  stops at ``n_t_eff`` (padding with zero-*share* tasks instead would
  change verdicts, because a zero-share task still pays ``t_cfg``);
* device slots ``j >= n_f_eff[i]``: never read — the device cursor dies
  (row infeasible) before touching them.  ``n_f_eff == 0`` with live
  tasks reproduces the empty-fleet early path (all rows infeasible);
  ``n_t_eff == 0`` reproduces the empty-block path (all rows feasible).

The raw surface::

    dispatch_blocks_raw(batch, opts, *, shard=None)
        -> (() -> (feasible, placed_tasks, n_splits, devices_used)) | None

returns a resolver of the four *untrimmed* ``(B, R)`` host verdict arrays
of the fleet-parallel sweep (``kernels.placement_step``): one sweep over
the whole stack, and a second on :func:`survivor_batch_tables` under
``resilience=k`` whose verdict the resolver ANDs into ``feasible``.
Entries outside an instance's live rows are padding; live entries equal
the trimmed surface's.  ``None`` means the batch has padded width 0
(``n_t == 0`` or ``n_f == 0``) or no instance: the sweep cannot take it,
and the trimmed surface answers each instance through ``prepare_block``'s
early paths.  The ``"cuda"`` and ``"torch"`` engines implement it, and
their ``dispatch_blocks`` / ``place_blocks`` trim over it; the ``"scalar"``
engine answers ``None`` and loops over instances.  The lockstep many-walk
(``scheduler._walk_many_tfs_blocks``) prefers the raw surface, so its
round bookkeeping is a handful of vectorized reductions instead of B
per-instance result objects.

Resilience: the second, constrained pass
----------------------------------------

``opts.resilience = k`` (k > 0) turns every placement call into *two*
sweeps: the primary sweep on the full fleet, and a worst-case-survivor
sweep on :func:`survivor_tables` — the fleet minus the k devices whose
loss hurts most (``repro_torch.core.task.worst_case_survivor_indices``).
``feasible`` is the AND of both verdicts; ``placed_tasks`` /
``n_splits`` / ``devices_used`` keep describing the *primary* sweep.  The
survivor set is a function of ``(t_slr, t_cfg, k)`` alone, never of the
candidate row.  ``k >= n_f`` cannot be survived: every row with live tasks
is infeasible (a ``prepare_block`` early path; in a batch, an instance
with ``n_f_eff <= k`` gets an empty survivor fleet from
:func:`survivor_batch_tables`, which gives the same ``feasible``; its
other three outputs keep describing the primary sweep, where the solo
early path reports zeros — as in the reference's batched engines.  The
scheduler answers such instances before any walk, so no caller reads them).

Asynchronous dispatch
---------------------

Every backend also exposes::

    dispatch_block(shares, iis, t_slr, t_cfg, opts) -> () -> BatchPlacement

which *enqueues* the sweep and returns a zero-argument resolver that
blocks until the verdicts are back.  ``dispatch_block(...)()`` must be
indistinguishable from ``place_block(...)`` — same arrays, same bits.  The
walk uses it to double-buffer when the backend declares
``async_dispatch = True`` (the CUDA engine: block k+1 is enumerated and
enqueued while block k's kernel runs); eager engines declare ``False`` and
resolve at once.

Registering a new backend
-------------------------

Decorate a class with :func:`register_backend` and implement the protocol
(see ``torch_backend.py`` for a complete example).  Backends living in
modules that need hardware to be useful register lazily via
``_LAZY_BACKENDS``; ``get_backend`` raises ``RuntimeError`` for a
registered backend whose :meth:`PlacementBackend.available` is False —
there is no silent fallback to another engine.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Protocol, runtime_checkable

import numpy as np

from ..task import worst_case_survivor_indices

__all__ = [
    "BatchPlacement",
    "InstanceBatch",
    "PlacementOptions",
    "PlacementBackend",
    "register_backend",
    "get_backend",
    "resolve_engine",
    "backend_names",
    "available_backends",
    "prepare_block",
    "place_instance_blocks",
    "dispatch_instance_blocks",
    "survivor_tables",
    "survivor_batch_tables",
    "prepare_batch",
    "trim_raw_dispatch",
]


@dataclasses.dataclass
class BatchPlacement:
    """Vectorised placement verdicts for a block of TFS rows.

    A placement backend answers Alg 2's *is this combo placeable?* for every
    row; the full per-device script of the (single) winning row is then
    produced by the scalar oracle, which is exact by construction.
    """

    feasible: np.ndarray  # (B,) bool
    placed_tasks: np.ndarray  # (B,) int — tasks fully placed (== n_t iff feasible)
    n_splits: np.ndarray  # (B,) int — tasks that split across devices
    devices_used: np.ndarray  # (B,) int — 1 + highest device index holding a
    # placement (on heterogeneous fleets, skipped too-small devices in
    # between still count toward this span)

    @property
    def n_feasible(self) -> int:
        return int(self.feasible.sum())

    def first_feasible(self) -> int:
        """Row index of the first feasible row, or -1."""
        idx = np.flatnonzero(self.feasible)
        return int(idx[0]) if idx.size else -1


@dataclasses.dataclass(frozen=True)
class PlacementOptions:
    """Placement-model knobs shared by every backend.

    Defaults are PADPS-FR (carried split tasks re-pay a fresh II); the
    capture/store pair models the refs-[9]/[10] preemptive baseline
    (see :func:`repro_torch.core.placement.place_shares`).
    """

    t_capture: float = 0.0
    t_store: float = 0.0
    repay_init: bool = True
    # k-fault tolerance: > 0 adds the worst-case-survivor sweep (see the
    # module docstring's resilience contract).
    resilience: int = 0

    @property
    def resume_cost(self) -> float:
        return self.t_capture + self.t_store


def survivor_tables(
    t_slr: np.ndarray, t_cfg: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-device tables of the worst-case surviving fleet (k failures).

    The array-level twin of ``FleetSpec.survivors``: survivors keep their
    original relative order, so the survivor sweep is exactly a solo sweep
    on a smaller fleet.  Callers guard ``k < n_f`` (``prepare_block``'s
    early path answers ``k >= n_f``).
    """
    keep = worst_case_survivor_indices(t_slr, t_cfg, k)
    return t_slr[keep], t_cfg[keep]


def survivor_batch_tables(
    t_slr: np.ndarray,
    t_cfg: np.ndarray,
    n_f_eff: np.ndarray,
    k: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-instance survivor tables for the fleet-parallel batched sweep.

    For each instance the k worst-case failures are dropped from its live
    device prefix and the survivors left-packed into the same padded width;
    instances with ``n_f_eff <= k`` get ``n_f_eff_s == 0`` — the batched
    sweep's empty-fleet semantics (rows with live tasks infeasible,
    zero-task rows feasible), matching the scalar oracle's
    ``resilience >= n_f`` verdicts.
    """
    t_slr_s = np.zeros_like(t_slr)
    t_cfg_s = np.zeros_like(t_cfg)
    n_f_eff = np.asarray(n_f_eff)
    n_f_eff_s = np.maximum(n_f_eff - k, 0).astype(n_f_eff.dtype)
    for i in range(t_slr.shape[0]):
        nf = int(n_f_eff[i])
        if nf <= k:
            continue
        keep = worst_case_survivor_indices(t_slr[i, :nf], t_cfg[i, :nf], k)
        t_slr_s[i, : nf - k] = t_slr[i, keep]
        t_cfg_s[i, : nf - k] = t_cfg[i, keep]
    return t_slr_s, t_cfg_s, n_f_eff_s


@dataclasses.dataclass(frozen=True)
class InstanceBatch:
    """B independent scheduling instances' blocks, stacked and padded.

    The fleet-parallel unit of work (see the module docstring's batching
    contract).  Build one with :meth:`pack`; recover instance ``i``'s
    trimmed solo-call arguments with :meth:`instance_view`.  Padded
    regions hold zeros and are never read by a conforming backend.
    """

    shares: np.ndarray  # (B, R, n_t) float64 — rows padded to max r_i
    iis: np.ndarray  # (B, n_t) float64
    t_slr: np.ndarray  # (B, n_f) float64
    t_cfg: np.ndarray  # (B, n_f) float64
    n_t_eff: np.ndarray  # (B,) int32 — live task columns per instance
    n_f_eff: np.ndarray  # (B,) int32 — live device slots per instance
    n_rows: np.ndarray  # (B,) int32 — live rows per instance

    def __len__(self) -> int:
        return self.shares.shape[0]

    @classmethod
    def pack(
        cls,
        blocks: "list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]",
    ) -> "InstanceBatch":
        """Stack per-instance ``(shares, iis, t_slr, t_cfg)`` tuples.

        Instances may disagree on row count, task count and fleet size;
        everything is zero-padded up to the batch maxima and the effective
        counts record each instance's live extents.  An empty list packs
        to a valid zero-instance batch.
        """
        B = len(blocks)
        if B == 0:
            z = np.zeros((0, 0), dtype=np.float64)
            zi = np.zeros(0, dtype=np.int32)
            return cls(
                shares=np.zeros((0, 0, 0), dtype=np.float64),
                iis=z, t_slr=z, t_cfg=z,
                n_t_eff=zi, n_f_eff=zi, n_rows=zi,
            )
        canon = []
        for shares_i, iis_i, slr_i, cfg_i in blocks:
            shares_i = np.ascontiguousarray(shares_i, dtype=np.float64)
            if shares_i.ndim != 2:
                raise ValueError(
                    f"each shares block must be (r, n_t), got {shares_i.shape}"
                )
            iis_i = np.asarray(iis_i, dtype=np.float64).reshape(-1)
            slr_i = np.asarray(slr_i, dtype=np.float64).reshape(-1)
            cfg_i = np.asarray(cfg_i, dtype=np.float64).reshape(-1)
            if iis_i.shape[0] != shares_i.shape[1]:
                raise ValueError(
                    f"init_intervals length {iis_i.shape[0]} != n_t {shares_i.shape[1]}"
                )
            if slr_i.shape != cfg_i.shape:
                raise ValueError("t_slr/t_cfg must have matching shapes")
            canon.append((shares_i, iis_i, slr_i, cfg_i))
        r0, nt0 = canon[0][0].shape
        nf0 = canon[0][2].shape[0]
        if all(
            s.shape[0] == r0 and s.shape[1] == nt0 and sl.shape[0] == nf0
            for s, _, sl, _ in canon
        ):
            # Uniform batch (the lockstep walk's steady state: every live
            # instance on the same ramp step): one C-level stack per
            # field, no padding pass.
            return cls(
                shares=np.stack([s for s, _, _, _ in canon]),
                iis=np.stack([x for _, x, _, _ in canon]),
                t_slr=np.stack([x for _, _, x, _ in canon]),
                t_cfg=np.stack([x for _, _, _, x in canon]),
                n_t_eff=np.full(B, nt0, dtype=np.int32),
                n_f_eff=np.full(B, nf0, dtype=np.int32),
                n_rows=np.full(B, r0, dtype=np.int32),
            )
        R = max(s.shape[0] for s, _, _, _ in canon)
        n_t = max(s.shape[1] for s, _, _, _ in canon)
        n_f = max(sl.shape[0] for _, _, sl, _ in canon)
        shares = np.zeros((B, R, n_t), dtype=np.float64)
        iis = np.zeros((B, n_t), dtype=np.float64)
        t_slr = np.zeros((B, n_f), dtype=np.float64)
        t_cfg = np.zeros((B, n_f), dtype=np.float64)
        n_t_eff = np.zeros(B, dtype=np.int32)
        n_f_eff = np.zeros(B, dtype=np.int32)
        n_rows = np.zeros(B, dtype=np.int32)
        for i, (shares_i, iis_i, slr_i, cfg_i) in enumerate(canon):
            r_i, nt_i = shares_i.shape
            nf_i = slr_i.shape[0]
            shares[i, :r_i, :nt_i] = shares_i
            iis[i, :nt_i] = iis_i
            t_slr[i, :nf_i] = slr_i
            t_cfg[i, :nf_i] = cfg_i
            n_t_eff[i] = nt_i
            n_f_eff[i] = nf_i
            n_rows[i] = r_i
        return cls(
            shares=shares, iis=iis, t_slr=t_slr, t_cfg=t_cfg,
            n_t_eff=n_t_eff, n_f_eff=n_f_eff, n_rows=n_rows,
        )

    def instance_view(
        self, i: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Instance ``i``'s trimmed ``(shares, iis, t_slr, t_cfg)``.

        Exactly what a solo ``place_block`` call on the original
        (pre-padding) instance would receive.
        """
        r, nt, nf = int(self.n_rows[i]), int(self.n_t_eff[i]), int(self.n_f_eff[i])
        return (
            self.shares[i, :r, :nt],
            self.iis[i, :nt],
            self.t_slr[i, :nf],
            self.t_cfg[i, :nf],
        )


def place_instance_blocks(
    backend: "PlacementBackend",
    batch: InstanceBatch,
    opts: PlacementOptions | None = None,
) -> list[BatchPlacement]:
    """Loop-over-instances reference for the batched surface.

    Runs ``backend.place_block`` on each instance's trimmed view; every
    batched ``place_blocks`` implementation must match this bit-for-bit
    per instance.
    """
    return [
        backend.place_block(*batch.instance_view(i), opts) for i in range(len(batch))
    ]


def dispatch_instance_blocks(
    backend: "PlacementBackend",
    batch: InstanceBatch,
    opts: PlacementOptions | None = None,
    *,
    shard: int | str | None = None,
):
    """Batched dispatch: the backend's ``dispatch_blocks`` resolver.

    Every backend of this package spells out the full surface (lint rule
    B101), so there is no per-instance fallback to pick.  ``shard`` asks
    the backend to split the instance axis across that many devices;
    backends without a device mesh accept and ignore it, and verdicts must
    not depend on it.
    """
    return backend.dispatch_blocks(batch, opts, shard=shard)


def prepare_batch(
    batch: InstanceBatch, opts: PlacementOptions | None
) -> tuple[PlacementOptions, list[np.ndarray] | None, list[np.ndarray] | None]:
    """Canonicalise a batch for the fleet-parallel sweep (the raw surface).

    Returns ``(opts, f64, i32)``: ``f64`` holds the contiguous float64
    ``[shares, iis, t_slr, t_cfg]`` and, under ``resilience=k``, the
    survivor ``[t_slr_s, t_cfg_s]`` of :func:`survivor_batch_tables`;
    ``i32`` holds the int32 ``[n_t_eff, n_f_eff]`` and then ``n_f_eff_s``.
    Both are ``None`` when the sweep cannot take the batch — no instance,
    or padded width 0 — which the raw surface answers with ``None``.
    """
    if opts is None:
        opts = PlacementOptions()
    if len(batch) == 0 or batch.shares.shape[2] == 0 or batch.t_slr.shape[1] == 0:
        return opts, None, None
    f64 = [
        np.ascontiguousarray(a, dtype=np.float64)
        for a in (batch.shares, batch.iis, batch.t_slr, batch.t_cfg)
    ]
    i32 = [np.ascontiguousarray(a, dtype=np.int32) for a in (batch.n_t_eff, batch.n_f_eff)]
    if opts.resilience:
        slr_s, cfg_s, nfe_s = survivor_batch_tables(f64[2], f64[3], i32[1], opts.resilience)
        f64 += [slr_s, cfg_s]
        i32.append(nfe_s)
    return opts, f64, i32


def trim_raw_dispatch(
    backend: "PlacementBackend",
    batch: InstanceBatch,
    opts: PlacementOptions | None = None,
    *,
    shard: int | str | None = None,
):
    """``dispatch_blocks`` over the backend's raw surface: the resolver
    slices each instance's live rows out of the ``(B, R)`` verdicts.  A
    batch the raw surface answers ``None`` goes through
    :func:`place_instance_blocks`, whose ``prepare_block`` early paths
    answer each instance."""
    raw = backend.dispatch_blocks_raw(batch, opts, shard=shard)
    if raw is None:
        result = place_instance_blocks(backend, batch, opts)
        return lambda: result

    def resolve() -> list[BatchPlacement]:
        feasible, placed, n_splits, devices_used = raw()
        return [
            BatchPlacement(
                feasible=feasible[i, :r],
                placed_tasks=placed[i, :r].astype(np.int64),
                n_splits=n_splits[i, :r].astype(np.int64),
                devices_used=devices_used[i, :r].astype(np.int64),
            )
            for i, r in enumerate(batch.n_rows.tolist())
        ]

    return resolve


@runtime_checkable
class PlacementBackend(Protocol):
    """The pluggable Alg-2 block-placement engine contract."""

    name: str

    #: Whether ``dispatch_block`` / ``dispatch_blocks`` actually overlap
    #: device work with the caller (the CUDA engine enqueues, syncs later).  The
    #: walk only holds extra blocks in flight when this is True — an eager
    #: backend that merely *spells out* the dispatch surface must say
    #: ``False`` or the scheduler speculates blocks past the winner for
    #: nothing.  Pipelining is declared, not inferred from method presence.
    async_dispatch: bool

    def place_block(
        self,
        shares: np.ndarray,
        iis: np.ndarray,
        t_slr: np.ndarray,
        t_cfg: np.ndarray,
        opts: PlacementOptions | None = None,
    ) -> BatchPlacement:
        """Place every row of a ``(B, n_t)`` shares block on the fleet.

        Backends with asynchronous execution may also implement
        ``dispatch_block`` (same signature, returns a zero-arg resolver)
        — see the module docstring's handoff contract; the walk
        double-buffers through it when present.
        """
        ...

    @classmethod
    def available(cls) -> bool:
        """Whether this backend's dependencies are importable here."""
        return True


def prepare_block(
    shares,
    iis,
    t_slr,
    t_cfg,
    opts: PlacementOptions | None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, PlacementOptions, BatchPlacement | None]:
    """Canonicalise backend inputs and resolve degenerate blocks.

    Returns ``(shares, iis, t_slr, t_cfg, opts, early)`` with float64
    contiguous arrays; ``early`` is a ready :class:`BatchPlacement` for the
    trivial cases every backend must agree on:

    * ``n_t == 0`` — nothing to place, every row is feasible;
    * ``n_f == 0`` with ``n_t > 0`` — an empty fleet places nothing, every
      row is infeasible;
    * ``opts.resilience >= n_f`` with ``n_t > 0`` — losing every device
      cannot be survived, every row is infeasible.
    """
    shares = np.ascontiguousarray(shares, dtype=np.float64)
    if shares.ndim != 2:
        raise ValueError(f"shares must be (B, n_t), got shape {shares.shape}")
    B, n_t = shares.shape
    iis = np.asarray(iis, dtype=np.float64)
    if iis.shape != (n_t,):
        raise ValueError(f"init_intervals must have length {n_t}")
    t_slr = np.asarray(t_slr, dtype=np.float64).reshape(-1)
    t_cfg = np.asarray(t_cfg, dtype=np.float64).reshape(-1)
    if t_slr.shape != t_cfg.shape:
        raise ValueError(
            f"t_slr/t_cfg must have matching shapes, got {t_slr.shape} vs {t_cfg.shape}"
        )
    if opts is None:
        opts = PlacementOptions()
    n_f = t_slr.shape[0]
    early = None
    if n_t == 0:
        early = BatchPlacement(
            feasible=np.ones(B, dtype=bool),
            placed_tasks=np.zeros(B, dtype=np.int64),
            n_splits=np.zeros(B, dtype=np.int64),
            devices_used=np.zeros(B, dtype=np.int64),
        )
    elif n_f == 0 or opts.resilience >= n_f:
        early = BatchPlacement(
            feasible=np.zeros(B, dtype=bool),
            placed_tasks=np.zeros(B, dtype=np.int64),
            n_splits=np.zeros(B, dtype=np.int64),
            devices_used=np.zeros(B, dtype=np.int64),
        )
    return shares, iis, t_slr, t_cfg, opts, early


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_INSTANCES: dict[str, PlacementBackend] = {}

# Engines that need hardware register on first lookup instead of at package
# import, so the package imports on a host without a card.
_LAZY_BACKENDS: dict[str, str] = {
    "cuda": "repro_torch.core.placement_backends.cuda_backend",
}


def register_backend(name: str):
    """Class decorator: register a :class:`PlacementBackend` under ``name``.

    Re-registering an existing name replaces the backend everywhere: any
    cached instance of the previous class is dropped so the next
    :func:`get_backend` lookup constructs the new one.
    """

    def deco(cls):
        _REGISTRY[name] = cls
        _INSTANCES.pop(name, None)
        return cls

    return deco


def backend_names() -> list[str]:
    """All registered engine names (including not-currently-available ones)."""
    return sorted(set(_REGISTRY) | set(_LAZY_BACKENDS))


def _check_known(name: str) -> None:
    if name not in _REGISTRY and name not in _LAZY_BACKENDS:
        raise ValueError(
            f"unknown placement engine {name!r}; known engines: "
            f"{', '.join(backend_names())}"
        )


def _load(name: str) -> type:
    _check_known(name)
    if name not in _REGISTRY:
        importlib.import_module(_LAZY_BACKENDS[name])
    return _REGISTRY[name]


def available_backends() -> list[str]:
    """Engine names whose hardware is present in this process."""
    return [name for name in backend_names() if _load(name).available()]


def resolve_engine(engine: str) -> str:
    """Canonical engine name for ``engine``; raises on unknown names.

    There is no ``"auto"``: an engine runs where the caller asked, or
    raises — it never picks another device behind the caller's back.
    """
    _check_known(engine)
    return engine


def get_backend(engine: str) -> PlacementBackend:
    """Resolve ``engine`` to a (cached, stateless) backend instance.

    A registered engine whose hardware is missing raises ``RuntimeError``;
    the CUDA engine's message names ``engine="torch"`` for the CPU.
    """
    name = resolve_engine(engine)
    if name not in _INSTANCES:
        cls = _load(name)
        if not cls.available():
            hint = " — pass engine='torch' for the CPU" if name == "cuda" else ""
            raise RuntimeError(
                f"placement backend {name!r} is registered but not available "
                f"in this environment (no CUDA device?){hint}"
            )
        _INSTANCES[name] = cls()
    return _INSTANCES[name]
