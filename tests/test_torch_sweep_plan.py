"""The placement sweeps' tile walk (``sweep_plan``), on the CPU.

``csrc/placement_sweep.cu`` and ``placement_sweep_batch.cu`` run only on
the card; both walk the flattened ``B * R`` rows of a stack in tiles sized
by the pure-Python ``sweep_plan``.  Here the plan is checked to assign
every (instance, row) of the stack to exactly one (block, tile, thread),
to keep shared memory within ``_build.MAX_SMEM``, to take the wide path
when and only when one buffer of 32 rows does not fit, and to keep the
staged rows' layout what the kernel assumes (16-byte copies aligned, odd
strides free of bank conflicts).  A plain-torch emulation of the tiling
(rows gathered tile by tile into the staged stride, instance tables looked
up by ``row // R`` among the tile's staged instances) is held bit for bit
against ``placement_sweep_batch_plain`` / ``placement_sweep_plain`` and the
JAX package's ``ref.placement_sweep_batch_ref`` under ``jax.enable_x64``,
on the five option variants.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.placement_backends import (  # noqa: E402
    InstanceBatch,
    survivor_batch_tables,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.placement_step import (  # noqa: E402
    _staged,
    placement_sweep_batch_plain,
    placement_sweep_plain,
    staged_warps,
    sweep_plan,
)

SMS = 132  # the H100 SXM's SMs
OUTS = ("feasible", "placed", "n_splits", "devices_used")

# chip_smoke.py's ragged stack: (rows, n_t, n_f) per instance.
RAGGED_STACK = ((1, 3, 2), (700, 6, 5), (17, 2, 1), (4096, 7, 3), (64, 4, 4),
                (1025, 7, 4), (5, 1, 1))

# (B, R, n_t, n_f) of the plan cases: the reference kernel tests' blocks
# (tests/test_kernels.py: 257 x 6 x 5, 123 x 6 x 5), the ragged stack's
# padded shape, 64 instances at R = 1, 16 and 4096 (n_t 7, n_f 4), the
# single-instance sweep at 10^6 x 8, the deep instance's ramp (10 tasks, 6
# devices), and wide rows (n_t 7000).
PLAN_CASES = [
    (1, 257, 6, 5), (1, 123, 6, 5), (7, 4096, 7, 5),
    (64, 1, 7, 4), (64, 16, 7, 4), (64, 4096, 7, 4), (1, 1_000_000, 8, 8),
    (1, 64, 10, 6), (1, 512, 10, 6), (1, 4096, 10, 6), (1, 32768, 10, 6),
    (1, 65536, 10, 6), (1, 300, 7000, 4), (2, 40, 7000, 3), (3, 100, 200, 4),
    (1, 1, 1, 1), (1, 7, 4, 3), (64, 16, 8, 4), (5, 33, 10, 2),
]


def _ids(case):
    return "x".join(str(v) for v in case)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", PLAN_CASES, ids=_ids)
def test_plan_takes_every_row_once(case, aligned):
    B, R, n_t, n_f = case
    plan = sweep_plan(B, R, n_t, n_f, sm_count=SMS, aligned=aligned)
    n = B * R
    seen = np.zeros(n, dtype=np.int64)
    tiles_seen = np.zeros(plan.tiles, dtype=np.int64)
    for block in range(plan.grid):
        for warp in range(plan.warps):
            for t in plan.warp_tiles(block, warp):
                tiles_seen[t] += 1
                rows = plan.tile_rows(t)
                # Lane i of the tile's warp takes row 32 t + i.
                assert rows.start == 32 * t and len(rows) <= 32
                seen[rows.start:rows.stop] += 1
                assert len(plan.tile_instances(t)) <= plan.span
    assert (tiles_seen == 1).all()
    assert (seen == 1).all()
    # One tile a warp: no warp idle, none walking two tiles.
    assert plan.grid == -(-plan.tiles // plan.warps) and 1 <= plan.warps <= 8
    assert plan.threads == 32 * plan.warps <= 256
    assert plan.smem <= _build.MAX_SMEM
    span, doubles = _staged(B, R, n_t, n_f, plan.stride if not plan.direct else 1)
    assert plan.span == span
    assert plan.smem == 8 * plan.warps * plan.buffer_doubles
    if not plan.direct:
        # Staged when a warp's tile fits and the card holds every warp at once.
        assert plan.buffer_doubles == doubles and 8 * doubles <= _build.MAX_SMEM
        assert plan.tiles <= staged_warps(plan, SMS)
    else:
        # Direct: rows and tables read from device memory, where a tile
        # does not fit or the card cannot hold every staged warp at once.
        assert (plan.stride, plan.buffer_doubles) == (0, 0)
        stride = (n_t if n_t % 4 == 2 else n_t + 2) if plan.vec == 16 else n_t | 1
        doubles = _staged(B, R, n_t, n_f, stride)[1]
        warps = min(8, -(-plan.tiles // SMS), max(1, _build.MAX_SMEM // (8 * doubles)))
        as_staged = dataclasses.replace(plan, warps=warps, stride=stride, direct=False,
                                        buffer_doubles=doubles)
        assert 8 * doubles > _build.MAX_SMEM or plan.tiles > staged_warps(as_staged, SMS)
    assert len(plan.args()) == 8 and plan.args()[-1] == plan.smem


def test_plan_paths_at_the_main_path_shapes():
    """The deep ramp's blocks and the fleet-parallel rounds up to 64 x 512
    stage; the 10^6-row sweep, the full round and wide rows go direct."""
    for case in [(1, 64, 10, 6), (1, 512, 10, 6), (1, 4096, 10, 6), (1, 32768, 10, 6),
                 (1, 65536, 10, 6), (64, 16, 7, 4), (64, 64, 7, 4), (64, 512, 7, 4)]:
        assert sweep_plan(*case, sm_count=SMS).path == "staged", case
    for case in [(1, 1_000_000, 8, 8), (64, 4096, 7, 4), (1, 300, 7000, 4)]:
        assert sweep_plan(*case, sm_count=SMS).path == "direct", case
    # A small launch spreads one warp an SM; a large one packs 8 a block.
    assert sweep_plan(64, 16, 7, 4, sm_count=SMS).warps == 1
    assert sweep_plan(1, 65536, 10, 6, sm_count=SMS).warps == 8


@pytest.mark.parametrize("n_t", [4, 7, 8, 10])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_staged_layout_copies_and_banks(n_t, aligned):
    """16-byte copies only from a 16-byte aligned start with n_t even, into
    an even stride (each copy lands 16-byte aligned); 8-byte copies into an
    odd stride, where a half-warp's 64-bit reads at one task index fall on
    16 distinct bank pairs."""
    plan = sweep_plan(64, 16, n_t, 4, sm_count=SMS, aligned=aligned)  # a staged round
    assert plan.path == "staged" and plan.stride >= n_t
    if plan.vec == 16:
        assert aligned and n_t % 2 == 0 and plan.stride % 2 == 0
        assert plan.buffer_doubles % 2 == 0
        for r in range(32):
            for k in range(0, n_t, 2):
                assert (r * plan.stride + k) % 2 == 0
    else:
        assert not (aligned and n_t % 2 == 0)
        assert plan.stride % 2 == 1
        for k in range(n_t):
            for half in range(0, 32, 16):
                pairs = {(r * plan.stride + k) % 16 for r in range(half, half + 16)}
                assert len(pairs) == 16


def test_lane_instance_index_below_a_tile_of_rows_is_exact():
    """Kernel 2 finds a lane's instance among its tile's as (into + lane) //
    R; below R = 32 it truncates the correctly rounded float32 quotient
    (x + 0.5) / R, x = into + lane < R + 31.  Exact for every such x."""
    for R in range(1, 32):
        x = np.arange(R + 31, dtype=np.float32)
        q = np.floor((x + np.float32(0.5)) / np.float32(R)).astype(np.int64)
        np.testing.assert_array_equal(q, np.arange(R + 31) // R)


def test_plan_refuses_empty_sizes():
    with pytest.raises(ValueError, match="B, R, n_t, n_f"):
        sweep_plan(0, 4, 3, 2, sm_count=SMS)
    with pytest.raises(ValueError, match="B, R, n_t, n_f"):
        sweep_plan(1, 4, 3, 2, sm_count=0)


# ---------------------------------------------------------------------------
# the tiling's emulation against the plain version and the JAX package
# ---------------------------------------------------------------------------


def emulate(plan, shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, *, resume_cost, repay_init):
    """The kernels' tile walk in plain torch: warp by warp, each tile's rows
    gathered from the flattened stack into a 32-row buffer at the plan's
    stride, the tables of the instances it spans staged beside them, each
    row's tables looked up by ``row // R`` among those (the direct path:
    rows and tables straight from the stack); then the row loop (the plain
    version's) over the gathered rows, each taken as an instance of one
    row."""
    B, R, n_t = shares.shape
    flat = shares.reshape(B * R, n_t)
    rows, gathered = [], []
    for block in range(plan.grid):
        for warp in range(plan.warps):
            for t in plan.warp_tiles(block, warp):
                idx = torch.arange(plan.tile_rows(t).start, plan.tile_rows(t).stop)
                if plan.direct:  # each lane reads its row and tables from device memory
                    gathered.append((flat[idx], *(a[idx // R] for a in (
                        iis, t_slr, t_cfg, n_t_eff, n_f_eff))))
                else:
                    buf = torch.zeros(32, plan.stride, dtype=torch.float64)
                    buf[: len(idx), :n_t] = flat[idx]
                    first = plan.tile_instances(t).start
                    staged = [a[first:first + plan.span] for a in (iis, t_slr, t_cfg, n_t_eff,
                                                                   n_f_eff)]
                    lb = idx // R - first
                    gathered.append((buf[: len(idx), :n_t], *(a[lb] for a in staged)))
                rows.append(idx)
    cols = [torch.cat(c) for c in zip(*gathered, strict=True)]
    got = placement_sweep_batch_plain(cols[0][:, None, :].contiguous(), *cols[1:],
                                      resume_cost=resume_cost, repay_init=repay_init)
    order = torch.cat(rows)
    outs = []
    for g in got:
        o = torch.empty(B * R, dtype=g.dtype)
        o[order] = g[:, 0]
        outs.append(o.view(B, R))
    return tuple(outs)


VARIANTS = [
    pytest.param(True, 0.0, False, id="padpsfr"),
    pytest.param(True, 9.5, False, id="padpsfr-resume9.5"),
    pytest.param(False, 0.0, False, id="preemptive-resume0"),
    pytest.param(False, 9.5, False, id="preemptive-resume9.5"),
    pytest.param(True, 0.0, True, id="survivors-k1"),
]


def _modes(plan):
    """``plan`` on both of the kernels' paths where the staged one fits."""
    doubles = _staged(plan.B, plan.R, plan.n_t, plan.n_f, plan.n_t | 1)[1]
    modes = [dataclasses.replace(plan, direct=True, stride=0, buffer_doubles=0)]
    if 8 * doubles <= _build.MAX_SMEM:
        modes.append(dataclasses.replace(plan, direct=False, stride=plan.n_t | 1, vec=8,
                                         buffer_doubles=doubles))
    return modes


def _block(rng, rows, n_t, n_f):
    """Rows spread around the fleet capacity: mixed feasible/infeasible
    (reconfiguration and initialization costs scaled down past 8 tasks, so
    wide rows can fit too)."""
    small = min(1.0, 8.0 / n_t)
    t_slr = rng.uniform(30.0, 120.0, n_f)
    t_cfg = rng.uniform(0.0, 8.0, n_f) * small
    iis = rng.uniform(0.0, 6.0, n_t) * small
    shares = rng.uniform(0.5, 1.5, (rows, n_t)) * (
        rng.uniform(0.3, 1.3, (rows, 1)) * t_slr.sum() / n_t
    )
    return shares, iis, t_slr, t_cfg


# (rows, n_t, n_f) per instance of the emulated stacks: the reference's
# kernel-test block (one instance), the ragged stack, 64 instances of mixed
# widths at R = 1 and at R = 16 (several instances a warp), a stack whose
# B * R is no multiple of a tile, and wide rows (n_t 1000).
def _mixed(rows, count, seed):
    rng = np.random.default_rng(seed)
    return [(rows, int(rng.integers(1, 8)), int(rng.integers(1, 5))) for _ in range(count)]


STACKS = {
    "reference-257x6x5": [(257, 6, 5)],
    "ragged": list(RAGGED_STACK),
    "64xR1-mixed": _mixed(1, 64, 11),
    "64xR16-mixed": _mixed(16, 64, 12),
    "ragged-tail-5x33": _mixed(33, 5, 13),
    "wide-2x40x1000": [(40, 1000, 3), (33, 995, 2)],
}


def _stack(kind, survivors, seed=0):
    rng = np.random.default_rng(seed)
    batch = InstanceBatch.pack([_block(rng, *s) for s in STACKS[kind]])
    slr, cfg, nfe = batch.t_slr, batch.t_cfg, batch.n_f_eff
    if survivors:
        slr, cfg, nfe = survivor_batch_tables(slr, cfg, nfe, 1)
    f64 = [np.ascontiguousarray(a, dtype=np.float64) for a in (batch.shares, batch.iis, slr,
                                                               cfg)]
    i32 = [np.ascontiguousarray(a, dtype=np.int32) for a in (batch.n_t_eff, nfe)]
    return f64 + i32


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("repay_init,resume,survivors", VARIANTS)
@pytest.mark.parametrize("kind", list(STACKS))
def test_emulated_tiling_matches_plain_and_jax_reference(kind, repay_init, resume, survivors,
                                                         aligned):
    arrays = _stack(kind, survivors, seed=len(kind))
    args = [torch.from_numpy(a) for a in arrays]
    B, R, n_t = args[0].shape
    plan = sweep_plan(B, R, n_t, args[2].shape[1], sm_count=SMS, aligned=aligned)
    assert plan.direct == kind.startswith("wide")
    kw = dict(resume_cost=resume, repay_init=repay_init)
    want = placement_sweep_batch_plain(*args, **kw)
    with jax.enable_x64(True):
        jwant = jref.placement_sweep_batch_ref(
            *(jnp.asarray(a) for a in arrays), jnp.float64(resume), repay_init=repay_init,
        )
        jwant = [np.asarray(o) for o in jwant]
    for mode in _modes(plan):  # the plan's path, and the kernels' others
        got = emulate(mode, *args, **kw)
        for g, w, name in zip(got, want, OUTS, strict=True):
            assert torch.equal(g, w), (mode.path, name)
        for g, w, name in zip(got, jwant, OUTS, strict=True):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if B == 1 and (int(args[4][0]), int(args[5][0])) == (n_t, args[2].shape[1]):
        # kernel 1: the single-instance sweep is the walk over one instance
        single = placement_sweep_plain(args[0][0], args[1][0], args[2][0], args[3][0], **kw)
        for g, w, name in zip(got, single, OUTS, strict=True):
            assert torch.equal(g[0], w), name
    feas = got[0].numpy()
    assert 0 < int(feas.sum()) < feas.size  # both verdicts occur
