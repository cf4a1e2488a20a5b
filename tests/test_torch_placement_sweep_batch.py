"""The port's fleet-parallel placement sweep against the JAX package's, exactly.

``repro_torch.kernels.placement_step.placement_sweep_batch_plain`` (the
plain torch version of the instance-axis CUDA kernel) must return the same
four ``(B, R)`` outputs as the references on the same float64 inputs: the
jnp oracles ``ref.placement_sweep_batch_ref`` and
``ref.placement_sweep_batch_resilient_ref``, the Pallas kernel
``placement_sweep_batch_pallas`` in interpret mode (all under
``jax.enable_x64``), and the numpy engine's per-instance ``place_blocks``.
Batches are uniform or ragged (mixed row counts including 1, task widths
and fleet sizes), packed by the reference's ``InstanceBatch.pack`` from
numpy-seeded blocks.  The tolerance is exact: every side runs the same
float64 operations in the same order.

The CUDA kernel itself is held against the plain version in
``test_torch_cuda_kernels.py``, which skips on a host without a card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.placement_backends import InstanceBatch as RefBatch  # noqa: E402
from repro.core.placement_backends import base as ref_base  # noqa: E402
from repro.core.placement_backends import get_backend as ref_get_backend  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.placement_step import placement_sweep_batch_pallas  # noqa: E402
from repro_torch.core.placement_backends import InstanceBatch, get_backend  # noqa: E402
from repro_torch.core.placement_backends import base as port_base  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.placement_step import (  # noqa: E402
    placement_sweep_batch_cuda,
    placement_sweep_batch_plain,
    placement_sweep_cuda,
)

OUTS = ("feasible", "placed_tasks", "n_splits", "devices_used")

CASES = [
    pytest.param(repay, resume, id=f"{'padpsfr' if repay else 'preemptive'}-resume{resume:g}")
    for repay in (True, False)
    for resume in (0.0, 9.5)
]

# (rows, n_t, n_f) per instance: uniform, and ragged with a 1-row instance,
# mixed task widths and fleet sizes (one fleet of 1 device, so that k = 1
# and k = 2 leave it no survivor).
SHAPES = {
    "uniform": [(33, 5, 4)] * 4,
    "ragged": [(1, 3, 2), (40, 6, 5), (17, 2, 1), (9, 5, 3), (64, 4, 4)],
}


def _block(rng, rows, n_t, n_f):
    """Rows spread around the fleet capacity: mixed feasible/infeasible."""
    t_slr = rng.uniform(30.0, 120.0, n_f)
    t_cfg = rng.uniform(0.0, 8.0, n_f)
    iis = rng.uniform(0.0, 6.0, n_t)
    shares = rng.uniform(0.5, 1.5, (rows, n_t)) * (
        rng.uniform(0.3, 1.3, (rows, 1)) * t_slr.sum() / n_t
    )
    return shares, iis, t_slr, t_cfg


def _batch(kind, seed=0):
    rng = np.random.default_rng(seed)
    return RefBatch.pack([_block(rng, *s) for s in SHAPES[kind]])


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _plain(batch, resume, repay_init, tables=None):
    slr, cfg, nfe = tables if tables is not None else (batch.t_slr, batch.t_cfg, batch.n_f_eff)
    out = placement_sweep_batch_plain(
        _t(batch.shares), _t(batch.iis), _t(slr), _t(cfg),
        _t(batch.n_t_eff, np.int32), _t(nfe, np.int32),
        resume_cost=resume, repay_init=repay_init,
    )
    return [o.numpy() for o in out]


def _assert_outs_equal(got, want):
    for g, w, name in zip(got, want, OUTS, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _j(a):
    return jnp.asarray(a, dtype=jnp.float64)


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_batch_plain_matches_jnp_batch_ref(kind, repay_init, resume):
    batch = _batch(kind, seed=1)
    got = _plain(batch, resume, repay_init)
    with jax.enable_x64(True):
        want = ref.placement_sweep_batch_ref(
            _j(batch.shares), _j(batch.iis), _j(batch.t_slr), _j(batch.t_cfg),
            jnp.asarray(batch.n_t_eff), jnp.asarray(batch.n_f_eff), jnp.float64(resume),
            repay_init=repay_init,
        )
        want = [np.asarray(o) for o in want]
    _assert_outs_equal(got, want)
    live = np.arange(batch.shares.shape[1]) < batch.n_rows[:, None]
    assert 0 < int(got[0][live].sum()) < int(live.sum())  # both verdicts occur


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_batch_plain_resilient_matches_jnp_ref(k, repay_init, resume):
    """resilience=k: the port's survivor tables equal the reference's, and
    primary AND survivor verdicts equal the fused jnp reference, including
    the instance whose fleet (n_f_eff = 1 <= k) leaves no survivor."""
    batch = _batch("ragged", seed=2 + k)
    surv = port_base.survivor_batch_tables(batch.t_slr, batch.t_cfg, batch.n_f_eff, k)
    want_surv = ref_base.survivor_batch_tables(batch.t_slr, batch.t_cfg, batch.n_f_eff, k)
    for a, b in zip(surv, want_surv, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (surv[2] == 0).any()
    got = _plain(batch, resume, repay_init)
    got[0] = got[0] & _plain(batch, resume, repay_init, tables=surv)[0]
    with jax.enable_x64(True):
        want = ref.placement_sweep_batch_resilient_ref(
            _j(batch.shares), _j(batch.iis), _j(batch.t_slr), _j(batch.t_cfg),
            jnp.asarray(batch.n_t_eff), jnp.asarray(batch.n_f_eff),
            _j(want_surv[0]), _j(want_surv[1]), jnp.asarray(want_surv[2]),
            jnp.float64(resume), repay_init=repay_init,
        )
        want = [np.asarray(o) for o in want]
    _assert_outs_equal(got, want)
    # An instance with no survivor: every row (all have live tasks) dies.
    for i in np.flatnonzero(surv[2] == 0):
        assert not got[0][i, : batch.n_rows[i]].any()


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_batch_plain_matches_pallas_interpret(kind, repay_init, resume):
    batch = _batch(kind, seed=5)
    with jax.enable_x64(True):
        want = placement_sweep_batch_pallas(
            _j(batch.shares), _j(batch.iis), _j(batch.t_slr), _j(batch.t_cfg),
            jnp.asarray(batch.n_t_eff), jnp.asarray(batch.n_f_eff),
            resume_cost=resume, repay_init=repay_init, block_rows=16, interpret=True,
        )
        want = [np.asarray(o) for o in want]
    _assert_outs_equal(_plain(batch, resume, repay_init), want)


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_batch_plain_matches_numpy_engine_per_instance(kind, repay_init, resume):
    """Each instance's live rows equal the numpy engine's solo sweep."""
    batch = _batch(kind, seed=9)
    got = _plain(batch, resume, repay_init)
    want = ref_get_backend("numpy").place_blocks(
        batch, ref_base.PlacementOptions(t_capture=resume, repay_init=repay_init)
    )
    for i, bp in enumerate(want):
        r = int(batch.n_rows[i])
        _assert_outs_equal([g[i, :r] for g in got], [getattr(bp, n) for n in OUTS])


def test_zero_task_and_empty_instances_in_a_batch():
    """n_t_eff == 0: every row feasible with zero counts; B == 0 and R == 0
    stacks give empty outputs."""
    rng = np.random.default_rng(4)
    shares, iis, slr, cfg = _block(rng, 6, 3, 2)
    batch = RefBatch.pack([(shares, iis, slr, cfg), (np.zeros((4, 0)), np.zeros(0), slr, cfg)])
    got = _plain(batch, 0.0, True)
    assert got[0][1, :4].all()
    assert not np.concatenate([g[1, :4] for g in got[1:]]).any()
    with jax.enable_x64(True):
        want = ref.placement_sweep_batch_ref(
            _j(batch.shares), _j(batch.iis), _j(batch.t_slr), _j(batch.t_cfg),
            jnp.asarray(batch.n_t_eff), jnp.asarray(batch.n_f_eff), jnp.float64(0.0),
        )
        _assert_outs_equal(got, [np.asarray(o) for o in want])
    for B, R in ((0, 5), (2, 0)):
        out = placement_sweep_batch_plain(
            torch.zeros((B, R, 3), dtype=torch.float64), torch.zeros((B, 3), dtype=torch.float64),
            torch.ones((B, 2), dtype=torch.float64), torch.zeros((B, 2), dtype=torch.float64),
            torch.full((B,), 3, dtype=torch.int32), torch.full((B,), 2, dtype=torch.int32),
        )
        assert [tuple(o.shape) for o in out] == [(B, R)] * 4
        assert [o.dtype for o in out] == [torch.bool, torch.int32, torch.int32, torch.int32]


def test_cpu_tensors_take_the_batch_plain_version_and_launch_nothing():
    batch = _batch("ragged")
    args = (_t(batch.shares), _t(batch.iis), _t(batch.t_slr), _t(batch.t_cfg),
            _t(batch.n_t_eff), _t(batch.n_f_eff))
    before = (placement_sweep_batch_cuda.launches, placement_sweep_cuda.launches)
    got = ops.placement_sweep_batch(*args, resume_cost=9.5, repay_init=False)
    assert (placement_sweep_batch_cuda.launches, placement_sweep_cuda.launches) == before
    want = placement_sweep_batch_plain(*args, resume_cost=9.5, repay_init=False)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_batch_wrappers_refuse_what_the_kernel_does_not_take():
    batch = _batch("uniform")
    args = [_t(batch.shares), _t(batch.iis), _t(batch.t_slr), _t(batch.t_cfg),
            _t(batch.n_t_eff), _t(batch.n_f_eff)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        placement_sweep_batch_cuda(*args)
    with pytest.raises(TypeError, match="float64"):
        ops.placement_sweep_batch(args[0].float(), *args[1:])
    with pytest.raises(TypeError, match="int32"):
        ops.placement_sweep_batch(*args[:4], args[4].long(), args[5])
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.placement_sweep_batch(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="padded width 0"):
        ops.placement_sweep_batch(args[0][..., :0], args[1][:, :0], *args[2:])
    with pytest.raises(ValueError, match=r"\(B, R, n_t\)"):
        ops.placement_sweep_batch(args[0][0], *args[1:])
    with pytest.raises(ValueError, match="tables must be"):
        ops.placement_sweep_batch(args[0], args[1][:1], *args[2:])
    bad = args[4].clone()
    bad[0] = batch.shares.shape[2] + 1
    with pytest.raises(ValueError, match="live counts"):
        placement_sweep_batch_plain(*args[:4], bad, args[5])


@pytest.mark.parametrize("k", [0, 1])
def test_torch_engine_raw_and_trimmed_surfaces_match_instance_loop(k):
    """The torch engine's raw (B, R) verdicts and its trimmed surface both
    equal place_instance_blocks (the solo loop) on every live row."""
    rng = np.random.default_rng(12)
    blocks = [_block(rng, r, t, f) for r, t, f in [(5, 2, 2), (1, 3, 3), (12, 1, 4), (7, 4, 2)]]
    batch = InstanceBatch.pack(blocks)
    opts = port_base.PlacementOptions(resilience=k)
    backend = get_backend("torch")
    want = port_base.place_instance_blocks(backend, batch, opts)
    feas, placed, n_splits, devices_used = backend.dispatch_blocks_raw(batch, opts)()
    assert feas.shape == (4, 12) and feas.dtype == bool
    for i, bp in enumerate(want):
        r = int(batch.n_rows[i])
        _assert_outs_equal(
            [feas[i, :r], placed[i, :r], n_splits[i, :r], devices_used[i, :r]],
            [getattr(bp, n) for n in OUTS],
        )
    for got in (backend.dispatch_blocks(batch, opts)(), backend.place_blocks(batch, opts)):
        assert len(got) == len(want)
        for g, w in zip(got, want, strict=True):
            for n in OUTS:
                a, b = getattr(g, n), getattr(w, n)
                assert a.dtype == b.dtype, n
                np.testing.assert_array_equal(a, b, err_msg=n)


def test_torch_engine_degenerate_batches_return_none():
    """Padded width 0 and empty batches: the raw surface answers None and
    the trimmed surface answers each instance like prepare_block."""
    backend = get_backend("torch")
    opts = port_base.PlacementOptions()
    zero_tasks = InstanceBatch.pack([(np.zeros((3, 0)), np.zeros(0), np.full(2, 30.0), np.ones(2))])
    assert backend.dispatch_blocks_raw(zero_tasks, opts) is None
    (bp,) = backend.dispatch_blocks(zero_tasks, opts)()
    assert bp.feasible.tolist() == [True] * 3
    zero_fleet = InstanceBatch.pack([(np.full((2, 2), 5.0), np.ones(2), np.zeros(0), np.zeros(0))])
    assert backend.dispatch_blocks_raw(zero_fleet, opts) is None
    (bp,) = backend.place_blocks(zero_fleet, opts)
    assert bp.feasible.tolist() == [False] * 2
    empty = InstanceBatch.pack([])
    assert backend.dispatch_blocks_raw(empty, opts) is None
    assert backend.dispatch_blocks(empty, opts)() == []
    assert get_backend("scalar").dispatch_blocks_raw(_batch_port("uniform"), opts) is None


def _batch_port(kind):
    rng = np.random.default_rng(0)
    return InstanceBatch.pack([_block(rng, *s) for s in SHAPES[kind]])


def test_prepare_batch_stages_survivors_and_counts():
    batch = _batch_port("ragged")
    opts, f64, i32 = port_base.prepare_batch(batch, port_base.PlacementOptions(resilience=1))
    assert opts.resilience == 1
    assert len(f64) == 6 and all(a.dtype == np.float64 and a.flags.c_contiguous for a in f64)
    assert len(i32) == 3 and all(a.dtype == np.int32 for a in i32)
    np.testing.assert_array_equal(i32[2], np.maximum(batch.n_f_eff - 1, 0))
    opts, f64, i32 = port_base.prepare_batch(batch, None)
    assert opts == port_base.PlacementOptions() and len(f64) == 4 and len(i32) == 2
