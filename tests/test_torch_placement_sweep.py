"""The port's Alg-2 placement sweep against the JAX package's, exactly.

``repro_torch.kernels.placement_step.placement_sweep_plain`` (the plain
torch version of the CUDA kernel) must return the same four outputs as
three references on the same float64 inputs: the jnp oracle
``ref.placement_sweep_ref``, the Pallas kernel run in interpret mode
(both under ``jax.enable_x64``), and the numpy engine's ``_sweep``.  The
tolerance is exact: all four run the same float64 operations in the same
order.  Inputs are made with numpy from a seed and handed to each side.

The CUDA kernel itself is held against the plain version in
``test_torch_cuda_kernels.py``, which skips on a host without a card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.placement_backends import base as ref_base  # noqa: E402
from repro.core.placement_backends.numpy_backend import _sweep  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.placement_step import placement_sweep_pallas  # noqa: E402
from repro_torch.core.placement_backends import base as port_base  # noqa: E402
from repro_torch.core.placement_backends import get_backend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.placement_step import (  # noqa: E402
    placement_sweep_cuda,
    placement_sweep_plain,
)

OUTS = ("feasible", "placed_tasks", "n_splits", "devices_used")


def _placement_block(B=257, n_t=6, n_f=5, seed=0):
    """Rows spread around the fleet capacity: mixed feasible/infeasible."""
    rng = np.random.default_rng(seed)
    t_slr = rng.uniform(30.0, 120.0, n_f)
    t_cfg = rng.uniform(0.0, 8.0, n_f)
    iis = rng.uniform(0.0, 6.0, n_t)
    shares = rng.uniform(0.5, 1.5, (B, n_t)) * (
        rng.uniform(0.3, 1.3, (B, 1)) * t_slr.sum() / n_t
    )
    return shares, iis, t_slr, t_cfg


def _plain(shares, iis, t_slr, t_cfg, resume, repay_init):
    out = placement_sweep_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (shares, iis, t_slr, t_cfg)),
        resume_cost=resume, repay_init=repay_init,
    )
    return [o.numpy() for o in out]


def _assert_outs_equal(got, want):
    for g, w, name in zip(got, want, OUTS, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _jax_ref(shares, iis, t_slr, t_cfg, resume, repay_init):
    with jax.enable_x64(True):
        out = ref.placement_sweep_ref(
            jnp.asarray(shares, dtype=jnp.float64), jnp.asarray(iis, dtype=jnp.float64),
            jnp.asarray(t_slr, dtype=jnp.float64), jnp.asarray(t_cfg, dtype=jnp.float64),
            jnp.float64(resume), repay_init=repay_init,
        )
        return [np.asarray(o) for o in out]


CASES = [
    pytest.param(repay, resume, id=f"{'padpsfr' if repay else 'preemptive'}-resume{resume:g}")
    for repay in (True, False)
    for resume in (0.0, 9.5)
]


@pytest.mark.parametrize("B", [1, 257, 4096])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_plain_matches_jnp_ref_and_numpy_sweep(B, repay_init, resume):
    shares, iis, t_slr, t_cfg = _placement_block(B=B, seed=B)
    got = _plain(shares, iis, t_slr, t_cfg, resume, repay_init)
    want = _jax_ref(shares, iis, t_slr, t_cfg, resume, repay_init)
    _assert_outs_equal(got, want)
    _assert_outs_equal(got, _sweep(shares, iis, t_slr, t_cfg, resume, repay_init))
    if B > 1:  # the block exercises both verdicts
        assert 0 < int(got[0].sum()) < B


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_plain_matches_pallas_interpret(B, repay_init, resume):
    shares, iis, t_slr, t_cfg = _placement_block(B=B, seed=7 + B)
    with jax.enable_x64(True):
        want = placement_sweep_pallas(
            jnp.asarray(shares, dtype=jnp.float64), jnp.asarray(iis, dtype=jnp.float64),
            jnp.asarray(t_slr, dtype=jnp.float64), jnp.asarray(t_cfg, dtype=jnp.float64),
            resume_cost=resume, repay_init=repay_init, block_rows=64, interpret=True,
        )
        want = [np.asarray(o) for o in want]
    _assert_outs_equal(_plain(shares, iis, t_slr, t_cfg, resume, repay_init), want)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_resilient_sweep_matches_ref(k, repay_init, resume):
    """resilience=k: primary AND worst-case-survivor verdicts, with the
    survivor tables the port picks equal to the reference's."""
    shares, iis, t_slr, t_cfg = _placement_block(B=257, seed=11 + k)
    slr_s, cfg_s = port_base.survivor_tables(t_slr, t_cfg, k)
    want_slr, want_cfg = ref_base.survivor_tables(t_slr, t_cfg, k)
    np.testing.assert_array_equal(slr_s, want_slr)
    np.testing.assert_array_equal(cfg_s, want_cfg)
    got = _plain(shares, iis, t_slr, t_cfg, resume, repay_init)
    got[0] = got[0] & _plain(shares, iis, slr_s, cfg_s, resume, repay_init)[0]
    with jax.enable_x64(True):
        want = ref.placement_sweep_resilient_ref(
            *(jnp.asarray(a, dtype=jnp.float64)
              for a in (shares, iis, t_slr, t_cfg, want_slr, want_cfg)),
            jnp.float64(resume), repay_init=repay_init,
        )
        want = [np.asarray(o) for o in want]
    _assert_outs_equal(got, want)
    # The torch engine runs the same two passes behind the backend contract.
    opts = port_base.PlacementOptions(
        t_capture=resume, repay_init=repay_init, resilience=k
    )
    bp = get_backend("torch").place_block(shares, iis, t_slr, t_cfg, opts)
    _assert_outs_equal([bp.feasible, bp.placed_tasks, bp.n_splits, bp.devices_used], want)


def test_torch_engine_degenerate_blocks_match_reference():
    """n_t == 0, n_f == 0, k >= n_f and B == 0 blocks: the prepare_block
    early paths answer exactly as the reference's."""
    from repro.core.placement_backends import get_backend as ref_get_backend

    cases = [
        (np.zeros((3, 0)), np.zeros(0), np.full(2, 30.0), np.ones(2), 0),
        (np.full((3, 2), 5.0), np.ones(2), np.zeros(0), np.zeros(0), 0),
        (np.full((3, 2), 5.0), np.ones(2), np.full(2, 30.0), np.ones(2), 2),
        (np.zeros((0, 2)), np.ones(2), np.full(2, 30.0), np.ones(2), 0),
    ]
    for shares, iis, slr, cfg, k in cases:
        got = get_backend("torch").place_block(
            shares, iis, slr, cfg, port_base.PlacementOptions(resilience=k)
        )
        want = ref_get_backend("numpy").place_block(
            shares, iis, slr, cfg, ref_base.PlacementOptions(resilience=k)
        )
        for name in OUTS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    shares, iis, t_slr, t_cfg = (torch.from_numpy(a) for a in _placement_block(B=33))
    before = placement_sweep_cuda.launches
    got = ops.placement_sweep(shares, iis, t_slr, t_cfg)
    assert placement_sweep_cuda.launches == before
    for g, w in zip(got, placement_sweep_plain(shares, iis, t_slr, t_cfg), strict=True):
        assert torch.equal(g, w)
    assert [g.dtype for g in got] == [torch.bool, torch.int32, torch.int32, torch.int32]


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    shares, iis, t_slr, t_cfg = (torch.from_numpy(a) for a in _placement_block(B=8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        placement_sweep_cuda(shares, iis, t_slr, t_cfg)
    with pytest.raises(TypeError, match="float64"):
        ops.placement_sweep(shares.float(), iis, t_slr, t_cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.placement_sweep(shares.to("meta"), iis, t_slr, t_cfg)
    with pytest.raises(ValueError, match="prepare_block"):
        ops.placement_sweep(shares[:, :0], iis[:0], t_slr, t_cfg)


def test_cuda_engine_raises_without_a_card(monkeypatch):
    """No silent fallback: with no CUDA device the default engine raises,
    and the message points at engine='torch'."""
    from repro.configs.paper_examples import example1_fleet

    from repro_torch.convert import fleet_from
    from repro_torch.core import PADPSFRScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_base, "_INSTANCES", {})
    with pytest.raises(RuntimeError, match="engine='torch'"):
        PADPSFRScheduler(fleet_from(example1_fleet()))
    with pytest.raises(RuntimeError, match="engine='torch'"):
        get_backend("cuda")
    with pytest.raises(ValueError, match="unknown placement engine"):
        PADPSFRScheduler(fleet_from(example1_fleet()), engine="auto")


@pytest.mark.parametrize("engine", ["torch", "scalar"])
def test_batched_surface_matches_reference_loop(engine):
    """InstanceBatch packing (ragged rows, tasks, fleets) and the batched
    surface: each instance equals the reference's per-instance loop."""
    from repro.core.placement_backends import InstanceBatch as RefBatch
    from repro.core.placement_backends import get_backend as ref_get_backend

    from repro_torch.core.placement_backends import InstanceBatch, dispatch_instance_blocks

    blocks = [_placement_block(B=b, n_t=t, n_f=f, seed=b) for b, t, f in
              [(9, 3, 2), (17, 6, 5), (1, 2, 4), (40, 4, 3)]]
    opts = port_base.PlacementOptions(resilience=1)
    want = ref_get_backend("numpy").place_blocks(
        RefBatch.pack(blocks), ref_base.PlacementOptions(resilience=1)
    )
    batch = InstanceBatch.pack(blocks)
    backend = get_backend(engine)
    for got in (backend.place_blocks(batch, opts), dispatch_instance_blocks(backend, batch, opts)()):
        assert len(got) == len(want)
        for g, w in zip(got, want, strict=True):
            _assert_outs_equal([getattr(g, n) for n in OUTS], [getattr(w, n) for n in OUTS])
    # The torch engine sweeps the whole stack at once (the raw surface the
    # trimmed one slices); the scalar oracle has no batched sweep.
    raw = backend.dispatch_blocks_raw(batch, opts)
    if engine == "scalar":
        assert raw is None
    else:
        feasible = raw()[0]
        for i, w in enumerate(want):
            np.testing.assert_array_equal(feasible[i, : batch.n_rows[i]], w.feasible)
