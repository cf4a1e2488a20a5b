"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX, so it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_cuda_kernels.py

The outputs are compared exactly: kernel and plain version run the same
float64 operations in the same order.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.placement_backends import (  # noqa: E402
    InstanceBatch,
    survivor_batch_tables,
    survivor_tables,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.placement_step import (  # noqa: E402
    placement_sweep_batch_cuda,
    placement_sweep_batch_plain,
    placement_sweep_cuda,
    placement_sweep_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _block(B, n_t, n_f, seed, device):
    """Rows spread around the fleet capacity: mixed feasible/infeasible."""
    rng = np.random.default_rng(seed)
    t_slr = rng.uniform(30.0, 120.0, n_f)
    t_cfg = rng.uniform(0.0, 8.0, n_f)
    iis = rng.uniform(0.0, 6.0, n_t)
    shares = rng.uniform(0.5, 1.5, (B, n_t)) * (
        rng.uniform(0.3, 1.3, (B, 1)) * t_slr.sum() / n_t
    )
    return tuple(
        torch.tensor(a, dtype=torch.float64, device=device) for a in (shares, iis, t_slr, t_cfg)
    )


CASES = [
    pytest.param(repay, resume, id=f"{'padpsfr' if repay else 'preemptive'}-resume{resume:g}")
    for repay in (True, False)
    for resume in (0.0, 9.5)
]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("B", [1, 7, 1025, 65536])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_placement_sweep_kernel_matches_plain(cuda_device, B, repay_init, resume):
    shares, iis, t_slr, t_cfg = _block(B, 6, 5, B, cuda_device)
    kw = dict(resume_cost=resume, repay_init=repay_init)
    before = placement_sweep_cuda.launches
    got = ops.placement_sweep(shares, iis, t_slr, t_cfg, **kw)  # CUDA tensors: the kernel
    want = placement_sweep_plain(shares, iis, t_slr, t_cfg, **kw)
    torch.cuda.synchronize()
    assert placement_sweep_cuda.launches == before + 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n_t,n_f", [(1, 1), (3, 40), (40, 3), (7000, 4)])
def test_placement_sweep_kernel_shapes_and_survivors(cuda_device, n_t, n_f):
    """Odd widths: tables longer than a block's threads, and (n_t = 7000)
    tables past 48 KB of shared memory; plus the survivor tables of
    resilience=1."""
    shares, iis, t_slr, t_cfg = _block(300, n_t, n_f, n_t * 100 + n_f, cuda_device)
    tables = [(t_slr, t_cfg)]
    if n_f > 1:
        slr_s, cfg_s = survivor_tables(t_slr.cpu().numpy(), t_cfg.cpu().numpy(), 1)
        tables.append(tuple(torch.tensor(a, device=cuda_device) for a in (slr_s, cfg_s)))
    for slr, cfg in tables:
        got = placement_sweep_cuda(shares, iis, slr, cfg)
        want = placement_sweep_plain(shares, iis, slr, cfg)
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


@pytest.mark.needs_cuda
def test_placement_sweep_kernel_empty_block_launches_nothing(cuda_device):
    shares, iis, t_slr, t_cfg = _block(4, 3, 2, 0, cuda_device)
    before = placement_sweep_cuda.launches
    out = placement_sweep_cuda(shares[:0], iis, t_slr, t_cfg)
    assert placement_sweep_cuda.launches == before
    assert [o.shape[0] for o in out] == [0, 0, 0, 0]


@pytest.mark.needs_cuda
def test_cuda_engine_schedules_example1(cuda_device):
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler

    tasks, fleet = example1_tasks(), example1_fleet()
    before = placement_sweep_cuda.launches
    got = PADPSFRScheduler(fleet).schedule(tasks, count_all_rejects=True)
    want = PADPSFRScheduler(fleet, engine="torch").schedule(tasks, count_all_rejects=True)
    assert placement_sweep_cuda.launches > before
    assert (got.chosen_rank, got.n_placement_rejects, got.total_power) == (4, 146, 31.5)
    assert (got.combo, got.chosen_rank, got.n_placement_rejects) == (
        want.combo, want.chosen_rank, want.n_placement_rejects
    )


# (rows, n_t, n_f) per instance: uniform, and ragged with a 1-row instance,
# mixed widths and a 1-device fleet (no survivor under resilience=1).
STACKS = {
    "uniform": [(1000, 7, 4)] * 8,
    "ragged": [(1, 3, 2), (700, 6, 5), (17, 2, 1), (257, 7, 3), (64, 4, 4)],
}


def _stack(kind, seed, device):
    rng = np.random.default_rng(seed)
    blocks = []
    for rows, n_t, n_f in STACKS[kind]:
        t_slr = rng.uniform(30.0, 120.0, n_f)
        blocks.append((
            rng.uniform(0.5, 1.5, (rows, n_t)) * (rng.uniform(0.3, 1.3, (rows, 1)) * t_slr.sum() / n_t),
            rng.uniform(0.0, 6.0, n_t), t_slr, rng.uniform(0.0, 8.0, n_f),
        ))
    batch = InstanceBatch.pack(blocks)
    slr_s, cfg_s, nfe_s = survivor_batch_tables(batch.t_slr, batch.t_cfg, batch.n_f_eff, 1)

    def on(a, dtype=torch.float64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    main = (on(batch.shares), on(batch.iis), on(batch.t_slr), on(batch.t_cfg),
            on(batch.n_t_eff, torch.int32), on(batch.n_f_eff, torch.int32))
    surv = (*main[:2], on(slr_s), on(cfg_s), main[4], on(nfe_s, torch.int32))
    return main, surv


@pytest.mark.needs_cuda
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
@pytest.mark.parametrize("repay_init,resume", CASES)
def test_placement_sweep_batch_kernel_matches_plain(cuda_device, kind, repay_init, resume):
    """Kernel 2 == its plain version over the whole (B, R) output, padded
    rows included, on the primary and the survivor tables."""
    kw = dict(resume_cost=resume, repay_init=repay_init)
    for args in _stack(kind, len(kind), cuda_device):
        before = placement_sweep_batch_cuda.launches
        got = ops.placement_sweep_batch(*args, **kw)  # CUDA tensors: the kernel
        want = placement_sweep_batch_plain(*args, **kw)
        torch.cuda.synchronize()
        assert placement_sweep_batch_cuda.launches == before + 1
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


@pytest.mark.needs_cuda
def test_placement_sweep_batch_kernel_wide_tables_and_empty_stacks(cuda_device):
    """Tables past 48 KB of shared memory (n_t = 7000), and B * R == 0
    stacks, which return empty outputs and launch nothing."""
    rng = np.random.default_rng(5)
    n_t, n_f = 7000, 3
    t_slr = rng.uniform(1e4, 2e4, (2, n_f))
    args = tuple(torch.tensor(a, device=cuda_device) for a in (
        rng.uniform(0.5, 3.0, (2, 40, n_t)), rng.uniform(0.0, 1.0, (2, n_t)), t_slr,
        rng.uniform(0.0, 8.0, (2, n_f)),
    )) + tuple(torch.tensor(a, dtype=torch.int32, device=cuda_device)
               for a in ([n_t, n_t - 5], [n_f, n_f - 1]))
    got = placement_sweep_batch_cuda(*args)
    want = placement_sweep_batch_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    before = placement_sweep_batch_cuda.launches
    for B, R in ((0, 4), (2, 0)):
        out = placement_sweep_batch_cuda(args[0][:B, :R], *(a[:B] for a in args[1:]))
        assert [tuple(o.shape) for o in out] == [(B, R)] * 4
    assert placement_sweep_batch_cuda.launches == before


@pytest.mark.needs_cuda
@pytest.mark.parametrize("kw", [{}, {"resilience": 1}], ids=["plain", "resilience1"])
def test_cuda_engine_schedule_many_runs_on_kernel_2_only(cuda_device, kw):
    """schedule_many on the card: one kernel-2 launch a round (two under
    resilience), no kernel-1 launch, results equal the torch engine's."""
    from repro_torch.configs.paper_examples import example1_fleet, example1_tasks
    from repro_torch.core import PADPSFRScheduler, ScheduleInstance

    fleet = example1_fleet()
    tasks = example1_tasks()
    insts = [ScheduleInstance(tasks=tasks[:n]) for n in range(2, len(tasks) + 1)]
    k1, k2 = placement_sweep_cuda.launches, placement_sweep_batch_cuda.launches
    got = PADPSFRScheduler(fleet).schedule_many(insts, count_all_rejects=True, **kw)
    assert placement_sweep_cuda.launches == k1
    assert placement_sweep_batch_cuda.launches > k2
    want = PADPSFRScheduler(fleet, engine="torch").schedule_many(
        insts, count_all_rejects=True, **kw
    )
    for g, w in zip(got, want, strict=True):
        assert (g.feasible, g.chosen_rank, g.n_placement_rejects, g.combo) == (
            w.feasible, w.chosen_rank, w.n_placement_rejects, w.combo
        )
