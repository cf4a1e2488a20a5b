"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX, so it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_cuda_kernels.py

The placement sweeps' outputs are compared exactly: kernel and plain
version run the same float64 operations in the same order.  The attention,
SSD and RG-LRU kernels sum in another order than their plain versions, so
they are held to the reference kernel tests' tolerances: 2e-5 at float32,
2e-2 at bfloat16, outputs at atol = rtol and the scans' final states at
atol alone (at bfloat16 the RG-LRU state also differs by the plain
version's rounding of it to bfloat16).
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
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.placement_step import (  # noqa: E402
    placement_sweep_batch_cuda,
    placement_sweep_batch_plain,
    placement_sweep_cuda,
    placement_sweep_plain,
)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain  # noqa: E402


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


# ---------------------------------------------------------------------------
# kernels 1 and 2 on their tile walk (sweep_plan): packed instances, R = 1,
# ragged tails, persistent grids, 8-byte-aligned views, the deep ramp's
# blocks and wide rows; every option variant, held exactly
# ---------------------------------------------------------------------------

VARIANTS = [
    pytest.param(True, 0.0, False, id="padpsfr"),
    pytest.param(True, 9.5, False, id="padpsfr-resume9.5"),
    pytest.param(False, 0.0, False, id="preemptive-resume0"),
    pytest.param(False, 9.5, False, id="preemptive-resume9.5"),
    pytest.param(True, 0.0, True, id="survivors-k1"),
]


def _mixed_stack(B, R, n_t, n_f, seed, device):
    """B instances of R rows, padded to (n_t, n_f), with mixed live widths
    (so instances of several widths share a warp) and their resilience=1
    survivor tables: (main args, survivor args)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(B):  # instance 0 at the padded widths, the rest narrower or not
        nt = n_t if b == 0 else int(rng.integers(1, n_t + 1))
        nf = n_f if b == 0 else int(rng.integers(1, n_f + 1))
        small = min(1.0, 8.0 / nt)  # keep wide rows placeable: small per-task costs
        t_slr = rng.uniform(30.0, 120.0, nf)
        blocks.append((
            rng.uniform(0.5, 1.5, (R, nt)) * (rng.uniform(0.3, 1.3, (R, 1)) * t_slr.sum() / nt),
            rng.uniform(0.0, 6.0, nt) * small, t_slr, rng.uniform(0.0, 8.0, nf) * small,
        ))
    batch = InstanceBatch.pack(blocks)
    slr_s, cfg_s, nfe_s = survivor_batch_tables(batch.t_slr, batch.t_cfg, batch.n_f_eff, 1)

    def on(a, dtype=torch.float64):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    main = (on(batch.shares), on(batch.iis), on(batch.t_slr), on(batch.t_cfg),
            on(batch.n_t_eff, torch.int32), on(batch.n_f_eff, torch.int32))
    return main, (*main[:2], on(slr_s), on(cfg_s), main[4], on(nfe_s, torch.int32))


def _one_in(t):
    """``t`` copied into a buffer one element in: contiguous, 8-byte aligned
    and not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 8 and view.is_contiguous()
    return view


def _assert_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


# (B, R, n_t, n_f): a 64-instance round at R = 16; R = 1; B * R no multiple
# of a tile; a stack larger than the persistent grid (1024 tiles of 256
# rows against 528 blocks); n_t = 7000 (the wide path).
BATCH_TILE_CASES = {
    "round-64xR16": (64, 16, 7, 4),
    "R1-64": (64, 1, 7, 4),
    "ragged-tail-5x33": (5, 33, 10, 4),
    "persistent-64x4096": (64, 4096, 7, 4),
    "wide-2x40x7000": (2, 40, 7000, 3),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("one_in", [False, True], ids=["aligned", "one-element-in"])
@pytest.mark.parametrize("repay_init,resume,survivors", VARIANTS)
@pytest.mark.parametrize("kind", list(BATCH_TILE_CASES))
def test_placement_sweep_batch_kernel_tile_walk(cuda_device, kind, repay_init, resume,
                                                 survivors, one_in):
    """Kernel 2 == its plain version on the tile walk's shapes: tiles that
    pack several instances of mixed live widths, 64-bit row offsets, a
    persistent double-buffered grid, 8-byte copies from an unaligned view."""
    B, R, n_t, n_f = BATCH_TILE_CASES[kind]
    main, surv = _mixed_stack(B, R, n_t, n_f, len(kind), cuda_device)
    args = list(surv if survivors else main)
    if one_in:
        args[0] = _one_in(args[0])
    kw = dict(resume_cost=resume, repay_init=repay_init)
    before = placement_sweep_batch_cuda.launches
    got = placement_sweep_batch_cuda(*args, **kw)
    assert placement_sweep_batch_cuda.launches == before + 1
    _assert_equal(got, placement_sweep_batch_plain(*args, **kw))


# (rows, n_t, n_f) of kernel 1: the deep ramp's first and widest blocks
# (10 tasks, 6 devices), rows no multiple of a tile over a persistent grid
# (300003 x 8: 1172 tiles), and n_t = 7000.
SINGLE_TILE_CASES = {
    "ramp-64x10x6": (64, 10, 6),
    "ramp-65536x10x6": (65536, 10, 6),
    "persistent-300003x8": (300_003, 8, 8),
    "wide-300x7000": (300, 7000, 4),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("one_in", [False, True], ids=["aligned", "one-element-in"])
@pytest.mark.parametrize("repay_init,resume,survivors", VARIANTS)
@pytest.mark.parametrize("kind", list(SINGLE_TILE_CASES))
def test_placement_sweep_kernel_tile_walk(cuda_device, kind, repay_init, resume, survivors,
                                          one_in):
    """Kernel 1 == its plain version on the tile walk's shapes."""
    B, n_t, n_f = SINGLE_TILE_CASES[kind]
    shares, iis, t_slr, t_cfg = _block(B, n_t, n_f, B + n_t, cuda_device)
    if n_t > 8:  # keep wide rows placeable: small per-task costs
        iis, t_cfg = iis * (8.0 / n_t), t_cfg * (8.0 / n_t)
    if survivors:
        t_slr, t_cfg = (torch.tensor(a, device=cuda_device)
                        for a in survivor_tables(t_slr.cpu().numpy(), t_cfg.cpu().numpy(), 1))
    if one_in:
        shares = _one_in(shares)
    kw = dict(resume_cost=resume, repay_init=repay_init)
    before = placement_sweep_cuda.launches
    got = placement_sweep_cuda(shares, iis, t_slr, t_cfg, **kw)
    assert placement_sweep_cuda.launches == before + 1
    _assert_equal(got, placement_sweep_plain(shares, iis, t_slr, t_cfg, **kw))


# ---------------------------------------------------------------------------
# kernels 3 and 4: flash attention and the SSD scan
# ---------------------------------------------------------------------------

# The reference kernel tests' cases (tests/test_kernels.py).
ATTN_CASES = [
    # B, S, T, H, K, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 32, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (2, 96, 200, 4, 4, 128, False, 0),  # uneven, cross
    (1, 64, 64, 2, 2, 256, True, 0),  # big head dim
]
SSD_CASES = [
    # B, S, nh, hp, ng, ds, chunk
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16),
    (1, 128, 2, 8, 1, 8, 128),  # single chunk
]
ML_DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _close(got, want, tol, rtol=None):
    """Within atol = tol and rtol (= tol unless given); scan final states
    pass ``rtol=0``, atol alone, as the reference kernel tests hold them."""
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _qkv(case, dtype, device, seed=0):
    B, S, T, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32).to(device, dtype)
            for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("name", ML_DTYPES)
def test_flash_attention_kernel_matches_plain(cuda_device, case, name):
    """bfloat16 runs the tensor-core kernel, float32 the CUDA-core one."""
    dtype, tol = ML_DTYPES[name]
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, dtype, cuda_device)
    before = flash_attention_cuda.launches
    before_mma = flash_attention_cuda.mma_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)  # CUDA tensors: the kernel
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.mma_launches == before_mma + (dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, tol)


@pytest.mark.needs_cuda
def test_flash_attention_kernel_at_recurrentgemma_local_attention(cuda_device):
    """recurrentgemma-2b's attention layers: hd 256, 10 query heads on one kv
    head, causal with a 2048 window that binds at S = T = 4096."""
    case = (2, 4096, 4096, 10, 1, 256, True, 2048)
    q, k, v = _qkv(case, torch.bfloat16, cuda_device, seed=4)
    before = flash_attention_cuda.launches
    before_mma = flash_attention_cuda.mma_launches
    got = ops.flash_attention(q, k, v, causal=True, window=2048)
    want = flash_attention_plain(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.mma_launches == before_mma + 1
    _close(got, want, ML_DTYPES["bfloat16"][1])


@pytest.mark.needs_cuda
def test_flash_attention_kernel_q_offset_and_decode_route(cuda_device):
    """A prefill continuation (q_offset > 0, S < T) runs the kernel; decode
    (``ops.decode_attention``, S == 1 with a kv_len) takes the decode
    kernel and launches no flash kernel."""
    q, k, v = _qkv((2, 40, 100, 6, 2, 64), torch.float32, cuda_device, seed=3)
    _close(flash_attention_cuda(q, k, v, q_offset=60),
           flash_attention_plain(q, k, v, q_offset=60), 2e-5)
    _close(flash_attention_cuda(q, k, v, q_offset=60, window=17),
           flash_attention_plain(q, k, v, q_offset=60, window=17), 2e-5)
    before = flash_attention_cuda.launches
    before_decode = decode_attention_cuda.launches
    ops.decode_attention(q[:, :1], k, v, q_offset=70, kv_len=71)
    assert flash_attention_cuda.launches == before
    assert decode_attention_cuda.launches == before_decode + 1


@pytest.mark.needs_cuda
@pytest.mark.parametrize("q_offset,window", [(60, 0), (60, 17)])
def test_flash_attention_mma_kernel_q_offset_and_window_continuation(cuda_device, q_offset,
                                                                     window):
    """The prefill continuation of the float32 test above at bfloat16, on the
    tensor-core kernel: S < T, GQA G = 3, with and without a window."""
    q, k, v = _qkv((2, 40, 100, 6, 2, 64), torch.bfloat16, cuda_device, seed=3)
    before = flash_attention_cuda.mma_launches
    got = flash_attention_cuda(q, k, v, q_offset=q_offset, window=window)
    want = flash_attention_plain(q, k, v, q_offset=q_offset, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.mma_launches == before + 1
    _close(got, want, ML_DTYPES["bfloat16"][1])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", [
    # B, S, T, H, K, hd, causal, window, q_offset
    (2, 77, 77, 4, 4, 64, True, 0, 0),  # G = 1
    (3, 50, 50, 9, 3, 64, True, 0, 0),  # G = 3 (smollm-135m's heads)
    (2, 70, 70, 10, 1, 256, True, 24, 0),  # G = 10, window binds (recurrentgemma-2b's heads)
    (1, 33, 129, 10, 1, 128, True, 0, 96),  # S != T, continuation
    (2, 45, 300, 6, 2, 32, False, 0, 0),  # S != T, cross
    (1, 17, 40, 3, 1, 16, True, 5, 23),  # hd 16, window and offset
], ids=str)
def test_flash_attention_mma_kernel_gqa_groups_and_ragged_lengths(cuda_device, case):
    B, S, T, H, K, hd, causal, window, q_offset = case
    q, k, v = _qkv(case, torch.bfloat16, cuda_device, seed=5)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention_cuda.mma_launches
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.mma_launches == before + 1
    _close(got, want, ML_DTYPES["bfloat16"][1])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", [
    # B, S, T, H, K, hd, causal
    (2, 256, 256, 16, 16, 128, True),  # G = 1, hd 128 (moonshot-v1-16b-a3b's heads)
    (2, 256, 256, 12, 2, 128, True),  # G = 6, hd 128 (qwen2-vl-2b's heads)
    (2, 256, 256, 16, 16, 64, False),  # no mask (seamless-m4t-large-v2's encoder)
    (2, 128, 1024, 16, 16, 64, False),  # S != T, no mask (its cross-attention)
], ids=str)
def test_flash_attention_mma_kernel_at_the_moe_vlm_encdec_shapes(cuda_device, case):
    q, k, v = _qkv(case, torch.bfloat16, cuda_device, seed=6)
    before = flash_attention_cuda.mma_launches
    got = ops.flash_attention(q, k, v, causal=case[6])
    want = flash_attention_plain(q, k, v, causal=case[6])
    torch.cuda.synchronize()
    assert flash_attention_cuda.mma_launches == before + 1
    _close(got, want, ML_DTYPES["bfloat16"][1])


@pytest.mark.needs_cuda
def test_flash_attention_mma_kernel_empty_and_refusals(cuda_device):
    q, k, v = _qkv((2, 8, 8, 4, 2, 64), torch.bfloat16, cuda_device)
    before = (flash_attention_cuda.launches, flash_attention_cuda.mma_launches)
    out = flash_attention_cuda(q[:, :0], k, v)
    assert out.shape == (2, 0, 4, 64) and out.dtype == torch.bfloat16
    assert (flash_attention_cuda.launches, flash_attention_cuda.mma_launches) == before
    with pytest.raises(ValueError, match="empty key sequence"):
        flash_attention_cuda(q, k[:, :0], v[:, :0])
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(flat[1:].view(q.shape), k, v)


@pytest.mark.needs_cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv((1, 16, 16, 2, 1, 64), torch.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    q48, k48, v48 = _qkv((1, 16, 16, 2, 1, 48), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_cuda(q48, k48, v48)


def _ssd(case, dtype, device, seed=0):
    B, S, nh, hp, ng, ds = case[:6]
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a, np.float32)).to(device)  # noqa: E731
    x = f(rng.standard_normal((B, S, nh, hp))).to(dtype)
    dt = f(np.logaddexp(rng.standard_normal((B, S, nh)), 0.0))
    A = f(-np.exp(rng.standard_normal(nh) * 0.3))
    Bm = f(rng.standard_normal((B, S, ng, ds)) * 0.3).to(dtype)
    Cm = f(rng.standard_normal((B, S, ng, ds)) * 0.3).to(dtype)
    D = f(rng.standard_normal(nh))
    return x, dt, A, Bm, Cm, D


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("name", ML_DTYPES)
def test_ssd_scan_kernel_matches_plain(cuda_device, case, name):
    """bfloat16 runs the tensor-core kernel, float32 the CUDA-core one."""
    dtype, tol = ML_DTYPES[name]
    args = _ssd(case, dtype, cuda_device)
    before = ssd_scan_cuda.launches
    before_mma = ssd_scan_cuda.mma_launches
    got_y, got_st = ops.ssd_scan(*args, chunk=case[6], return_state=True)  # the kernel
    want_y, want_st = ssd_scan_plain(*args, chunk=case[6], return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    assert ssd_scan_cuda.mma_launches == before_mma + (dtype == torch.bfloat16)
    assert got_y.dtype == dtype and got_st.dtype == torch.float32
    _close(got_y, want_y, tol)
    _close(got_st, want_st, tol, rtol=0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case,chunk,runs_at", [
    ((8, 1024, 24, 64, 1, 128), 256, 256),  # mamba2-130m's prefill
    ((1, 96, 2, 8, 1, 8), 64, 48),  # ops.ssd_scan shrinks chunk 64 to 48 at S = 96
    ((2, 200, 4, 128, 2, 200), 100, 100),  # hp 128, ds in 4 slices (the last partial), 2 tiles
    ((1, 70, 3, 12, 1, 20), 35, 35),  # hp and ds not multiples of 8: 2-byte staging
    ((1, 64, 2, 16, 1, 0), 32, 32),  # no state: y = D x
], ids=str)
def test_ssd_scan_mma_kernel_shapes_and_chunk_shrink(cuda_device, case, chunk, runs_at):
    args = _ssd(case, torch.bfloat16, cuda_device, seed=7)
    before = ssd_scan_cuda.mma_launches
    got_y, got_st = ops.ssd_scan(*args, chunk=chunk, return_state=True)
    want_y, want_st = ssd_scan_plain(*args, chunk=runs_at, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.mma_launches == before + 1
    _close(got_y, want_y, 2e-2)
    _close(got_st, want_st, 2e-2, rtol=0)


@pytest.mark.needs_cuda
def test_ssd_scan_mma_kernel_unaligned_inputs(cuda_device):
    """x, B and C off 16-byte alignment take the 2-byte staging."""
    x, dt, A, Bm, Cm, D = _ssd((1, 64, 2, 16, 1, 16), torch.bfloat16, cuda_device, seed=8)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    xs, bs, cs = shifted(x), shifted(Bm), shifted(Cm)
    assert xs.data_ptr() % 16 and bs.data_ptr() % 16
    got_y, got_st = ssd_scan_cuda(xs, dt, A, bs, cs, D, chunk=32, return_state=True)
    want_y, want_st = ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=32, return_state=True)
    torch.cuda.synchronize()
    _close(got_y, want_y, 2e-2)
    _close(got_st, want_st, 2e-2, rtol=0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ML_DTYPES)
def test_ssd_scan_kernel_empty_launches_nothing(cuda_device, name):
    x, dt, A, Bm, Cm, D = _ssd((2, 32, 2, 8, 1, 8), ML_DTYPES[name][0], cuda_device)
    before = (ssd_scan_cuda.launches, ssd_scan_cuda.mma_launches)
    for cut in (lambda t: t[:0], lambda t: t[:, :0]):  # an empty batch, an empty sequence
        y, st = ssd_scan_cuda(cut(x), cut(dt), A, cut(Bm), cut(Cm), D, chunk=16,
                              return_state=True)
        assert y.numel() == 0 and not st.any()
    assert (ssd_scan_cuda.launches, ssd_scan_cuda.mma_launches) == before


@pytest.mark.needs_cuda
def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda_device):
    x, dt, A, Bm, Cm, D = _ssd((1, 32, 2, 8, 1, 8), torch.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), D, chunk=16)
    with pytest.raises(TypeError, match="A and D must be float32"):
        ssd_scan_cuda(x, dt, A.double(), Bm, Cm, D, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, D, chunk=16)
    x2, dt2, A2, B2, C2, D2 = _ssd((1, 32, 2, 256, 1, 8), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="hp = 256"):
        ssd_scan_cuda(x2, dt2, A2, B2, C2, D2, chunk=16)


# RG-LRU: the reference kernel tests' cases (B, S, W) and recurrentgemma-2b's
# prefill shape (8 prompts of 1024 tokens, lru_width 2560).
RGLRU_CASES = [(2, 128, 64), (1, 100, 200), (2, 64, 256), (1, 32, 16)]
RGLRU_PREFILL = (8, 1024, 2560)


def _rglru(case, dtype, device, seed=0, slow=False):
    """x, r, i standard normal in ``dtype``; log_lambda float32, standard
    normal or (``slow``) uniform in [-8, -4], where a lies near 1 and the
    state carries across many chunks."""
    B, S, W = case
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return (*(f(rng.standard_normal((B, S, W))).to(dtype) for _ in range(3)),
            f(rng.uniform(-8.0, -4.0, W) if slow else rng.standard_normal(W)))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", [*RGLRU_CASES, RGLRU_PREFILL], ids=str)
@pytest.mark.parametrize("name", ML_DTYPES)
def test_rglru_scan_kernel_matches_plain(cuda_device, case, name):
    dtype, tol = ML_DTYPES[name]
    args = _rglru(case, dtype, cuda_device)
    before = rglru_scan_cuda.launches
    got_y, got_st = ops.rglru_scan(*args, return_state=True)  # CUDA tensors: the kernel
    want_y, want_st = rglru_scan_plain(*args, return_state=True)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 1
    assert got_y.dtype == dtype and got_st.dtype == torch.float32
    assert got_st.shape == (case[0], case[2])
    _close(got_y, want_y, tol)
    _close(got_st, want_st, tol, rtol=0)


@pytest.mark.needs_cuda
def test_rglru_scan_kernel_layouts_and_lambda_types(cuda_device):
    """A non-contiguous input goes through ops.rglru_scan (made contiguous
    there), and a bfloat16 log_lambda (as Model(dtype=bfloat16) stores it)
    is read as is."""
    x, r, i, lam = _rglru((2, 48, 64), torch.float32, cuda_device, seed=1)
    want = rglru_scan_plain(x, r, i, lam)
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not xt.is_contiguous()
    _close(ops.rglru_scan(xt, r, i, lam), want, 2e-5)
    lam16 = lam.bfloat16()
    _close(rglru_scan_cuda(x, r, i, lam16), rglru_scan_plain(x, r, i, lam16), 2e-5)


# The chunked kernel's edges (decay, (B, S, W)): a slow decay at
# recurrentgemma-2b's width, S = 1, S = 4096, S off the chunk (8) and the
# window (64), and W 100 (off bf16's 16-byte vector) and 200 (a ragged tile).
RGLRU_EDGES = [
    ("slow", (2, 1024, 2560)), ("normal", (2, 1, 2560)), ("slow", (1, 4096, 256)),
    ("normal", (2, 333, 2560)), ("slow", (2, 200, 100)), ("slow", (1, 77, 200)),
]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("decay,case", RGLRU_EDGES, ids=[f"{d}-{c}" for d, c in RGLRU_EDGES])
@pytest.mark.parametrize("name", ML_DTYPES)
def test_rglru_scan_kernel_chunk_edges(cuda_device, decay, case, name):
    dtype, tol = ML_DTYPES[name]
    args = _rglru(case, dtype, cuda_device, seed=2, slow=decay == "slow")
    got_y, got_st = rglru_scan_cuda(*args, return_state=True)
    want_y, want_st = rglru_scan_plain(*args, return_state=True)
    torch.cuda.synchronize()
    _close(got_y, want_y, tol)
    _close(got_st, want_st, tol, rtol=0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ML_DTYPES)
def test_rglru_scan_kernel_unaligned_inputs(cuda_device, name):
    """Contiguous views one element into their storage (not 16-byte
    aligned) are staged element by element, with the same result."""
    dtype, tol = ML_DTYPES[name]
    args = _rglru((2, 150, 256), dtype, cuda_device, seed=3, slow=True)

    def odd(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
        return v.copy_(t)

    x, r, i = (odd(t) for t in args[:3])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got_y, got_st = rglru_scan_cuda(x, r, i, args[3], return_state=True)
    want_y, want_st = rglru_scan_plain(*args, return_state=True)
    torch.cuda.synchronize()
    _close(got_y, want_y, tol)
    _close(got_st, want_st, tol, rtol=0)


@pytest.mark.needs_cuda
def test_rglru_scan_kernel_bf16_lambda_at_prefill_width(cuda_device):
    """bfloat16 x, r, i and log_lambda together, as Model(dtype=bfloat16)
    hands them to the kernel, at recurrentgemma-2b's width."""
    x, r, i, lam = _rglru((2, 1024, 2560), torch.bfloat16, cuda_device, seed=4, slow=True)
    lam16 = lam.bfloat16()
    got_y, got_st = rglru_scan_cuda(x, r, i, lam16, return_state=True)
    want_y, want_st = rglru_scan_plain(x, r, i, lam16, return_state=True)
    torch.cuda.synchronize()
    _close(got_y, want_y, 2e-2)
    _close(got_st, want_st, 2e-2, rtol=0)


@pytest.mark.needs_cuda
def test_rglru_scan_kernel_refuses_what_it_does_not_take(cuda_device):
    x, r, i, lam = _rglru((1, 16, 32), torch.float32, cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan_cuda(x.half(), r.half(), i.half(), lam)
    with pytest.raises(TypeError, match="log_lambda must be"):
        rglru_scan_cuda(x, r, i, lam.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), r, i, lam)
    before = rglru_scan_cuda.launches
    y, st = rglru_scan_cuda(x[:, :0], r[:, :0], i[:, :0], lam, return_state=True)
    assert rglru_scan_cuda.launches == before
    assert y.shape == (1, 0, 32) and not st.any()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m", "recurrentgemma-2b"])
def test_reduced_models_on_the_card_match_the_cpu(cuda_device, name):
    """Reduced models at float32: prefill on the card (through kernels 3, 4
    or 5, once a layer of their kind) and a decode step equal the CPU's
    plain path."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model

    cfg = get_arch(name).reduced()
    gpu = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device)
    cpu = Model(cfg, params=_cpu_tree(gpu.params), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 40)))
    kinds = cfg.layer_kinds()
    kernels = {flash_attention_cuda: kinds.count("attn"), ssd_scan_cuda: kinds.count("ssm"),
               rglru_scan_cuda: kinds.count("rec")}
    before = {k: k.launches for k in kernels}
    g_last, g_state = gpu.prefill({"tokens": tok.to(cuda_device)})
    assert {k: k.launches - before[k] for k in kernels} == kernels
    c_last, c_state = cpu.prefill({"tokens": tok})
    _close(g_last.cpu(), c_last, 1e-4)
    if cfg.family == "dense":
        grow = lambda st: tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) for a in st)  # noqa: E731
        g_state, c_state = grow(g_state), grow(c_state)
    g_log, _ = gpu.decode_step(g_state, tok[:, 0].to(cuda_device), 40)
    c_log, _ = cpu.decode_step(c_state, tok[:, 0], 40)
    _close(g_log.cpu(), c_log, 1e-4)


def _cpu_tree(tree):
    return {k: _cpu_tree(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _leaves(t, f"{prefix}/{n}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for n, t in enumerate(tree) for k, v in _leaves(t, f"{prefix}/{n}").items()}
    return {prefix: tree}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_reduced_moe_vlm_encdec_models_on_the_card_match_the_cpu(cuda_device, name):
    """Reduced MoE, VLM (a patch prefix, 3-D positions) and enc-dec models
    at float32: the card's prefill (kernel 3, one launch an attention, an
    enc-dec decoder layer two), its every state leaf and a decode step equal
    the CPU's plain path."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve.engine import _pad_cache_to

    cfg = get_arch(name).reduced()
    gpu = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device)
    cpu = Model(cfg, params=_cpu_tree(gpu.params), device="cpu")
    rng = np.random.default_rng(2)
    S = 40
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, S - 8 * (
        cfg.family == "vlm"))))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model))).float()
        pos = np.stack([np.zeros(S), np.arange(S) % 5, np.arange(S) // 5], -1)
        batch["positions"] = torch.from_numpy(np.broadcast_to(pos, (2, S, 3)).copy()).long()
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))).float()
    before = flash_attention_cuda.launches
    g_last, g_state = gpu.prefill({k: v.to(cuda_device) for k, v in batch.items()})
    want_launches = cfg.n_layers + (cfg.enc_layers + cfg.n_layers) * (cfg.family == "encdec")
    assert flash_attention_cuda.launches - before == want_launches
    c_last, c_state = cpu.prefill(batch)
    _close(g_last.cpu(), c_last, 1e-4)
    g_leaves, c_leaves = _leaves(g_state), _leaves(c_state)
    assert sorted(g_leaves) == sorted(c_leaves)
    for path, leaf in c_leaves.items():
        _close(g_leaves[path].cpu(), leaf, 1e-4)
    g_state, c_state = (_pad_cache_to(st, m, S + 1) for st, m in ((g_state, gpu), (c_state, cpu)))
    g_log, _ = gpu.decode_step(g_state, batch["tokens"][:, 0].to(cuda_device), S)
    c_log, _ = cpu.decode_step(c_state, batch["tokens"][:, 0], S)
    _close(g_log.cpu(), c_log, 1e-4)
