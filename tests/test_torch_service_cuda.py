"""The port's replanner and service on ``engine="cuda"``, on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_service_cuda.py

The card's engine dispatches asynchronously: a recorded walk enqueues one
block past the winner and abandons it, so its recorded state may hold
more rows (with unknown verdicts) than the eager ``"torch"`` engine's,
and its telemetry paths may differ.  Its plans may not: every trace here
runs through a ``"cuda"`` service and a ``"torch"`` service side by side
and every live plan must be equal.
"""

import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.paper_examples import example1_fleet, example1_tasks  # noqa: E402
from repro_torch.core import FleetSpec, PADPSFRScheduler, Task, TaskVariant  # noqa: E402
from repro_torch.core.replan import VERDICT_UNKNOWN  # noqa: E402
from repro_torch.kernels.placement_step import (  # noqa: E402
    placement_sweep_batch_cuda,
    placement_sweep_cuda,
)
from repro_torch.service import SchedulerService, run_fault_injection  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand_task(rng, name, *, int_powers=False):
    """``tests/test_service_replay.py``'s random task, at the port's types."""
    variants = tuple(
        TaskVariant(cu=1, throughput=rng.uniform(1.0, 8.0),
                    power=float(rng.randint(1, 8)) if int_powers else rng.uniform(1, 10))
        for _ in range(rng.randint(1, 3))
    )
    return Task(name=name, period=rng.uniform(5, 20), data=rng.uniform(10, 60),
                init_interval=rng.uniform(0.0, 1.0), variants=variants)


def _same_plan(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.feasible == b.feasible
    assert a.chosen_rank == b.chosen_rank
    assert a.n_placement_rejects == b.n_placement_rejects
    assert a.total_power == b.total_power
    if b.feasible:
        assert a.combo == b.combo
        assert str(a.plan) == str(b.plan)


class Pair:
    """A "cuda" service and a "torch" service fed the same events."""

    def __init__(self, fleet, **kw):
        self.card = SchedulerService(fleet, engine="cuda", **kw)
        self.cpu = SchedulerService(fleet, engine="torch", **kw)

    def __getattr__(self, event):
        def run(*args):
            a, b = getattr(self.card, event)(*args), getattr(self.cpu, event)(*args)
            assert (a.admitted, a.feasible, a.total_power, a.chosen_rank, a.n_tasks) == (
                b.admitted, b.feasible, b.total_power, b.chosen_rank, b.n_tasks)
            assert self.card.tasks == self.cpu.tasks and self.card.fleet == self.cpu.fleet
            _same_plan(self.card.plan, self.cpu.plan)
            if self.card.tasks:
                cold = PADPSFRScheduler(self.card.fleet, engine="cuda").schedule(
                    self.card.tasks, **self.card.placement_kw)
                _same_plan(self.card.plan, cold)
            return a
        return run


@pytest.mark.needs_cuda
def test_random_traces_on_the_card_match_the_plain_engine(cuda_device):
    for seed in range(10):
        rng = random.Random(1000 + seed)
        fleet = FleetSpec(n_f=rng.randint(2, 3), t_slr=rng.uniform(15, 40),
                          t_cfg=rng.uniform(0.0, 1.5))
        pair = Pair(fleet, record_exhaustive=bool(seed % 2), cache_plans=bool(seed % 3))
        counter = 0
        for _ in range(rng.randint(3, 6)):
            roll = rng.random()
            if roll < 0.55 or not pair.cpu.tasks:
                counter += 1
                pair.submit(_rand_task(rng, f"t{counter}", int_powers=seed % 2 == 0))
            elif roll < 0.9:
                pair.remove(rng.choice(pair.cpu.tasks).name)
            elif pair.cpu.fleet.n_f > 1:
                pair.fail_device()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("resilience", [0, 1])
def test_churn_trace_on_the_card_matches_the_plain_engine(cuda_device, resilience):
    rng = random.Random(4242 + 17 + resilience)
    pair = Pair(FleetSpec(n_f=3, t_slr=35.0, t_cfg=1.0), resilience=resilience, max_stale=5)
    counter = 0
    for _ in range(110):
        roll = rng.random()
        svc = pair.cpu
        n_alive = len(svc.tasks)
        if (roll < 0.45 and n_alive < 4) or n_alive == 0:
            counter += 1
            pair.submit(_rand_task(rng, f"t{counter}", int_powers=True))
        elif roll < 0.80 and n_alive:
            pair.remove(rng.choice(svc.tasks).name)
        elif roll < 0.90 and svc.fleet.n_f > svc.resilience + 1:
            pair.fail_device()
        else:
            pair.recover_device()
    paths = {t.path for t in pair.card.telemetry}
    assert paths & {"warm", "warm_exit", "warm_failure"}


@pytest.mark.needs_cuda
def test_abandoned_block_is_recorded_unknown(cuda_device):
    """Example 1's winner sits at rank 4, in the first 64-row block; the
    card's walk has the second (512-row) block in flight when that
    verdict comes back and abandons it.  Its rows are recorded with
    unknown verdicts and depth -1, after the first block's rows, which
    equal the plain engine's recording."""
    tasks, fleet = example1_tasks(), example1_fleet()
    card = PADPSFRScheduler(fleet, engine="cuda").schedule(tasks, record_state=True)
    cpu = PADPSFRScheduler(fleet, engine="torch").schedule(tasks, record_state=True)
    _same_plan(card, cpu)
    st, ref = card.plan_state, cpu.plan_state
    assert st.engine == "cuda" and ref.n_recorded == 64
    assert st.n_recorded == 64 + 512
    for name in ("rec_pow", "rec_sumshr", "rec_chosen", "rec_verdict", "rec_depth"):
        np.testing.assert_array_equal(getattr(st, name)[:64], getattr(ref, name), err_msg=name)
    assert (st.rec_verdict[64:] == VERDICT_UNKNOWN).all()
    assert (st.rec_depth[64:] == -1).all()
    assert st.frontier_coverage == ref.frontier_coverage == 1.0
    # the unknown rows lead to the same warm plans
    extra = Task("x", period=60.0, data=10.0, init_interval=1.0,
                 variants=(TaskVariant(cu=1, throughput=2.0, power=1.5),))
    for sched, state in ((PADPSFRScheduler(fleet, engine="cuda"), st),
                         (PADPSFRScheduler(fleet, engine="torch"), ref)):
        warm = sched.replan(state, tasks + (extra,))
        _same_plan(warm, PADPSFRScheduler(fleet, engine="torch").schedule(tasks + (extra,)))


@pytest.mark.needs_cuda
def test_what_if_many_runs_on_the_batch_kernel_alone(cuda_device):
    rng = random.Random(5)
    fleet = FleetSpec(n_f=3, t_slr=35.0, t_cfg=1.0)
    svc = SchedulerService(fleet, engine="cuda")
    for i in range(3):
        svc.submit(_rand_task(rng, f"s{i}", int_powers=True))
    cands = [_rand_task(rng, f"c{i}") for i in range(16)]
    placement_sweep_cuda.launches = 0
    placement_sweep_batch_cuda.launches = 0
    got = svc.what_if_many(cands)
    assert placement_sweep_batch_cuda.launches > 0
    assert placement_sweep_cuda.launches == 0
    cpu = PADPSFRScheduler(fleet, engine="torch")
    for c, g in zip(cands, got, strict=True):
        _same_plan(g, cpu.schedule(svc.tasks + (c,)))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("k", [1, 2])
def test_fault_injection_on_the_card_has_no_misses(cuda_device, k):
    fleet = FleetSpec(n_f=4, t_slr=30.0, t_cfg=1.0)
    tasks = [Task(name=f"R{i}", period=10.0, data=20.0, init_interval=1.0,
                  variants=(TaskVariant(cu=1, throughput=2.4, power=2.0),
                            TaskVariant(cu=2, throughput=6.0, power=8.0)))
             for i in range(4)]
    for seed in range(8):
        r = run_fault_injection(fleet, tasks, resilience=k, n_failures=k, seed=seed)
        assert r.survived and r.total_misses == 0
        want = run_fault_injection(fleet, tasks, resilience=k, n_failures=k, seed=seed,
                                   engine="torch")
        assert [(x.event, x.total_power) for x in r.records] == [
            (x.event, x.total_power) for x in want.records]
