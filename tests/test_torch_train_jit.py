"""The port's compiled train step, ``TrainLoop(jit=True, donate=True)``, on
the CPU, and the scheduler names that closed the port's last API gaps.

``TrainLoop`` takes the JAX package's parameters and defaults.  On a CPU
model ``jit=True`` builds no CUDA graph: the step runs eagerly and its
history and state equal ``jit=False``'s bit for bit, under either
``donate``.  From a state the reference drew (numpy-seeded batches; the
state carried across by ``convert.train_state_from``), the port's
``TrainLoop(jit=True)`` and ``TrainLoop(jit=False)`` losses stay within
1e-5 relative of the reference's ``TrainLoop(jit=True, donate=True)`` and
of its eager ``jit=False``.  ``CudaGraphStep``'s signatures take the train
state (a dataclass, ``None`` for an empty subtree).  ``Task.weight(j)`` and
``FleetSpec.t_cfg_max`` equal the reference's bit for bit on Example 1 and
on heterogeneous fleets.

The card tests (capture, replay, donation) are in
``tests/test_torch_train_jit_cuda.py``, which imports no JAX.
"""

import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import paper_examples as ref_examples  # noqa: E402
from repro.configs.shapes import InputShape as RefInputShape  # noqa: E402
from repro.core.variants import make_hetero_fleet as ref_make_hetero_fleet  # noqa: E402
from repro.data import make_batch_fn as ref_make_batch_fn  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import linear_warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.train import TrainLoop as RefTrainLoop  # noqa: E402
from repro.train import TrainLoopConfig as RefTrainLoopConfig  # noqa: E402
from repro.train.step import init_train_state as ref_init_train_state  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import paper_examples as port_examples  # noqa: E402
from repro_torch.convert import train_state_from  # noqa: E402
from repro_torch.core import FleetSpec  # noqa: E402
from repro_torch.core.variants import make_hetero_fleet  # noqa: E402
from repro_torch.launch.train import build_loop  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from repro_torch.graphs import CudaGraphStep, signature  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig, TrainState  # noqa: E402

LOSS_REL = 1e-5
S, B = 32, 4


def _params(sig: inspect.Signature) -> list:
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


def test_train_loop_takes_the_reference_parameters_and_defaults():
    got = inspect.signature(TrainLoop.__init__)
    want = inspect.signature(RefTrainLoop.__init__)
    assert _params(got) == _params(want)
    assert got.parameters["jit"].default is True and got.parameters["donate"].default is True
    assert got.parameters["jit"].kind is inspect.Parameter.KEYWORD_ONLY


def _history(loop: TrainLoop) -> list:
    return [{k: v for k, v in h.items() if k != "step_time"} for h in loop.history]


@pytest.mark.parametrize("microbatch,compress", [(0, False), (2, False), (0, True)])
@pytest.mark.parametrize("donate", [True, False])
def test_cpu_model_runs_the_eager_step_under_jit(donate, microbatch, compress):
    """On a CPU model ``jit=True`` captures nothing, whatever ``donate``:
    history and final state equal ``jit=False``'s bit for bit."""
    runs = []
    for jit in (True, False):
        proto, _ = build_loop("smollm-135m", steps=6, seq_len=S, batch=B, log_every=0,
                              microbatch=microbatch, compress_grads=compress, device="cpu")
        loop = TrainLoop(proto.model, proto.optimizer, proto.batch_fn, proto.config,
                         jit=jit, donate=donate)
        assert not isinstance(loop.step_fn, CudaGraphStep)
        runs.append((loop, loop.run(torch.Generator().manual_seed(5))))
    (a, sa), (b, sb) = runs
    assert len(a.history) == 6 and _history(a) == _history(b)
    assert (sa.ef_residual is not None) == compress
    for x, y in zip(leaves(sa), leaves(sb), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_cpu_model_step_leaves_the_callers_state_unwritten():
    """The eager step on a CPU model is the functional one: a new state,
    the given one unchanged, under the default ``donate=True``."""
    loop, _ = build_loop("smollm-135m", steps=2, seq_len=S, batch=B, log_every=0,
                         device="cpu")
    state = loop.init_or_resume(torch.Generator().manual_seed(6))
    before = [t.clone() for t in leaves(state)]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in loop.batch_fn(0).items()}
    new, _ = loop.step_fn(state, batch)
    assert int(new.step) == 1 and int(state.step) == 0
    assert all(torch.equal(x, y) for x, y in zip(leaves(state), before, strict=True))
    assert all(x.data_ptr() != y.data_ptr() for x, y in
               zip(leaves(new.params), leaves(state.params), strict=True))


REF_STEPS, REF_EAGER_STEPS = 4, 2  # the eager JAX loop dispatches op by op: a few steps


def _ref_loop(jit: bool, steps: int, seed: int):
    """The reference's loop on reduced smollm-135m (the XLA route, no remat)
    from its own initial state, which is returned as numpy leaves too."""
    cfg = ref_get_arch("smollm-135m").reduced()
    model = RefModel(cfg, RefExecConfig(attn_impl="xla", remat="none"))
    opt = RefAdamW(ref_warmup_cosine(1e-3, 1, 5))
    fn = ref_make_batch_fn(cfg, RefInputShape("t", S, B, "train"), seed=seed)
    loop = RefTrainLoop(model, opt, fn, RefTrainLoopConfig(total_steps=steps, log_every=0),
                        jit=jit, donate=True)
    state = ref_init_train_state(model, opt, jax.random.PRNGKey(seed))
    held = jax.tree.map(lambda x: np.array(x, copy=True), state)  # before donation
    loop.init_or_resume = lambda _key: state
    return loop, held, fn


@pytest.mark.parametrize("ref_jit", [True, False])
def test_port_loops_follow_the_reference_loops(ref_jit):
    """From the reference's initial state and batches: the port's loop under
    ``jit=True`` and ``jit=False`` against the reference's under its own
    ``jit`` (with ``donate=True``), every step's loss within 1e-5 relative,
    the grad norms within 1e-4."""
    seed = int(np.random.default_rng(25).integers(1 << 16))
    steps = REF_STEPS if ref_jit else REF_EAGER_STEPS
    ref, held, fn = _ref_loop(ref_jit, steps, seed)
    ref.run(jax.random.PRNGKey(seed))
    model = Model(get_arch("smollm-135m").reduced(), ExecConfig(attn_impl="xla", remat="none"),
                  params={}, device="cpu")
    for jit in (True, False):
        loop = TrainLoop(model, AdamW(linear_warmup_cosine(1e-3, 1, 5)), fn,
                         TrainLoopConfig(total_steps=steps, log_every=0), jit=jit)
        loop.init_or_resume = lambda _gen: train_state_from(held, "cpu")
        state = loop.run(torch.Generator())
        assert int(state.step) == steps and len(loop.history) == len(ref.history) == steps
        for got, want in zip(loop.history, ref.history, strict=True):
            assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_REL), (jit, got["step"])
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)


def test_graph_signatures_take_the_train_state():
    """The captured step's argument is a ``TrainState``: a dataclass, its
    ``ef_residual`` ``None`` without compression."""
    def state(n, ef):
        p = {"w": torch.zeros(n), "b": torch.zeros(2)}
        return TrainState(params=p, opt_state={"m": p, "v": p},
                          step=torch.zeros((), dtype=torch.int32), ef_residual=ef)

    a, b = state(3, None), state(3, None)
    assert signature((a, {"x": torch.ones(2)})) == signature((b, {"x": torch.zeros(2)}))
    assert signature(a) != signature(state(4, None))
    assert signature(a) != signature(state(3, {"w": torch.zeros(3), "b": torch.zeros(2)}))
    assert signature(a) != signature(dataclasses.asdict(a))

    @dataclasses.dataclass
    class Other:
        params: object
        opt_state: object
        step: object
        ef_residual: object = None

    assert signature(a) != signature(Other(a.params, a.opt_state, a.step))


def test_task_weight_equals_the_reference():
    """``Task.weight(j)`` = e_ij / p_i in the reference's float64 order."""
    got, want = port_examples.example1_tasks(), ref_examples.example1_tasks()
    n = 0
    for t, r in zip(got, want, strict=True):
        for j in range(r.nv):
            w = t.weight(j)
            assert type(w) is type(r.weight(j)) and w == r.weight(j)
            assert w == t.exec_times()[j] / t.period
            n += 1
    assert n == sum(r.nv for r in want) > 0


@pytest.mark.parametrize("classes", [{"fpga": 2, "gpu": 1}, {"cpu": 3, "fpga": 1, "gpu": 2},
                                     [("gpu", 1)], {"fpga": 4}])
def test_fleet_t_cfg_max_equals_the_reference(classes):
    for t_slr in (60.0, 3600.0, 0.1):
        got, want = make_hetero_fleet(classes, t_slr), ref_make_hetero_fleet(classes, t_slr)
        assert got.t_cfg_max == want.t_cfg_max and got.t_cfg_min == want.t_cfg_min
        assert got.t_cfg_max == max(got.t_cfg_arr.tolist())
    hom, ref_hom = port_examples.example1_fleet(), ref_examples.example1_fleet()
    assert hom.t_cfg_max == ref_hom.t_cfg_max == hom.t_cfg
    assert FleetSpec(n_f=2, t_slr=5.0, t_cfg=0.5).t_cfg_max == 0.5
