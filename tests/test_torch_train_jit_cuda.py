"""The port's compiled train step on the card: ``TrainLoop(jit=True,
donate=True)`` as one CUDA graph of the whole step.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_train_jit_cuda.py

Reduced models at float32 on the differentiable route, with the checkpoint
recompute (``remat="full"``) inside the captured backward.  In every
family the captured loop's losses, grad norms and final state lie within
1e-6 relative of the eager loop's (the parity limit; every sum of the
step's backward has a fixed order on the card, and
``test_torch_train_determinism_cuda.py`` holds repeats bitwise); one graph is
captured a batch signature and the other steps replay it; a new sequence
length captures anew.  Under ``donate=True`` the step returns the given
state's own leaves, updated in place; under ``donate=False`` it never
writes the caller's state; both with microbatches and with compressed
gradients.  A host read inside the step makes the capture raise, with no
eager retry.  A checkpointed captured run resumed by a fresh captured loop
follows the straight one bit for bit.  No kernel node of kernels 3-5 is in the graph.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from repro_torch.graphs import CudaGraphStep  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig  # noqa: E402

FAMILY_ARCHS = ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-2b",
                "seamless-m4t-large-v2", "qwen2-vl-2b"]  # dense, moe, ssm, hybrid, encdec, vlm
S, B = 32, 4  # the reduced hybrid's window is 16 and its SSM chunk 16: both bind at S = 32
REL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _loop(name: str, device, *, jit: bool = True, donate: bool = True, steps: int = 5,
          seq_len: int = S, microbatch: int = 0, compress: bool = False,
          ckpt_dir: str = "") -> TrainLoop:
    cfg = get_arch(name).reduced()
    model = Model(cfg, ExecConfig(attn_impl="xla", remat="full"), params={}, device=device)
    return TrainLoop(model, AdamW(linear_warmup_cosine(1e-3, 1, 10)),
                     make_batch_fn(cfg, InputShape("t", seq_len, B, "train"), seed=1),
                     TrainLoopConfig(total_steps=steps, ckpt_every=steps, log_every=0,
                                     ckpt_dir=ckpt_dir, microbatch=microbatch,
                                     compress_grads=compress),
                     jit=jit, donate=donate)


def _batch(loop: TrainLoop, step: int) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=loop.model.device)
            for k, v in loop.batch_fn(step).items()}


def _close(got, want, what: str, *, compress: bool = False) -> None:
    """Every leaf within REL of the eager one's largest magnitude.  With
    compressed gradients an element that lies on an int8 rounding edge can
    round one way in one run and the other in the next, which moves that
    element's moments and weight by a rounding step: at most one element in
    a thousand of a leaf may do so (as the CPU tests allow against the
    reference)."""
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want), strict=True)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        if not b.is_floating_point():
            assert torch.equal(a, b), (what, i)
            continue
        off = (a - b).abs() > REL * max(float(b.abs().max()), 1e-30)
        assert int(off.sum()) <= (b.numel() // 1000 if compress else 0), (what, i)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_captured_loop_equals_the_eager_loop(cuda_device, name):
    gen = torch.Generator(cuda_device)
    captured = _loop(name, cuda_device)
    eager = _loop(name, cuda_device, jit=False)
    assert isinstance(captured.step_fn, CudaGraphStep)
    assert not isinstance(eager.step_fn, CudaGraphStep)
    before = counts.read()
    got = captured.run(gen.manual_seed(0))
    assert counts.delta(counts.read(), before) == {}  # no wrapper ran, none was replayed
    want = eager.run(gen.manual_seed(0))
    assert len(captured.step_fn.graphs) == len(captured.step_fn.captures) == 1
    (entry,) = captured.step_fn.graphs.values()
    assert entry.replays == 5 - 1
    for g, w in zip(captured.history, eager.history, strict=True):
        for key in ("loss", "grad_norm", "ce", "aux"):
            assert g[key] == pytest.approx(w[key], rel=REL, abs=1e-12), (g["step"], key)
    assert int(got.step) == int(want.step) == 5
    _close(got, want, name)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m"])
def test_graph_holds_no_kernel_of_kernels_3_to_5(cuda_device, name):
    loop = _loop(name, cuda_device, steps=2)
    loop.run(torch.Generator(cuda_device).manual_seed(0))
    (key,) = loop.step_fn.graphs
    nodes = loop.step_fn.kernels(key)
    assert len(nodes) > 100  # forward, recompute, backward and update, node by node
    assert loop.step_fn.launches(key) == {}  # no kernel of the repository, 3-5 included
    assert loop.step_fn.replayed == {}


@pytest.mark.needs_cuda
def test_a_new_seq_length_captures_anew(cuda_device):
    loop = _loop("smollm-135m", cuda_device, steps=3)
    state = loop.run(torch.Generator(cuda_device).manual_seed(2))
    short = {k: v[:, :16] for k, v in _batch(loop, 3).items()}
    for _ in range(3):
        state, m = loop.step_fn(state, short)
        assert np.isfinite(float(m["loss"]))
    assert len(loop.step_fn.graphs) == len(loop.step_fn.captures) == 2
    assert sorted(e.replays for e in loop.step_fn.graphs.values()) == [2, 2]
    assert int(state.step) == 6


@pytest.mark.needs_cuda
@pytest.mark.parametrize("microbatch,compress", [(0, False), (2, False), (0, True)])
def test_donated_state_is_updated_in_place(cuda_device, microbatch, compress):
    loop = _loop("smollm-135m", cuda_device, microbatch=microbatch, compress=compress)
    eager = _loop("smollm-135m", cuda_device, jit=False, microbatch=microbatch,
                  compress=compress)
    state = loop.init_or_resume(torch.Generator(cuda_device).manual_seed(3))
    want = eager.init_or_resume(torch.Generator(cuda_device).manual_seed(3))
    assert (state.ef_residual is not None) == compress
    ptrs = [t.data_ptr() for t in leaves(state)]
    for step in range(3):
        new, m = loop.step_fn(state, _batch(loop, step))
        want, w = eager.step_fn(want, _batch(eager, step))
        assert [t.data_ptr() for t in leaves(new)] == ptrs  # the same storage, updated
        assert float(m["loss"]) == pytest.approx(float(w["loss"]), rel=REL)
        state = new
    assert int(state.step) == 3
    _close(state, want, "donated", compress=compress)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("microbatch,compress", [(0, False), (2, False), (0, True)])
def test_undonated_state_is_never_written(cuda_device, microbatch, compress):
    loop = _loop("smollm-135m", cuda_device, donate=False, microbatch=microbatch,
                 compress=compress)
    eager = _loop("smollm-135m", cuda_device, jit=False, microbatch=microbatch,
                  compress=compress)
    first = loop.init_or_resume(torch.Generator(cuda_device).manual_seed(4))
    kept = [t.clone() for t in leaves(first)]
    want = eager.init_or_resume(torch.Generator(cuda_device).manual_seed(4))
    state = first
    for step in range(3):
        state, m = loop.step_fn(state, _batch(loop, step))
        want, w = eager.step_fn(want, _batch(eager, step))
        assert float(m["loss"]) == pytest.approx(float(w["loss"]), rel=REL)
        assert all(a.data_ptr() != b.data_ptr() for a, b in
                   zip(leaves(state), leaves(first), strict=True))
    # the graph's outputs, which hold until the next replay
    _close(state, want, "undonated", compress=compress)
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), kept, strict=True))
    # the caller's first state again: copied into the graph's inputs, not written
    again, _ = loop.step_fn(first, _batch(loop, 0))
    assert int(again.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), kept, strict=True))
    (entry,) = loop.step_fn.graphs.values()
    assert entry.replays == 3


@pytest.mark.needs_cuda
def test_a_host_read_in_the_step_raises_without_an_eager_retry(cuda_device):
    loop = _loop("smollm-135m", cuda_device)
    real = loop.model.loss
    calls = []

    def loss_with_host_read(params, batch):
        calls.append(int(batch["tokens"].sum().item()))  # a sync: illegal while capturing
        return real(params, batch)

    loop.model.loss = loss_with_host_read
    with pytest.raises(RuntimeError):
        loop.run(torch.Generator(cuda_device).manual_seed(5))
    assert len(calls) == 1  # the warm-up's read; the capture raised at its read
    assert not loop.step_fn.graphs and not loop.history
    torch.cuda.synchronize()
    # a fresh loop without the read captures and trains
    fresh = _loop("smollm-135m", cuda_device, steps=3)
    assert int(fresh.run(torch.Generator(cuda_device).manual_seed(5)).step) == 3


@pytest.mark.needs_cuda
def test_captured_checkpoint_resumes(cuda_device, tmp_path):
    """8 captured steps straight, against 4 captured steps, a checkpoint and
    a fresh captured loop resumed to 8: losses and params bitwise equal."""
    gen = torch.Generator(cuda_device)
    straight = _loop("smollm-135m", cuda_device, steps=8)
    state_a = straight.run(gen.manual_seed(6))
    ck = str(tmp_path / "ck")
    first = _loop("smollm-135m", cuda_device, steps=8, ckpt_dir=ck)
    first.config.total_steps = first.config.ckpt_every = 4
    first.run(gen.manual_seed(6))
    resumed = _loop("smollm-135m", cuda_device, steps=8, ckpt_dir=ck)
    state_b = resumed.run(gen.manual_seed(99))  # the checkpoint, not the generator, decides
    assert int(resumed.history[0]["step"]) == 4 and int(state_b.step) == 8
    assert isinstance(resumed.step_fn, CudaGraphStep) and len(resumed.step_fn.graphs) == 1
    for g, w in zip(resumed.history, straight.history[4:], strict=True):
        assert g["loss"] == w["loss"], g["step"]
    for a, b in zip(leaves(state_b.params), leaves(state_a.params), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)

