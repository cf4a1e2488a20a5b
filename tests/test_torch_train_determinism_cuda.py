"""The train step on the card repeats itself bit for bit, in every family.

Marked ``needs_cuda``: each test skips (inside a fixture) on a host without
a CUDA device.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_train_determinism_cuda.py

Reduced models of the six families (moonshot-v1-16b-a3b under both
``moe_impl``s, and at top-6 of 8 experts under both) at float32 on the differentiable route, with the checkpoint
recompute (``remat="full"``), as ``test_torch_train_jit_cuda.py`` runs
them.  Bitwise (``torch.equal``): the same eager steps run twice from one
state and batches; two replays of one captured step from one state, and
two captured loops from one state; and a captured run checkpointed at step
4 and resumed by a fresh captured loop to step 8, against the straight run:
every leaf of the train state, every loss and grad norm.  Run as a script
(``--audit``), the file trains every family eagerly and captured under
``torch.use_deterministic_algorithms(True)``; the audit test runs it in a
subprocess started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set before
CUDA starts, as cuBLAS needs it under the mode): no op may raise, and with
the mode's NaN-filled fresh memory every loss stays finite.  The port sets
neither the mode nor the variable itself.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._tree import leaves, tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from repro_torch.graphs import CudaGraphStep  # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step  # noqa: E402

# dense, moe (both layouts), ssm, hybrid, encdec, vlm; "+top6": the reduced
# MoE's 4 experts, top-2, made 8 experts, top-6 (moonshot's own k), since two
# rows of a token add up in either order to the same float and only three
# or more show an order
FAMILIES = ["smollm-135m", "moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b@batched",
            "moonshot-v1-16b-a3b@vmap+top6", "moonshot-v1-16b-a3b@batched+top6", "mamba2-130m",
            "recurrentgemma-2b", "seamless-m4t-large-v2", "qwen2-vl-2b"]
S, B = 32, 4  # the reduced hybrid's window is 16 and its SSM chunk 16: both bind at S = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _model(name: str, device) -> Model:
    arch, _, impl = name.partition("@")
    impl, _, top = impl.partition("+")
    cfg = get_arch(arch).reduced()
    if top:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=6))
    return Model(cfg, ExecConfig(attn_impl="xla", remat="full", moe_impl=impl or "vmap"),
                 params={}, device=device)


def _loop(name: str, device, *, jit: bool = True, donate: bool = True, steps: int = 3,
          ckpt_dir: str = "") -> TrainLoop:
    model = _model(name, device)
    return TrainLoop(model, AdamW(linear_warmup_cosine(1e-3, 1, 10)),
                     make_batch_fn(model.cfg, InputShape("t", S, B, "train"), seed=1),
                     TrainLoopConfig(total_steps=steps, ckpt_every=steps, log_every=0,
                                     ckpt_dir=ckpt_dir),
                     jit=jit, donate=donate)


def _batch(loop: TrainLoop, step: int) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=loop.model.device)
            for k, v in loop.batch_fn(step).items()}


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


def _unequal(got, want) -> list:
    """The leaves (by index) of two trees that are not bitwise equal."""
    return [i for i, (a, b) in enumerate(zip(leaves(got), leaves(want), strict=True))
            if not (a.dtype == b.dtype and torch.equal(a, b))]


def _metrics(m: dict) -> tuple:
    return float(m["loss"]), float(m["grad_norm"])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_eager_steps_repeat_bitwise(cuda_device, name):
    loop = _loop(name, cuda_device, jit=False)
    step = make_train_step(loop.model, loop.optimizer)
    first = loop.init_or_resume(torch.Generator(cuda_device).manual_seed(0))
    runs = []
    for _ in range(2):
        state, seen = first, []
        for i in range(3):
            state, m = step(state, _batch(loop, i))
            seen.append(_metrics(m))
        runs.append((state, seen))
    (a, ma), (b, mb) = runs
    assert ma == mb
    assert _unequal(a, b) == [], name
    assert int(a.step) == 3


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_captured_steps_repeat_bitwise(cuda_device, name):
    gen = torch.Generator(cuda_device)
    # two replays of one graph from one state (undonated: the caller's state is never written)
    loop = _loop(name, cuda_device, donate=False)
    first = loop.init_or_resume(gen.manual_seed(1))
    batch = _batch(loop, 0)
    loop.step_fn(first, batch)  # the warm-up and the capture
    r1, m1 = loop.step_fn(first, batch)
    r1, m1 = _clone(r1), _metrics(m1)  # the graph's outputs hold until the next replay
    r2, m2 = loop.step_fn(first, batch)
    (entry,) = loop.step_fn.graphs.values()
    assert entry.replays == 2
    assert m1 == _metrics(m2) and _unequal(r1, r2) == [], name
    # two captured loops (each its own graph) from one state, over the donated state
    loops = [_loop(name, cuda_device) for _ in range(2)]
    start = loops[0].init_or_resume(gen.manual_seed(2))
    ends = []
    for lp in loops:
        assert isinstance(lp.step_fn, CudaGraphStep)
        state, seen = _clone(start), []
        for i in range(3):
            state, m = lp.step_fn(state, _batch(lp, i))
            seen.append(_metrics(m))
        ends.append((state, seen))
    assert ends[0][1] == ends[1][1]
    assert _unequal(ends[0][0], ends[1][0]) == [], name


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_captured_resume_is_bitwise(cuda_device, name, tmp_path):
    gen = torch.Generator(cuda_device)
    straight = _loop(name, cuda_device, steps=8)
    state_a = straight.run(gen.manual_seed(6))
    ck = str(tmp_path / "ck")
    first = _loop(name, cuda_device, steps=8, ckpt_dir=ck)
    first.config.total_steps = first.config.ckpt_every = 4
    first.run(gen.manual_seed(6))
    resumed = _loop(name, cuda_device, steps=8, ckpt_dir=ck)
    state_b = resumed.run(gen.manual_seed(99))  # the checkpoint, not the generator, decides
    assert int(resumed.history[0]["step"]) == 4 and int(state_b.step) == 8
    assert isinstance(resumed.step_fn, CudaGraphStep) and len(resumed.step_fn.graphs) == 1
    for g, w in zip(resumed.history, straight.history[4:], strict=True):
        assert (g["loss"], g["grad_norm"]) == (w["loss"], w["grad_norm"]), g["step"]
    assert _unequal(state_b, state_a) == [], name


@pytest.fixture(scope="module")
def mode_audit():
    """The ``--audit`` run of this file, once for all families."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    done = subprocess.run([sys.executable, __file__, "--audit", *FAMILIES], env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_steps_run_under_the_deterministic_mode(mode_audit, name):
    rec = mode_audit[name]
    assert rec["error"] is None, rec["error"]
    assert rec["mode"] and rec["cublas_workspace"] == ":4096:8"
    assert rec["captured"] and len(rec["losses"]) == 5
    assert np.isfinite(rec["losses"]).all() and np.isfinite(rec["grad_norms"]).all()


def audit(names: list, device: str = "cuda") -> dict:
    """Under ``torch.use_deterministic_algorithms(True)`` (errors, not
    warnings): two eager steps and three captured ones (warm-up and
    capture, two replays) of each family; the first error an op raised,
    or the losses and grad norms."""
    torch.use_deterministic_algorithms(True)
    device = torch.device(device)
    out = {}
    for name in names:
        rec = {"mode": torch.are_deterministic_algorithms_enabled(),
               "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
               "error": None, "losses": [], "grad_norms": [], "captured": False}
        try:
            eager = _loop(name, device, jit=False)
            step = make_train_step(eager.model, eager.optimizer)
            state = eager.init_or_resume(torch.Generator(device).manual_seed(3))
            for i in range(2):
                state, m = step(state, _batch(eager, i))
                rec["losses"].append(float(m["loss"]))
                rec["grad_norms"].append(float(m["grad_norm"]))
            captured = _loop(name, device)
            rec["captured"] = isinstance(captured.step_fn, CudaGraphStep)
            for i in range(2, 5):
                state, m = captured.step_fn(state, _batch(captured, i))
                rec["losses"].append(float(m["loss"]))
                rec["grad_norms"].append(float(m["grad_norm"]))
        except RuntimeError as e:  # the op the mode refused, reported by family
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        out[name] = rec
    return out


if __name__ == "__main__" and sys.argv[1:2] == ["--audit"]:
    print(json.dumps(audit(sys.argv[2:])))
