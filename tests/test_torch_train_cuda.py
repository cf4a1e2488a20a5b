"""The port's training path on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_train_cuda.py

The kernels have no backward: each ``*_cuda`` wrapper refuses inputs that
require grad under grad mode and runs under ``torch.no_grad()``.  Training
takes the differentiable ``attn_impl="xla"`` route, launches no kernel,
and one step of each reduced family at float32 on the card equals the
CPU's within 1e-4.  A checkpoint of card tensors restores on the CPU bit
for bit.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch._tree import leaves, tree_map  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain  # noqa: E402
from repro_torch.launch.train import build_loop  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402

FAMILY_ARCHS = ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-2b",
                "seamless-m4t-large-v2", "qwen2-vl-2b"]
KERNELS = {  # wrapper, plain version, input shapes, keywords
    "flash_attention": (flash_attention_cuda, flash_attention_plain,
                        ((2, 64, 4, 64), (2, 64, 2, 64), (2, 64, 2, 64)), {}),
    "ssd_scan": (ssd_scan_cuda, ssd_scan_plain,
                 ((2, 64, 4, 16), (2, 64, 4), (4,), (2, 64, 1, 16), (2, 64, 1, 16), (4,)),
                 {"chunk": 16}),
    "rglru_scan": (rglru_scan_cuda, rglru_scan_plain,
                   ((2, 64, 64), (2, 64, 64), (2, 64, 64), (64,)), {}),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(name, shapes, device, requires_grad):
    gen = torch.Generator().manual_seed(0)
    out = [torch.randn(s, generator=gen) for s in shapes]
    if name == "ssd_scan":  # dt > 0, A < 0
        out[1], out[2] = out[1].abs() * 0.1, -out[2].abs()
    return [t.to(device).requires_grad_(requires_grad) for t in out]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_wrappers_raise_under_grad_and_run_without(cuda_device, name):
    kernel, plain, shapes, kw = KERNELS[name]
    before = kernel.launches
    with pytest.raises(RuntimeError, match='attn_impl="xla"'):
        kernel(*_inputs(name, shapes, cuda_device, True), **kw)
    assert kernel.launches == before
    args = _inputs(name, shapes, cuda_device, True)
    with torch.no_grad():
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _batch(cfg, device, step=0) -> dict:
    raw = make_batch_fn(cfg, InputShape("t", 32, 2, "train"), seed=1)(step)
    return {k: torch.as_tensor(v.copy(), device=device) for k, v in raw.items()}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_one_step_on_the_card_equals_the_cpu(cuda_device, name):
    """Reduced model, float32, AdamW: the same weights and batch on both
    devices give losses, grad norms and updated leaves within 1e-4 (of
    each leaf's largest magnitude); no kernel is launched."""
    cfg = get_arch(name).reduced()
    ex = ExecConfig(attn_impl="xla", remat="full")
    cpu_model = Model(cfg, ex, params={}, device="cpu")
    gpu_model = Model(cfg, ex, params={}, device=cuda_device)
    opt = AdamW(linear_warmup_cosine(1e-3, 1, 10))
    cpu_state = init_train_state(cpu_model, opt, torch.Generator().manual_seed(0))
    gpu_state = tree_map(lambda t: t.to(cuda_device), cpu_state)
    counts = [k.launches for k, *_ in KERNELS.values()]
    cpu_state, cpu_m = make_train_step(cpu_model, opt)(cpu_state, _batch(cfg, "cpu"))
    gpu_state, gpu_m = make_train_step(gpu_model, opt)(gpu_state, _batch(cfg, cuda_device))
    assert [k.launches for k, *_ in KERNELS.values()] == counts
    for key in ("loss", "grad_norm", "ce"):
        assert float(gpu_m[key]) == pytest.approx(float(cpu_m[key]), rel=1e-4), key
    for a, b in zip(leaves(gpu_state), leaves(cpu_state), strict=True):
        scale = max(float(b.abs().max()), 1e-30) if b.is_floating_point() else 0
        torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=0)


@pytest.mark.needs_cuda
def test_card_checkpoint_restores_on_the_cpu(cuda_device, tmp_path):
    gen = torch.Generator(cuda_device).manual_seed(3)
    params = {"w": torch.randn((4, 3), generator=gen, device=cuda_device),
              "s": torch.randn((3,), generator=gen, device=cuda_device).to(torch.bfloat16)}
    state = TrainState(params=params, opt_state=AdamW().init(params),
                       step=torch.tensor(9, dtype=torch.int32, device=cuda_device))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, state)
    mgr.wait()
    like = tree_map(lambda t: torch.zeros_like(t, device="cpu"), state)
    restored, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta["step"] == 9
    for a, b in zip(leaves(restored), leaves(state), strict=True):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b.cpu())


@pytest.mark.needs_cuda
def test_build_loop_trains_on_the_card_without_kernels(cuda_device, tmp_path):
    loop, _ = build_loop("recurrentgemma-2b", steps=6, seq_len=32, batch=2, lr=3e-3,
                         ckpt_dir=str(tmp_path), log_every=0, device=cuda_device)
    counts = [k.launches for k, *_ in KERNELS.values()]
    state = loop.run(torch.Generator(cuda_device).manual_seed(0))
    assert [k.launches for k, *_ in KERNELS.values()] == counts
    assert int(state.step) == 6 and all(torch.isfinite(torch.tensor(h["loss"]))
                                        for h in loop.history)
    assert leaves(state.params)[0].device.type == "cuda"
