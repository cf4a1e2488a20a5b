"""The latent decode kernel (kernel 7, ``csrc/mla_decode.cu``) against
``mla_decode_plain``, its plain route, on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_mla_decode_cuda.py

The tolerances are kernel 6's rule (``test_torch_decode_attention_cuda``):
the kernel computes the plain route's function with its sums in another
order (split-K partials merged, the dots over lanes), so at float32 it is
held to 2e-5; at bfloat16 to the plain route run at float32 on the same
operands, within half a bfloat16 unit of its magnitude (2**-8) and 2e-5.
What must be exact is exact: an int and a tensor length, two launches,
and a captured graph's replays against eager calls, bit for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.kernels.mla_decode import mla_decode_cuda, mla_decode_plain, mla_plan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

F32_TOL = 2e-5
DTYPES = [pytest.param(torch.bfloat16, id="bf16"), pytest.param(torch.float32, id="f32")]
# B, H, T: the benchmark's moonlight-chat-decode (64 rows, 16 heads, a 768-slot cache)
CELL = (64, 16, 768)
SCALE = 192 ** -0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(B, H, T, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, H, 576), (B, T, 512), (B, T, 64))]


def _check(got, q, c, kr, kv_len):
    if q.dtype == torch.float32:
        want = mla_decode_plain(q, c, kr, kv_len=kv_len, scale=SCALE)
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        want = mla_decode_plain(q.float(), c.float(), kr.float(), kv_len=kv_len, scale=SCALE)
        torch.testing.assert_close(got.float(), want, atol=F32_TOL, rtol=2.0**-8)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fill", [1, CELL[2] // 2 + 3, CELL[2]])
def test_kernel_matches_plain_at_the_cells_shape(cuda_device, dtype, fill):
    """At fills 1, middle and last (the whole cache), one launch each."""
    q, c, kr = _inputs(*CELL, dtype, cuda_device)
    before = counts.read()["mla_decode"]
    got = mla_decode_cuda(q, c, kr, kv_len=fill, scale=SCALE)
    assert counts.read()["mla_decode"] - before == 1
    assert got.shape == (CELL[0], CELL[1], 512) and got.dtype == dtype
    _check(got, q, c, kr, fill)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T", [(1, 37), (3, 1), (5, 300)])
def test_kernel_every_head_count_and_split(cuda_device, dtype, B, T):
    """The one head count the kernel is built for (16), one split and many,
    a length at a tile's edge and past it (16 and 32 keys), and a length
    past T clamped."""
    q, c, kr = _inputs(B, 16, T, dtype, cuda_device, seed=16 + T)
    for fill in sorted({1, min(T, 16), min(T, 17), min(T, 32), min(T, 33), T, T + 5}):
        _check(mla_decode_cuda(q, c, kr, kv_len=fill, scale=SCALE), q, c, kr, fill)


@pytest.mark.needs_cuda
def test_an_int_and_a_tensor_length_and_two_launches_are_bitwise_equal(cuda_device):
    q, c, kr = _inputs(*CELL, torch.bfloat16, cuda_device)
    a = mla_decode_cuda(q, c, kr, kv_len=400, scale=SCALE)
    b = mla_decode_cuda(q, c, kr, kv_len=400, scale=SCALE)
    for t in (torch.tensor(400, device=cuda_device, dtype=torch.int32),
              torch.tensor(400, device=cuda_device)):
        assert torch.equal(mla_decode_cuda(q, c, kr, kv_len=t, scale=SCALE), a)
    assert torch.equal(a, b)
    assert mla_plan(*CELL, torch.bfloat16).splits > 1  # the merge ran


@pytest.mark.needs_cuda
def test_a_captured_launch_replays_at_every_length_as_eager_calls(cuda_device):
    q, c, kr = _inputs(*CELL, torch.bfloat16, cuda_device)
    n = torch.ones((), dtype=torch.int32, device=cuda_device)
    mla_decode_cuda(q, c, kr, kv_len=n, scale=SCALE)  # the library loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mla_decode_cuda(q, c, kr, kv_len=n, scale=SCALE)
    for fill in (1, 17, 500, 768):
        n.fill_(fill)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, mla_decode_cuda(q, c, kr, kv_len=fill, scale=SCALE))


@pytest.mark.needs_cuda
def test_the_kernel_refuses_what_it_does_not_take(cuda_device):
    q, c, kr = _inputs(2, 16, 32, torch.bfloat16, cuda_device)
    for heads in (4, 8, 12, 32):
        with pytest.raises(ValueError, match="query heads"):
            qh = torch.zeros((2, heads, 576), dtype=q.dtype, device=q.device)
            mla_decode_cuda(qh, c, kr, kv_len=4, scale=SCALE)
    with pytest.raises(ValueError, match="built for"):
        mla_decode_cuda(q[..., :544].contiguous(), c[..., :480].contiguous(), kr, kv_len=4,
                        scale=SCALE)
    with pytest.raises(TypeError, match="share a type"):
        mla_decode_cuda(q, c.float(), kr, kv_len=4, scale=SCALE)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mla_decode_cuda(q.half(), c.half(), kr.half(), kv_len=4, scale=SCALE)
    with pytest.raises(ValueError, match="at least its own key"):
        mla_decode_cuda(q, c, kr, kv_len=0, scale=SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        mla_decode_cuda(q, c.transpose(0, 1).contiguous().transpose(0, 1), kr, kv_len=4,
                        scale=SCALE)


def _small_moonlight():
    """Moonlight's 27 layers and its attention widths (the kernel's), the
    rest cut small enough to build on the card in seconds."""
    full = get_arch("moonlight-16b-a3b")
    moe = dataclasses.replace(full.moe, n_experts=8, top_k=2)
    return dataclasses.replace(full, name="moonlight-small", d_model=256, d_ff=64, vocab=1024,
                               dense_d_ff=128, moe=moe)


@pytest.mark.needs_cuda
def test_a_moonlight_decode_replay_launches_the_kernel_in_all_27_layers(cuda_device):
    cfg = _small_moonlight()
    model = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(0),
                  device=cuda_device, dtype=torch.bfloat16)
    engine = ServeEngine(model, ServeConfig(max_len=40), jit=True)
    tokens = torch.randint(0, cfg.vocab, (4, 20), device=cuda_device, dtype=torch.int32)
    engine.generate({"tokens": tokens}, 5)
    (key,) = [k for k in engine._decode.graphs]
    assert engine._decode.launches(key) == {"mla_decode": 27, "rotary": 27}


@pytest.mark.needs_cuda
def test_a_one_token_moonlight_prefill_takes_the_decode_kernel_at_its_scale(cuda_device):
    """A one-token prompt's prefill is a query of one position: the flash
    route sends it to the decode kernel (kernel 6) at the padded head width
    256 with latent attention's scale, 1 / sqrt(192); float32 on the card
    against the CPU model on the same weights."""
    cfg = dataclasses.replace(_small_moonlight(), dtype="float32")
    model = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device)
    cpu = Model(cfg, params={k: v for k, v in model.params.items()}, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 1), dtype=torch.int32)
    before = counts.read()["decode_attention"]
    got = model.forward({"tokens": tokens.to(cuda_device)})
    assert counts.read()["decode_attention"] - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), cpu.forward({"tokens": tokens}), atol=1e-4, rtol=1e-4)
