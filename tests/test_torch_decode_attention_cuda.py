"""The decode-attention kernel (``csrc/decode_attention.cu``) against
``chunked_attention``, the plain route it replaces, on the card.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_decode_attention_cuda.py

The kernel computes ``chunked_attention``'s function at S == 1 with its
sums in another order (split-K partials merged, the dot products over
lanes).  At float32 it is held to the kernel tests' tolerance, 2e-5.  At
bfloat16 it is held to the plain route run at float32 on the same
operands (which the plain route's bfloat16 result is, rounded once): the
kernel rounds its float32 result to bfloat16 once, so it lies within half
a bfloat16 unit of it, at most 2**-8 of its magnitude, plus 2e-5 for the
float32 sums' order.  Under ``p_dtype="bfloat16"`` p is rounded to
bfloat16 after a split's own running max rather than the row's, so a p
can land one bfloat16 unit from the plain route's: 2e-2 there at either
type.  What must be exact is exact: an int and a tensor position, two
launches, and a captured graph's replays against eager calls, each bit
for bit.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import counts, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_plan  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.kernels.ref import chunked_attention  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

F32_TOL = 2e-5
DTYPES = [pytest.param(torch.bfloat16, id="bf16"), pytest.param(torch.float32, id="f32")]

# B, H, K, T, hd: the benchmark's cells (qwen2-vl-2b decode, 256 rows at a
# 768-slot cache; 16 pages at 8200)
CELLS = {"chat": (256, 12, 2, 768, 128), "doc": (16, 12, 2, 8200, 128)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _qkv(B, H, K, T, hd, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, 1, H, hd), (B, T, K, hd), (B, T, K, hd))]


def _plain(q, k, v, **kw):
    """The plain route at S == 1: one chunk of T keys, as decode scores it."""
    return chunked_attention(q, k, v, kv_chunk=k.shape[1], **kw)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _check(got, q, k, v, **kw):
    """``got`` against the plain route on the same operands: at float32
    within 2e-5; at bfloat16 against the plain route's float32 result,
    within half a bfloat16 unit of it (2**-8 of its magnitude) and 2e-5."""
    if q.dtype == torch.float32:
        _close(got, _plain(q, k, v, **kw), F32_TOL)
    else:
        want = _plain(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(got.float(), want, atol=F32_TOL, rtol=2.0**-8)


def _fills(T):
    return {"first": 0, "middle": T // 2 + 3, "last": T - 1}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("fill", ["first", "middle", "last"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", list(CELLS))
def test_decode_kernel_matches_plain_at_the_cells_shapes(cuda_device, cell, dtype, fill):
    """Causal at a position with the cache filled to it, the position an
    int and a 0-d int32 tensor on the card: bitwise equal to each other,
    each one launch, and the plain route's result within tolerance."""
    B, H, K, T, hd = CELLS[cell]
    q, k, v = _qkv(B, H, K, T, hd, dtype, cuda_device, seed=T)
    pos = _fills(T)[fill]
    before = decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, q_offset=pos, kv_len=pos + 1)
    idx = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    got_t = ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, got_t)
    _check(got, q, k, v, q_offset=pos, kv_len=pos + 1)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 6, 7, 8, 12])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_every_head_dim_and_group(cuda_device, dtype, hd, group):
    """Every width the kernel is built for, at one to eight query heads a
    kv head (each a build of the kernel) and twelve (two blocks of six); an
    int64 position tensor; fills at three points of a cache that no tile
    length divides."""
    B, K, T = 3, 2, 333
    q, k, v = _qkv(B, K * group, K, T, hd, dtype, cuda_device, seed=hd + group)
    for pos in _fills(T).values():
        idx = torch.tensor(pos, dtype=torch.int64, device=cuda_device)
        got = ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1)
        _check(got, q, k, v, q_offset=pos, kv_len=pos + 1)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_with_a_sliding_window(cuda_device, dtype):
    """recurrentgemma-2b's local attention at one query position (10 query
    heads on one kv head of 256: two blocks of 5), its 2048 window binding
    at late positions, and a short window over a short cache."""
    q, k, v = _qkv(2, 10, 1, 4096, 256, dtype, cuda_device, seed=4)
    for pos, length in ((100, 101), (3000, 3001), (4095, None)):
        got = ops.decode_attention(q, k, v, q_offset=pos, kv_len=length, window=2048)
        _check(got, q, k, v, q_offset=pos, kv_len=length, window=2048)
    q, k, v = _qkv(3, 6, 2, 200, 64, dtype, cuda_device, seed=5)
    idx = torch.tensor(150, dtype=torch.int32, device=cuda_device)
    got = ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1, window=17)
    _check(got, q, k, v, q_offset=150, kv_len=151, window=17)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_non_causal_cross_attention(cuda_device, dtype):
    """seamless-m4t's decode-time cross-attention: one query against every
    encoder frame, no mask (16 heads of 64, one a kv head)."""
    q, k, v = _qkv(4, 16, 16, 1000, 64, dtype, cuda_device, seed=6)
    got = ops.decode_attention(q, k, v, causal=False)
    _check(got, q, k, v, causal=False)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_rounds_p_and_v_to_bf16_under_that_p_dtype(cuda_device, dtype):
    B, H, K, T, hd = 8, 12, 2, 768, 128
    q, k, v = _qkv(B, H, K, T, hd, dtype, cuda_device, seed=7)
    for pos in (0, 600):
        kw = dict(q_offset=pos, kv_len=pos + 1, p_dtype="bfloat16")
        got = ops.decode_attention(q, k, v, **kw)
        _close(got, _plain(q, k, v, **kw), 2e-2)
        # and not the float32 route's result: the rounding shows at float32
        if dtype == torch.float32 and pos:
            assert not torch.equal(got, ops.decode_attention(q, k, v, q_offset=pos,
                                                             kv_len=pos + 1))


@pytest.mark.needs_cuda
def test_decode_kernel_with_no_live_key_averages_the_cache_as_plain_does(cuda_device):
    q, k, v = _qkv(2, 4, 2, 300, 64, torch.float32, cuda_device, seed=8)
    got = ops.decode_attention(q, k, v, q_offset=5, kv_len=0)
    _check(got, q, k, v, q_offset=5, kv_len=0)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_two_launches_are_bitwise_equal(cuda_device, cell):
    """The splits' partials merge in a fixed order: no atomics, no race."""
    B, H, K, T, hd = CELLS[cell]
    q, k, v = _qkv(B, H, K, T, hd, torch.bfloat16, cuda_device, seed=9)
    assert decode_plan(B, H, K, T, hd, torch.bfloat16).splits > 1
    a = ops.decode_attention(q, k, v, q_offset=T - 5, kv_len=T - 4)
    b = ops.decode_attention(q, k, v, q_offset=T - 5, kv_len=T - 4)
    assert torch.equal(a, b)


@pytest.mark.needs_cuda
def test_a_captured_decode_replays_at_every_position_as_eager_calls(cuda_device):
    """One graph of a decode attention at a 0-d position tensor, replayed
    over many positions (the position filled between replays), equals an
    eager call at each int position bit for bit: the kernel reads the live
    length on the card, and no split count follows the position."""
    B, H, K, T, hd = CELLS["chat"]
    q, k, v = _qkv(B, H, K, T, hd, torch.bfloat16, cuda_device, seed=10)
    idx = torch.zeros((), dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1)  # warm-up: the build
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, q_offset=idx, kv_len=idx + 1)
    for pos in (0, 1, 31, 32, 255, 256, 257, 511, 512, 600, 767):
        idx.fill_(pos)
        graph.replay()
        want = ops.decode_attention(q, k, v, q_offset=pos, kv_len=pos + 1)
        torch.cuda.synchronize()
        assert torch.equal(out, want), pos


@pytest.mark.needs_cuda
@pytest.mark.parametrize("unroll", [False, True], ids=["whole", "unroll"])
@pytest.mark.parametrize("position", ["int", "tensor"])
def test_a_cached_decode_step_runs_the_kernel_under_every_knob(cuda_device, position, unroll):
    """On CUDA tensors a decode step's attention against its cache is
    kernel 6 (one launch) at an int and at a tensor position, with
    ``unroll_causal`` on or off: the kernel reads the filled keys alone,
    so no knob sends it to the plain route."""
    from repro_torch.models import ExecConfig, transformer

    q, k, v = _qkv(2, 6, 2, 96, 64, torch.bfloat16, cuda_device, seed=11)
    idx = 40 if position == "int" else torch.tensor(40, dtype=torch.int32, device=cuda_device)
    before = decode_attention_cuda.launches
    got = transformer._cached_attention(ExecConfig(unroll_causal=unroll, kv_chunk=32), q, k, v,
                                        idx)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert torch.equal(got, ops.decode_attention(q, k, v, q_offset=40, kv_len=41))


@pytest.mark.needs_cuda
def test_the_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(2, 4, 2, 64, 48, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, k, v, q_offset=3, kv_len=4)
    q, k, v = _qkv(2, 4, 2, 64, 64, torch.float16, cuda_device)
    with pytest.raises(TypeError, match="float16"):
        ops.decode_attention(q, k, v, q_offset=3, kv_len=4)
    q, k, v = _qkv(2, 4, 2, 64, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="p_dtype"):
        ops.decode_attention(q, k, v, q_offset=3, kv_len=4, p_dtype="float16")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q.requires_grad_(), k, v, q_offset=3, kv_len=4)


@pytest.mark.needs_cuda
def test_a_qwen2vl_decode_graph_launches_the_kernel_in_all_28_layers(cuda_device):
    """qwen2-vl-2b at its published widths and depth: the captured decode
    step's graph holds one decode-attention launch a layer (its kernel
    nodes), and the captured engine's tokens are the eager engine's."""
    cfg = get_arch("qwen2-vl-2b")
    model = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(0),
                  device=cuda_device, dtype=torch.bfloat16)
    B, P, n_text = 2, 4, 12
    g = torch.Generator(cuda_device).manual_seed(1)
    positions = torch.cat([torch.zeros(P, 3, dtype=torch.int32),
                           (P + torch.arange(n_text, dtype=torch.int32))[:, None].repeat(1, 3)])
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, n_text), generator=g, device=cuda_device,
                                     dtype=torch.int32),
             "patch_embeds": torch.randn((B, P, cfg.d_model), generator=g, device=cuda_device),
             "positions": positions[None].repeat(B, 1, 1).to(cuda_device)}
    engine = ServeEngine(model, ServeConfig(max_len=P + n_text + 6))
    before = counts.read()
    tokens = engine.generate(batch, 6)
    # the eager warm-up of the decode step, one launch a layer; the capture takes its back
    assert counts.delta(counts.read(), before)["decode_attention"] == cfg.n_layers == 28
    (key,) = engine._decode.graphs
    assert engine._decode.launches(key) == {"decode_attention": 28, "rotary": 28}
    assert engine._decode.replayed == {"decode_attention": 28 * 4, "rotary": 28 * 4}
    eager = ServeEngine(model, ServeConfig(max_len=P + n_text + 6), jit=False)
    assert torch.equal(tokens, eager.generate(batch, 6))
