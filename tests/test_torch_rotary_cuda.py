"""The rotary kernel (kernel 8, ``csrc/rotary.cu``) against
``rotary_plain``, its plain route (``layers.apply_rope`` /
``apply_mrope``), on the card, at every caller's shape.

Marked ``needs_cuda``: each test skips (inside the test, through the
``cuda_device`` fixture) on a host without a CUDA device.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m needs_cuda tests/test_torch_rotary_cuda.py

The kernel computes the plain route's function with its roundings in the
same places (the frequencies, the angles and the rotation in float32, one
rounding to the input's type).  At float32 it is held to the plain route
within 1e-6 relative (and 1e-6 absolute, for elements near 0).  At
bfloat16 it is held to the plain route run at float32 on the same
operands, within half a bfloat16 unit of its magnitude (2**-8) and 2e-5,
kernel 6's rule; the count of bfloat16 elements that differ from the plain
route's bfloat16 output is printed (``-s``).  What must be exact is exact:
int32 and int64 positions, and a captured graph's replays against eager
calls, bit for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import counts, ops  # noqa: E402
from repro_torch.kernels.rotary import rotary_cuda, rotary_plain  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402

DTYPES = [pytest.param(torch.bfloat16, id="bf16"), pytest.param(torch.float32, id="f32")]
QWEN = dict(theta=1e6, sections=(16, 24, 24))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _qk(B, S, Hq, Hk, D, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.randn((B, S, Hq, D), generator=g, device=device).to(dtype),
            torch.randn((B, S, Hk, D), generator=g, device=device).to(dtype))


def _image_positions(B, grid_h, grid_w, n_text, device):
    """Qwen2-VL's (t, h, w) ids of a grid of merged patches, (0, r, c),
    then text: the text after the image starts at grid_h * grid_w and runs
    in all three streams, so the last position is S - 1."""
    r, c = torch.meshgrid(torch.arange(grid_h), torch.arange(grid_w), indexing="ij")
    patches = torch.stack([torch.zeros_like(r), r, c], dim=-1).reshape(-1, 3)
    n = grid_h * grid_w
    text = (n + torch.arange(n_text))[:, None].expand(n_text, 3)
    return torch.cat([patches, text])[None].expand(B, -1, -1).contiguous().to(device)


def _check(got, q, k, pos, theta, sections, what=""):
    """``got`` (q, k) from the kernel against the plain route on the inputs
    ``q``, ``k`` as they were; returns the count of bfloat16 elements that
    differ from the plain route's bfloat16 output."""
    if q.dtype == torch.float32:
        for g, w in zip(got, rotary_plain(q, k, pos, theta, sections), strict=True):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
        return 0
    want32 = rotary_plain(q.float(), k.float(), pos, theta, sections)
    for g, w in zip(got, want32, strict=True):
        torch.testing.assert_close(g.float(), w, atol=2e-5, rtol=2.0**-8)
    want = rotary_plain(q, k, pos, theta, sections)
    differ = sum(int((g != w).sum()) for g, w in zip(got, want, strict=True))
    total = sum(g.numel() for g in got)
    print(f"rotary {what}: {differ} of {total} bf16 elements differ from the plain route's")
    return differ


def _rotate(q, k, pos, theta, sections):
    """One launch on copies of q and k; the kernel rotates them in place."""
    qc, kc = q.clone(), k.clone()
    before = counts.read()["rotary"]
    got = rotary_cuda(qc, kc, pos, theta, sections)
    assert counts.read()["rotary"] - before == 1
    assert got[0] is qc and got[1] is kc
    return got


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_mrope_at_qwen2vls_prefill_with_image_streams(cuda_device, dtype):
    """Head dim 128, sections (16, 24, 24), 12 query and 2 kv heads: a
    64 x 32 patch grid then text to position 8199."""
    pos = _image_positions(2, 64, 32, 8200 - 64 * 32, cuda_device)
    q, k = _qk(2, 8200, 12, 2, 128, dtype, cuda_device)
    got = _rotate(q, k, pos, **QWEN)
    _check(got, q, k, pos, **QWEN, what=f"M-RoPE prefill {dtype}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,Hq,Hk,theta", [(64, 9, 3, 1e4), (128, 16, 16, 5e4),
                                           (256, 10, 1, 1e4)],
                         ids=["smollm-64", "moonshot-128", "recurrentgemma-256"])
def test_rope_at_every_width(cuda_device, dtype, D, Hq, Hk, theta):
    """RoPE at 64, 128 and 256, positions from 7176 to 8199."""
    S = 1024
    pos = (8200 - S + torch.arange(S, device=cuda_device))[None].expand(3, S)
    q, k = _qk(3, S, Hq, Hk, D, dtype, cuda_device, seed=D)
    got = _rotate(q, k, pos, theta, None)
    _check(got, q, k, pos, theta, None, what=f"RoPE {D} {dtype}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 256])
def test_latent_attentions_strided_rope_columns(cuda_device, dtype, S):
    """Latent attention's 64-wide rope columns where they lie: q (B, S, 16,
    192)[..., 128:] (a row every 16 x 192) and the latent product's
    (B, S, 576)[:, :, None, 512:] (a row every 576); the other columns are
    untouched."""
    g = torch.Generator(cuda_device).manual_seed(5)
    q = torch.randn((4, S, 16, 192), generator=g, device=cuda_device).to(dtype)
    kv = torch.randn((4, S, 576), generator=g, device=cuda_device).to(dtype)
    pos = (700 + torch.arange(S, device=cuda_device))[None].expand(4, S)
    q0, kv0 = q.clone(), kv.clone()
    got = rotary_cuda(q[..., 128:], kv[:, :, None, 512:], pos, 5e4, None)
    assert torch.equal(q[..., :128], q0[..., :128]) and torch.equal(kv[..., :512], kv0[..., :512])
    assert torch.equal(got[0], q[..., 128:]) and torch.equal(got[1], kv[:, :, None, 512:])
    _check(got, q0[..., 128:], kv0[:, :, None, 512:], pos, 5e4, None,
           what=f"latent rope S {S} {dtype}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_element_loads_where_16_bytes_do_not_fit(cuda_device, dtype):
    """A half width of 4 (the reduced latent model's) and rows that start
    off 16 bytes take the one-element path, with the same result."""
    q, k = _qk(2, 9, 4, 1, 8, dtype, cuda_device)
    pos = torch.arange(9, device=cuda_device)[None].expand(2, 9)
    _check(_rotate(q, k, pos, 1e4, None), q, k, pos, 1e4, None, what="half 4")
    wide = torch.randn((2, 9, 4, 130), device=cuda_device).to(dtype)
    q, k = wide[..., 2:], wide[:, :, :2, 2:].contiguous()  # q's rows start off 16 bytes
    want = _rotate(q.contiguous(), k, pos, 1e4, None)  # 16-byte loads
    got = rotary_cuda(q, k.clone(), pos, 1e4, None)  # element loads, in place in wide
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(wide[..., 2:], want[0])


@pytest.mark.needs_cuda
def test_int32_and_int64_positions_are_bitwise_equal(cuda_device):
    pos = _image_positions(2, 8, 8, 100, cuda_device)
    q, k = _qk(2, pos.shape[1], 12, 2, 128, torch.bfloat16, cuda_device)
    a = _rotate(q, k, pos, **QWEN)
    b = _rotate(q, k, pos.to(torch.int32), **QWEN)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sections", [None, QWEN["sections"]], ids=["rope", "mrope"])
def test_a_captured_decode_launch_replays_at_every_position(cuda_device, dtype, sections):
    """A decode step's q (256, 1, 12, 128) and k (256, 1, 2, 128) at a 0-d
    position tensor expanded to (B, 1) or (B, 1, 3), as the engine's
    captured step holds it: each replay equals an eager call at that
    position bit for bit, and the plain route within tolerance."""
    B = 256
    idx = torch.zeros((), dtype=torch.long, device=cuda_device)
    shape = (B, 1) if sections is None else (B, 1, 3)
    pos = idx.expand(shape)
    q, k = _qk(B, 1, 12, 2, 128, dtype, cuda_device, seed=7)
    qs, ks = q.clone(), k.clone()
    rotary_cuda(qs, ks, pos, 1e6, sections)  # the library loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        qs.copy_(q)
        ks.copy_(k)
        out = rotary_cuda(qs, ks, pos, 1e6, sections)
    for at in (0, 511, 767, 8199):
        idx.fill_(at)
        graph.replay()
        torch.cuda.synchronize()
        want = torch.full(shape, at, dtype=torch.long, device=cuda_device)
        eager = _rotate(q, k, want, 1e6, sections)
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        _check(out, q, k, want, 1e6, sections, what=f"decode at {at} {dtype}")


def _small(name):
    """The arch's depth and attention widths (the kernel's shapes), the
    rest cut small enough to build on the card in seconds."""
    full = get_arch(name)
    if full.mla:
        moe = dataclasses.replace(full.moe, n_experts=8, top_k=2)
        return dataclasses.replace(full, name="moonlight-small", d_model=256, d_ff=64,
                                   vocab=1024, dense_d_ff=128, moe=moe, dtype="float32")
    return dataclasses.replace(full, name="qwen2-vl-small", d_model=256, d_ff=256, vocab=1024,
                               dtype="float32")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["qwen2-vl-2b", "moonlight-16b-a3b"])
def test_a_models_kernel_route_matches_its_plain_route(cuda_device, name):
    """Every layer's q and k through the kernel (``attn_impl="pallas"``),
    against the plain route (``"xla"``, which also runs attention in plain
    ops) on the same float32 weights: the prefill's logits and a decode
    step's, with one launch a layer each (M-RoPE with distinct streams;
    latent attention's rope columns rotated in place)."""
    cfg = _small(name)
    kernel = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(0), device=cuda_device)
    plain = Model(cfg, ExecConfig(attn_impl="xla"), params=kernel.params, device=cuda_device)
    B, S = 2, 40
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), device=cuda_device,
                                     generator=torch.Generator(cuda_device).manual_seed(1))}
    if cfg.rope == "mrope":
        batch["positions"] = _image_positions(B, 4, 6, S - 24, cuda_device)
    before = counts.read()["rotary"]
    (got_last, got_state), want = kernel.prefill(batch), plain.prefill(batch)
    assert counts.read()["rotary"] - before == cfg.n_layers
    torch.testing.assert_close(got_last, want[0], atol=1e-4, rtol=1e-4)
    from repro_torch.serve.engine import _pad_cache_to

    tok = torch.argmax(got_last, -1).to(torch.int32)
    step = torch.tensor(S, dtype=torch.int32, device=cuda_device)
    a, _ = kernel.decode_step(_pad_cache_to(got_state, kernel, S + 2), tok, step)
    b, _ = plain.decode_step(_pad_cache_to(want[1], plain, S + 2), tok, S)
    assert counts.read()["rotary"] - before == 2 * cfg.n_layers
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.needs_cuda
def test_ops_routes_a_cuda_tensor_to_the_kernel(cuda_device):
    q, k = _qk(2, 3, 4, 2, 64, torch.bfloat16, cuda_device)
    pos = torch.arange(3, device=cuda_device)[None].expand(2, 3)
    before = counts.read()["rotary"]
    got = ops.rotary(q.clone(), k.clone(), pos, 1e4)
    assert counts.read()["rotary"] - before == 1
    _check(got, q, k, pos, 1e4, None, what="ops")
    with pytest.raises(ValueError, match="one CUDA device"):
        rotary_cuda(q, k, pos.cpu(), 1e4)
