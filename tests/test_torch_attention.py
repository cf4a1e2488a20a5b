"""The port's attention against the JAX package's, on the CPU.

The flash kernel's plain version (``flash_attention_plain``, which every
CPU tensor takes) is held against the reference's Pallas kernel in
interpret mode and its exact oracle on the reference kernel tests'
``ATTN_CASES``; the decode path (``chunked_attention`` with ``q_offset`` /
``kv_len``), the oracle and the layers around attention (RMS norm, RoPE,
SwiGLU) against the reference's functions.  Inputs come from numpy seeds
and reach both frameworks as the same float32 values (rounded the same
way to bfloat16 where a case asks for it).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.models import layers as tlayers  # noqa: E402

# The reference kernel tests' cases (tests/test_kernels.py).
ATTN_CASES = [
    # B, S, T, H, K, hd, causal, window, bq, bk
    (2, 128, 128, 4, 2, 64, True, 0, 64, 64),
    (1, 256, 256, 8, 8, 64, True, 0, 128, 128),
    (2, 128, 128, 4, 1, 32, False, 0, 64, 64),
    (1, 256, 256, 4, 2, 64, True, 64, 64, 64),
    (2, 96, 200, 4, 4, 128, False, 0, 64, 128),  # uneven, cross
    (1, 64, 64, 2, 2, 256, True, 0, 64, 64),  # big head dim
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _both(a, name):
    """One numpy array as a jax and a torch tensor of the named type."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jnp.float32).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, B, S, T, H, K, hd, name):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))
    return [_both(rng.standard_normal(s).astype(np.float32), name) for s in shapes]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_flash_plain_matches_pallas_interpret(case, name):
    B, S, T, H, K, hd, causal, window, bq, bk = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, B, S, T, H, K, hd, name)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, block_q=bq,
                                  block_kv=bk, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_flash_plain_matches_attention_ref(case, name):
    B, S, T, H, K, hd, causal, window, _, _ = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, B, S, T, H, K, hd, name)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)  # CPU: the plain version
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


@pytest.mark.parametrize("q_offset,kv_len,window,p_dtype", [
    (8, 30, 0, "float32"),
    (8, 30, 6, "float32"),
    (0, None, 0, "float32"),
    (8, 30, 0, "bfloat16"),
])
def test_chunked_attention_matches_reference(q_offset, kv_len, window, p_dtype):
    B, S, T, H, K, hd = 2, 24, 64, 4, 2, 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, B, S, T, H, K, hd, "float32")
    kw = dict(q_offset=q_offset, causal=True, window=window, kv_chunk=16, p_dtype=p_dtype)
    want = jlayers.chunked_attention(jq, jk, jv, kv_len=None if kv_len is None else jnp.int32(kv_len),
                                     **kw)
    got = tlayers.chunked_attention(tq, tk, tv, kv_len=kv_len, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    oracle = tref.attention_ref(tq, tk, tv, q_offset=q_offset, kv_len=kv_len, window=window)
    tol = 2e-2 if p_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


def test_attention_ref_matches_reference_with_kvlen_and_offset():
    B, S, T, H, K, hd = 2, 5, 40, 6, 3, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, B, S, T, H, K, hd, "float32")
    want = jref.attention_ref(jq, jk, jv, q_offset=20, kv_len=jnp.int32(25), window=12)
    got = tref.attention_ref(tq, tk, tv, q_offset=20, kv_len=25, window=12)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_routes_decode_to_chunked():
    """One query against a cache (``ops.decode_attention``: a runtime
    kv_len, a tensor q_offset) takes chunked_attention over one chunk of T
    keys on CPU tensors, as the reference's decode does; a full sequence
    (``ops.flash_attention``) the flash path."""
    B, T, H, K, hd = 2, 48, 4, 2, 16
    (_, tq), (_, tk), (_, tv) = _qkv(4, B, 1, T, H, K, hd, "float32")
    got = ops.decode_attention(tq, tk, tv, q_offset=30, kv_len=31)
    want = tlayers.chunked_attention(tq, tk, tv, q_offset=30, kv_len=31, kv_chunk=T)
    assert torch.equal(got, want)
    off = torch.tensor(30)
    got = ops.decode_attention(tq, tk, tv, q_offset=off)
    assert torch.equal(got, tlayers.chunked_attention(tq, tk, tv, q_offset=off, kv_chunk=T))
    (_, tq), _, _ = _qkv(5, B, 8, T, H, K, hd, "float32")
    assert torch.equal(ops.flash_attention(tq, tk, tv, q_offset=40),
                       flash_attention_plain(tq, tk, tv, q_offset=40))


def test_flash_wrappers_refuse_other_devices_and_shapes():
    (_, tq), (_, tk), (_, tv) = _qkv(6, 1, 8, 8, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(tq, tk, tv)
    meta = [t.to("meta") for t in (tq, tk, tv)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(*meta)
    with pytest.raises(ValueError, match="disagree"):
        flash_attention_plain(tq, tk[..., :8], tv[..., :8])


@pytest.mark.parametrize("name", DTYPES)
def test_norm_rope_swiglu_match_reference(name):
    rng = np.random.default_rng(7)
    B, S, H, hd, D, F = 2, 9, 3, 16, 24, 40
    jx, tx = _both(rng.standard_normal((B, S, H, hd)).astype(np.float32), name)
    pos = rng.integers(0, 500, (B, S))
    want = jlayers.apply_rope(jx, jnp.asarray(pos, jnp.int32), 10000.0)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    tol = _tol(name) if name == "bfloat16" else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)

    jh, th = _both(rng.standard_normal((B, S, D)).astype(np.float32), name)
    scale = rng.standard_normal(D).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jh, jnp.asarray(scale), 1e-6)
    got = tlayers.rms_norm(th, torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)

    w = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]) for s in ((D, F), (D, F), (F, D))]
    want = jlayers.swiglu(jh, *(jnp.asarray(a) for a in w))
    got = tlayers.swiglu(th, *(torch.from_numpy(a) for a in w))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
