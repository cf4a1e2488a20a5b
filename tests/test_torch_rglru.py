"""The port's RG-LRU scan against the JAX package's, on the CPU.

The RG-LRU kernel's plain version (``rglru_scan_plain``, which every CPU
tensor takes) is held against the reference's oracle ``ref.rglru_ref`` and
its Pallas kernel in interpret mode, final state included, on the
reference kernel tests' ``RGLRU_CASES``; the port's decode step against the
reference's and against its own full scan.  Inputs come from numpy seeds.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain  # noqa: E402

# The reference kernel tests' cases (tests/test_kernels.py).
RGLRU_CASES = [
    # B, S, W, bt, bc
    (2, 128, 64, 32, 64),
    (1, 100, 200, 64, 128),  # uneven both dims
    (2, 64, 256, 64, 128),
    (1, 32, 16, 32, 16),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rglru_inputs(seed, B, S, W, name="float32"):
    """(x, r, i, log_lambda) as jax and torch tensors: x, r, i in the named
    type, log_lambda float32 (the reference tests' laws)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, W)).astype(np.float32) for _ in range(3)]
    lam = rng.standard_normal(W).astype(np.float32)
    jdt, tdt = DTYPES[name]
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs] + [jnp.asarray(lam)]
    targs = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(lam)]
    return jargs, targs


@pytest.mark.parametrize("against", ["oracle", "pallas-interpret"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_rglru_plain_matches_reference(case, name, against):
    B, S, W, bt, bc = case
    jargs, targs = _rglru_inputs(0, B, S, W, name)
    if against == "oracle":
        want_y, want_st = jref.rglru_ref(*jargs, return_state=True)
    else:
        want_y, want_st = rglru_scan_pallas(*jargs, block_t=bt, block_c=bc, return_state=True,
                                            interpret=True)
    got_y, got_st = rglru_scan_plain(*targs, return_state=True)
    assert got_y.dtype == targs[0].dtype and got_y.shape == (B, S, W)
    assert got_st.dtype == torch.float32 and got_st.shape == (B, W)
    tol = TOL[name]
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=tol, rtol=tol)
    # the final state at atol alone, as the reference kernel tests hold it
    np.testing.assert_allclose(_f32(got_st), _f32(want_st), atol=tol)


def test_rglru_plain_state_is_the_last_output_rounded():
    """The plain version's state is y[:, -1] widened to float32, as the
    reference oracle returns it."""
    _, targs = _rglru_inputs(1, 2, 40, 24, "bfloat16")
    y, st = rglru_scan_plain(*targs, return_state=True)
    assert torch.equal(st, y[:, -1].float())


def test_rglru_initial_state_matches_reference():
    B, S, W = 2, 33, 24
    jargs, targs = _rglru_inputs(2, B, S, W)
    st0 = np.random.default_rng(3).standard_normal((B, W)).astype(np.float32)
    want_y, want_st = jref.rglru_ref(*jargs, initial_state=jnp.asarray(st0), return_state=True)
    got_y, got_st = tref.rglru_ref(*targs, initial_state=torch.from_numpy(st0),
                                   return_state=True)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_f32(got_st), _f32(want_st), atol=2e-5)


def test_rglru_decode_steps_match_full_scan_and_reference():
    B, S, W = 1, 12, 16
    jargs, targs = _rglru_inputs(4, B, S, W)
    x, r, i, lam = targs
    jx, jr, ji, jlam = jargs
    y_full, st_full = ops.rglru_scan(*targs, return_state=True)
    st = torch.zeros((B, W))
    jst = jnp.zeros((B, W))
    for t in range(S):
        y_t, st = tref.rglru_decode_step(st, x[:, t], r[:, t], i[:, t], lam)
        jy_t, jst = jref.rglru_decode_step(jst, jx[:, t], jr[:, t], ji[:, t], jlam)
        assert st.dtype == torch.float32 and y_t.dtype == x.dtype
        np.testing.assert_allclose(_f32(y_t), _f32(y_full[:, t]), atol=1e-5)
        np.testing.assert_allclose(_f32(y_t), _f32(jy_t), atol=1e-6)
        np.testing.assert_allclose(_f32(st), _f32(jst), atol=1e-6)
    np.testing.assert_allclose(_f32(st), _f32(st_full), atol=1e-5)


def test_rglru_stability_long_sequence():
    """Decay in (0, 1): the state never blows up over 4k steps, and the
    doubling scan stays with the sequential steps to the end."""
    B, S, W = 1, 4096, 8
    _, targs = _rglru_inputs(5, B, S, W)
    y = ops.rglru_scan(*targs)
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) < 1e3
    x, r, i, lam = targs
    st = torch.zeros((B, W))
    for t in range(S):
        _, st = tref.rglru_decode_step(st, x[:, t], r[:, t], i[:, t], lam)
    np.testing.assert_allclose(_f32(st), _f32(y[:, -1]), atol=1e-5)


def test_rglru_scan_routes_by_device():
    """CPU tensors take the plain version (made contiguous first); a
    ``meta`` tensor raises, and the CUDA wrapper refuses CPU tensors."""
    _, targs = _rglru_inputs(6, 2, 20, 16)
    before = rglru_scan_cuda.launches
    got = ops.rglru_scan(*targs, return_state=True)
    assert rglru_scan_cuda.launches == before
    want = rglru_scan_plain(*targs, return_state=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    x, r, i, lam = targs
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)  # same values, another layout
    assert torch.equal(ops.rglru_scan(xt, r, i, lam), want[0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rglru_scan(*(t.to("meta") for t in targs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan_cuda(*targs)


def test_rglru_wrappers_refuse_bad_shapes():
    _, targs = _rglru_inputs(7, 1, 8, 16)
    x, r, i, lam = targs
    with pytest.raises(ValueError, match="log_lambda"):
        rglru_scan_plain(x, r, i, lam[:8])
    with pytest.raises(ValueError, match=r"want x = r = i"):
        rglru_scan_plain(x, r[:, :4], i, lam)
    with pytest.raises(ValueError, match=r"want x = r = i"):
        rglru_scan_plain(x[0], r[0], i[0], lam)
