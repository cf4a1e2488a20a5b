"""The port's Mamba-2 SSD scan against the JAX package's, on the CPU.

The SSD kernel's plain version (``ssd_scan_plain``, which every CPU tensor
takes) is held against the reference's Pallas kernel in interpret mode,
final state included, and against its naive O(S^2) oracle, on the
reference kernel tests' ``SSD_CASES``; the port's oracles and decode step
against the reference's.  Inputs come from numpy seeds.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain  # noqa: E402

# The reference kernel tests' cases (tests/test_kernels.py).
SSD_CASES = [
    # B, S, nh, hp, ng, ds, chunk
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 4, 32, 4, 16, 16),
    (1, 128, 2, 8, 1, 8, 128),  # single chunk
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(seed, B, S, nh, hp, ng, ds, name="float32"):
    """(x, dt, A, B, C, D) as jax and torch tensors: x, dt, B, C in the named
    type, A and D float32 (the reference tests' laws)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0.0).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ng, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ng, ds)) * 0.3).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    jdt, tdt = DTYPES[name]
    typed = lambda a: (jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt))  # noqa: E731
    plain = lambda a: (jnp.asarray(a), torch.from_numpy(a))  # noqa: E731
    pairs = [typed(x), typed(dt), plain(A), typed(Bm), typed(Cm), plain(D)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_ssd_plain_matches_pallas_interpret(case, name):
    B, S, nh, hp, ng, ds, chunk = case
    jargs, targs = _ssd_inputs(0, B, S, nh, hp, ng, ds, name)
    want_y, want_st = ssd_scan_pallas(*jargs, chunk=chunk, return_state=True, interpret=True)
    got_y, got_st = ssd_scan_plain(*targs, chunk=chunk, return_state=True)
    assert got_y.dtype == targs[0].dtype and got_st.dtype == torch.float32
    assert got_st.shape == (B, nh, ds, hp)
    tol = 2e-2 if name == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=tol, rtol=tol)
    # the final state at atol alone, as the reference kernel tests hold it
    np.testing.assert_allclose(_f32(got_st), _f32(want_st), atol=tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_plain_matches_naive_oracle(case):
    B, S, nh, hp, ng, ds, chunk = case
    jargs, targs = _ssd_inputs(1, B, S, nh, hp, ng, ds)
    want = jref.ssd_ref(*jargs)
    # the naive oracle sums in another order (O(S^2) form): 5e-4, as the
    # reference kernel tests allow
    got = ops.ssd_scan(*targs, chunk=chunk)  # CPU: the plain version
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-4, rtol=5e-4)
    # the two naive oracles: exp of cumulative sums over the whole sequence,
    # in each library's own order
    np.testing.assert_allclose(_f32(tref.ssd_ref(*targs)), _f32(want), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_chunked_ref_matches_reference_with_initial_state(case):
    B, S, nh, hp, ng, ds, chunk = case
    jargs, targs = _ssd_inputs(2, B, S, nh, hp, ng, ds)
    st0 = np.random.default_rng(3).standard_normal((B, nh, ds, hp)).astype(np.float32) * 0.1
    want_y, want_st = jref.ssd_chunked_ref(*jargs, chunk=chunk, initial_state=jnp.asarray(st0),
                                           return_state=True)
    got_y, got_st = tref.ssd_chunked_ref(*targs, chunk=chunk, initial_state=torch.from_numpy(st0),
                                         return_state=True)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_f32(got_st), _f32(want_st), atol=2e-5)


def test_ssd_decode_steps_match_full_scan_and_reference():
    B, S, nh, hp, ng, ds = 1, 16, 2, 8, 1, 8
    jargs, targs = _ssd_inputs(4, B, S, nh, hp, ng, ds)
    x, dt, A, Bm, Cm, D = targs
    jx, jdt, jA, jB, jC, jD = jargs
    y_full, st_full = ops.ssd_scan(*targs, chunk=S, return_state=True)
    st = torch.zeros((B, nh, ds, hp))
    jst = jnp.zeros((B, nh, ds, hp))
    for t in range(S):
        y_t, st = tref.ssd_decode_step(st, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        jy_t, jst = jref.ssd_decode_step(jst, jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], jD)
        np.testing.assert_allclose(_f32(y_t), _f32(y_full[:, t]), atol=1e-5)
        np.testing.assert_allclose(_f32(y_t), _f32(jy_t), atol=1e-6)
    np.testing.assert_allclose(_f32(st), _f32(st_full), atol=1e-5)
    np.testing.assert_allclose(_f32(st), _f32(jst), atol=1e-6)


def test_ssd_scan_shrinks_chunk_to_a_divisor():
    """S = 96 with chunk 64 runs at chunk 48, as the reference's ops.ssd_scan."""
    jargs, targs = _ssd_inputs(5, 1, 96, 2, 8, 1, 8)
    got = ops.ssd_scan(*targs, chunk=64)
    assert torch.equal(got, ssd_scan_plain(*targs, chunk=48))
    want = jref.ssd_chunked_ref(*jargs, chunk=48)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_ssd_wrappers_refuse_other_devices_and_shapes():
    _, targs = _ssd_inputs(6, 1, 32, 2, 8, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_cuda(*targs, chunk=16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ssd_scan(*(t.to("meta") for t in targs), chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_plain(*targs, chunk=5)
    x, dt, A, Bm, Cm, D = targs
    with pytest.raises(ValueError, match="multiple of ng"):
        ssd_scan_plain(x, dt, A, Bm.expand(1, 32, 3, 8), Cm.expand(1, 32, 3, 8), D, chunk=16)
