"""The tensor-core SSD-scan kernel's arithmetic and launch plan, on the CPU.

``csrc/ssd_scan_mma.cu`` runs only on the card.  Here a plain-torch
emulation of its passes and rounding points (cum from the chunk pass; the
chunk's own state from bf16 B and x w split into bf16 hi + lo; float32
score tiles C B^T, one set a B/C group; the float32 state pass, the state
entering each chunk split into hi + lo; the output pass tile by tile with
the scores scaled by exp(cum_t - cum_s) dt_s, masked and split into hi +
lo before P x) is held against the JAX
package's ``ssd_scan_pallas`` in interpret mode (exact float32 there) at
bfloat16: y within atol = rtol = 2e-2, the final state within atol 2e-2
alone, as the reference kernel tests hold them.  The launch plan that the
wrapper hands the kernel is checked for every case and mamba2-130m's
prefill shape.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_ssd import SSD_CASES, _f32, _ssd_inputs  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import mma_plan  # noqa: E402

# The reference cases, chunk 48 (what ops.ssd_scan makes of chunk 64 at
# S = 96), and mamba2-130m's widths (hp 64, ds 128, chunk 256) at a small
# batch and head count.
MMA_CASES = [
    *SSD_CASES,
    (1, 96, 2, 8, 1, 8, 48),
    (1, 512, 2, 64, 1, 128, 256),
]
# mamba2-130m's prefill: 8 prompts of 1024 tokens, 24 heads of 64, state 128.
MAMBA_PREFILL = (8, 1024, 24, 64, 1, 128, 256)


def _split(v, split=True):
    """A float32 tensor as the kernel's bf16 hi + lo operands (in float32);
    with ``split=False``, rounded once to bf16 (and a zero lo)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if split else torch.zeros_like(hi)


def emulate_mma(x, dt, A, Bm, Cm, D, *, chunk, split=True):
    """The tensor-core kernel's arithmetic in plain torch on bf16 x, B, C:
    pass by pass and block by block, as the kernel runs them.  Returns y
    in float32 (before the kernel's rounding to bf16) and the final state;
    ``split=False`` rounds the float32 operands once instead."""
    Bb, S, nh, hp = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    plan = mma_plan(Bb, S, nh, hp, ng, ds, chunk)
    L, R, nc, rep = chunk, plan.rows, plan.n_chunks, nh // ng
    xf, Bf, Cf, dtf, Af, Df = (t.float() for t in (x, Bm, Cm, dt, A, D))

    # chunk pass: cum, and the chunk's own state B^T (x w)
    cum = torch.empty(Bb, nh, S)
    sc = torch.empty(Bb, nc, nh, ds, hp)
    for i in range(plan.chunk_grid):
        b, c, h = plan.chunk_block(i)
        pos, g = slice(c * L, (c + 1) * L), h // rep
        cum[b, h, pos] = torch.cumsum(dtf[b, pos, h] * Af[h], 0)
        cc = cum[b, h, pos]
        xw_hi, xw_lo = _split(xf[b, pos, h] * (torch.exp(cc[-1] - cc) * dtf[b, pos, h])[:, None],
                              split)
        sc[b, c, h] = Bf[b, pos, g].T @ xw_hi + Bf[b, pos, g].T @ xw_lo

    # score pass: G = C B^T, a (t tile, s tile <= t tile) pair at a time
    scores = {}
    for i in range(plan.score_grid):
        b, c, g, t0 = plan.score_block(i)
        pt = c * L + torch.arange(t0, min(t0 + R, L))
        for s0 in range(0, t0 + 1, R):
            ps = c * L + torch.arange(s0, min(s0 + R, L))
            scores[b, c, g, t0, s0] = Cf[b, pt, g] @ Bf[b, ps, g].T

    # state pass: the state entering each chunk, and the final state
    h_in = torch.zeros(Bb, nc, nh, ds, hp)
    hv = torch.zeros(Bb, nh, ds, hp)
    for c in range(nc):
        h_in[:, c] = hv
        hv = torch.exp(cum[:, :, c * L + L - 1])[..., None, None] * hv + sc[:, c]
    h_hi, h_lo = _split(h_in, split)

    # output pass, a tile of rows t a block
    y = torch.empty(Bb, S, nh, hp)
    for i in range(plan.out_grid):
        b, c, h, t0 = plan.out_block(i)
        g = h // rep
        t = torch.arange(t0, min(t0 + R, L))
        pt = c * L + t
        ct, Ct = cum[b, h, pt], Cf[b, pt, g]
        acc = torch.zeros(len(t), hp)
        if c > 0:
            acc = torch.exp(ct)[:, None] * (Ct @ h_hi[b, c, h] + Ct @ h_lo[b, c, h])
        for s0 in range(0, t0 + 1, R):
            s = torch.arange(s0, min(s0 + R, L))
            ps = c * L + s
            G = scores[b, c, g, t0, s0]
            coef = torch.exp(ct[:, None] - cum[b, h, ps][None, :]) * dtf[b, ps, h][None, :]
            p_hi, p_lo = _split(torch.where(s[None, :] <= t[:, None], G * coef, 0.0), split)
            acc = acc + p_hi @ xf[b, ps, h] + p_lo @ xf[b, ps, h]
        y[b, pt, h] = acc + Df[h] * xf[b, pt, h]
    return y, hv


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_mma_emulation_matches_pallas_interpret_at_bf16(case):
    B, S, nh, hp, ng, ds, chunk = case
    jargs, targs = _ssd_inputs(0, B, S, nh, hp, ng, ds, "bfloat16")
    want_y, want_st = ssd_scan_pallas(*jargs, chunk=chunk, return_state=True, interpret=True)
    got_y, got_st = emulate_mma(*targs, chunk=chunk)
    got_y = got_y.to(torch.bfloat16)  # as the kernel stores y
    assert got_y.shape == targs[0].shape
    assert got_st.shape == (B, nh, ds, hp)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=2e-2, rtol=2e-2)
    # the final state at atol alone, as the reference kernel tests hold it
    np.testing.assert_allclose(_f32(got_st), _f32(want_st), atol=2e-2)


def test_hi_lo_splits_hold_what_single_roundings_miss():
    """Why the kernel splits x w, P and the entering state into bf16 hi +
    lo: at mamba2-130m's widths, rounding each once to bf16 puts y near
    half its atol = rtol = 2e-2 bound and the final state near its 2e-2
    (x w alone sets the state's error), against the float32 reference on
    the same bf16 inputs; the splits keep both far inside."""
    B, S, nh, hp, ng, ds, chunk = MMA_CASES[-1]
    _, targs = _ssd_inputs(0, B, S, nh, hp, ng, ds, "bfloat16")
    want_y, want_st = tref.ssd_chunked_ref(*(t.float() for t in targs), chunk=chunk,
                                           return_state=True)
    errs = {}
    for split in (True, False):
        y, st = emulate_mma(*targs, chunk=chunk, split=split)
        errs[split] = (float(((y - want_y).abs() / (2e-2 + 2e-2 * want_y.abs())).max()),
                       float((st - want_st).abs().max()))
    assert errs[True][0] < 0.01 and errs[True][1] < 1e-4, errs
    assert errs[False][0] > 0.3 and errs[False][1] > 1e-2, errs


def _plans():
    return [(str(case), case) for case in MMA_CASES] + [("mamba2-130m", MAMBA_PREFILL)]


@pytest.mark.parametrize("name,case", _plans(), ids=[n for n, _ in _plans()])
def test_mma_plan_fits_the_card_and_covers_every_block_row_and_column_once(name, case):
    B, S, nh, hp, ng, ds, chunk = case
    plan = mma_plan(*case)
    assert max(plan.chunk_smem, plan.score_smem, plan.out_smem) <= _build.MAX_SMEM
    assert plan.threads == 128 and plan.rows == 64 and plan.kd == 64
    assert plan.chunk_threads == 256 and plan.group == 128
    assert plan.hp_pad in (16, 32, 64, 128) and hp <= plan.hp_pad < max(2 * hp, 16 + 1)
    nc = S // chunk
    assert plan.n_chunks == nc and plan.chunk_grid == B * nc * nh
    assert 0 < plan.out_grid <= 2**31 - 1 and plan.out_grid == plan.n_tiles * B * nc * nh
    pairs_of_columns = B * nh * ds * plan.hp_pad // 2  # a state-pass thread each
    assert plan.state_grid * plan.state_threads >= pairs_of_columns
    assert (plan.state_grid - 1) * plan.state_threads < pairs_of_columns
    # the chunk pass takes every (b, chunk, head) once
    seen = np.zeros((B, nc, nh), np.int64)
    for i in range(plan.chunk_grid):
        np.add.at(seen, plan.chunk_block(i), 1)
    assert (seen == 1).all()
    # the score pass takes every (b, chunk, group) and pair of tiles s <= t once
    pairs = np.zeros((B, nc, ng, plan.n_tiles, plan.n_tiles), np.int64)
    for i in range(plan.score_grid):
        b, c, g, t0 = plan.score_block(i)
        pairs[b, c, g, t0 // plan.rows, :t0 // plan.rows + 1] += 1
    assert (pairs == np.tril(np.ones((plan.n_tiles, plan.n_tiles), np.int64))).all()
    assert pairs.sum() == B * nc * ng * plan.n_pairs
    assert plan.score_block(0)[3] == (plan.n_tiles - 1) * plan.rows
    # the output pass takes every (b, position, head) once
    rows = np.zeros((B, S, nh), np.int64)
    for i in range(plan.out_grid):
        b, c, h, t0 = plan.out_block(i)
        assert 0 <= t0 < chunk
        rows[b, c * chunk + t0: c * chunk + min(t0 + plan.rows, chunk), h] += 1
    assert (rows == 1).all()
    # most work first: the first blocks take the last tile of their chunk
    assert plan.out_block(0)[3] == (plan.n_tiles - 1) * plan.rows
    assert plan.out_block(plan.out_grid - 1)[3] == 0
    # the state slices and the chunk pass's groups take every state once
    for parts, most in ((plan.slices(), plan.kd), (plan.groups(), plan.group)):
        cols = np.zeros(ds, np.int64)
        for k0, width in parts:
            assert 0 < width <= most
            cols[k0:k0 + width] += 1
        assert (cols == 1).all()


def test_mma_plan_at_mamba2_130m_fills_the_card():
    """768 (b, chunk, head) chunk-pass blocks and 3072 output tiles, many
    waves on 132 SMs, where the CUDA-core kernel had 192 blocks; one score
    pass of 128 blocks for all 24 heads of the one B/C group."""
    plan = mma_plan(*MAMBA_PREFILL)
    assert plan.chunk_grid == 768 and plan.out_grid == 4 * 768 and plan.score_grid == 4 * 32
    assert plan.hp_pad == 64 and len(plan.slices()) == 2 and len(plan.groups()) == 1
    assert plan.n_pairs == 10
    assert 2 * (plan.out_smem + 1024) <= 233_472, "two output blocks an SM"


def test_mma_plan_refuses_wide_heads():
    with pytest.raises(ValueError, match="hp = 256"):
        mma_plan(1, 16, 2, 256, 1, 8, 16)


def test_mma_source_builds_for_hopper_without_fmad_false():
    flags = _build.flags("ssd_scan_mma")
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" not in flags
    src = (_build._CSRC / "ssd_scan_mma.cu").read_text()
    assert '#include "mma_bf16.cuh"' in src and "mma_16816" in src
