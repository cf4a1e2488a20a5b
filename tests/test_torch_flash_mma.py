"""The tensor-core flash-attention kernel's arithmetic and launch plan, on
the CPU.

``csrc/flash_attention_mma.cu`` runs only on the card.  Here a plain-torch
emulation of its rounding points (bf16 operands, float32 scores scaled
after the product, the GQA-packed row map, the online softmax over the
kernel's kv tiles in the log2 domain, P rounded to bf16 before P V, float32
O and l) is held against the JAX package's ``flash_attention_pallas`` in
interpret mode (exact float32 there) at bfloat16, within the reference
kernel tests' 2e-2; and the launch plan that the wrapper hands the kernel
is checked for every head dim and the served models' prefill shapes.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention_plain,
    mma_plan,
)

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# The reference kernel tests' cases (tests/test_kernels.py), and a reduced
# recurrentgemma-like case: hd 256, 10 query heads on 1 kv head, a binding
# window, S not a multiple of any tile.
ATTN_CASES = [
    # B, S, T, H, K, hd, causal, window, bq, bk (the Pallas kernel's blocks)
    (2, 128, 128, 4, 2, 64, True, 0, 64, 64),
    (1, 256, 256, 8, 8, 64, True, 0, 128, 128),
    (2, 128, 128, 4, 1, 32, False, 0, 64, 64),
    (1, 256, 256, 4, 2, 64, True, 64, 64, 64),
    (2, 96, 200, 4, 4, 128, False, 0, 64, 128),  # uneven, cross
    (1, 64, 64, 2, 2, 256, True, 0, 64, 64),  # big head dim
    (1, 100, 100, 10, 1, 256, True, 40, 64, 64),  # recurrentgemma-like, window binds
]
# The served models' prefill shapes and recurrentgemma-2b's binding window.
PREFILL_SHAPES = {
    "smollm-135m": (8, 1024, 9, 3, 64),
    "recurrentgemma-2b": (8, 1024, 10, 1, 256),
    "recurrentgemma-2b-window": (2, 4096, 10, 1, 256),
}


def emulate_mma(q, k, v, *, causal=True, window=0, q_offset=0):
    """The tensor-core kernel's arithmetic in plain torch on bf16 q, k, v:
    block by block and kv tile by kv tile, as the kernel runs them."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    plan = mma_plan(B, S, H, K, hd)
    G, M, BKV = plan.group, plan.rows, plan.kv_tile
    scale_log2 = np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)
    # (B, K, S * G, hd): packed row r of kv head kh is (r // G, kh * G + r % G)
    qp = q.float().reshape(B, S, K, G, hd).permute(0, 2, 1, 3, 4).reshape(B, K, S * G, hd)
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, K, S * G, hd)
    rows = S * G
    for i in range(plan.grid):
        b, kh, row0 = plan.block(i)
        r = torch.arange(row0, min(row0 + M, rows))
        pos = q_offset + r // G
        p_first, p_last = int(pos[0]), int(pos[-1])
        kv_end = min(T, p_last + 1) if causal else T
        kv_begin = max(0, p_first - window + 1) // BKV * BKV if window > 0 else 0
        m = torch.full((len(r),), NEG_INF)
        l = torch.zeros(len(r))
        acc = torch.zeros(len(r), hd)
        for k0 in range(kv_begin, kv_end, BKV):
            t = torch.arange(k0, k0 + BKV)
            kt = torch.zeros(BKV, hd)
            vt = torch.zeros(BKV, hd)
            live = t < T
            kt[live], vt[live] = kf[b, t[live], kh], vf[b, t[live], kh]
            s = (qp[b, kh, r] @ kt.T) * scale_log2  # float32 scores, scaled after the product
            ok = live[None, :].expand(len(r), BKV)
            if causal:
                ok = ok & (pos[:, None] >= t[None, :])
            if window > 0:
                ok = ok & (pos[:, None] - t[None, :] < window)
            s = torch.where(ok, s, torch.tensor(NEG_INF))
            mn = torch.maximum(m, s.max(dim=1).values)
            corr = torch.exp2(m - mn)
            p = torch.exp2(s - mn[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + p.bfloat16().float() @ vt  # P rounded to bf16
            m = mn
        out[b, kh, r] = acc / torch.clamp(l, min=1e-30)[:, None]
    out = out.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def _qkv(seed, B, S, T, H, K, hd):
    """bf16 inputs as jax and torch arrays holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)):
        a = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(a).bfloat16()
        out.append((jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t))
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_mma_emulation_matches_pallas_interpret_at_bf16(case):
    B, S, T, H, K, hd, causal, window, bq, bk = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, B, S, T, H, K, hd)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, block_q=bq,
                                  block_kv=bk, interpret=True)
    got = emulate_mma(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("q_offset,window", [(60, 0), (60, 17)])
def test_mma_emulation_continuation_matches_plain(q_offset, window):
    """A prefill continuation (q_offset > 0, S < T) with GQA G = 3."""
    (_, tq), (_, tk), (_, tv) = _qkv(12, 2, 40, 100, 6, 2, 64)
    got = emulate_mma(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    want = flash_attention_plain(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=2e-2)


def _plans():
    cases = [(f"hd{hd}", (2, 200, 6, 2, hd)) for hd in HEAD_DIMS]
    return cases + list(PREFILL_SHAPES.items())


@pytest.mark.parametrize("name,shape", _plans(), ids=[n for n, _ in _plans()])
def test_mma_plan_fits_the_card_and_covers_every_row_once(name, shape):
    B, S, H, K, hd = shape
    plan = mma_plan(B, S, H, K, hd)
    assert plan.smem <= _build.MAX_SMEM
    assert 2 * (plan.smem + 1024) <= 233_472, "two blocks an SM (228 KB, 1 KB each reserved)"
    assert plan.threads == 128 and plan.rows == 64 and plan.rows % 16 == 0
    assert plan.kv_tile % 16 == 0 and plan.kv_tile == (32 if hd == 256 else 64)
    assert 0 < plan.grid <= 2**31 - 1 and plan.grid == plan.n_tiles * B * K
    seen = np.zeros((B, S, H), np.int64)
    for i in range(plan.grid):
        b, kh, row0 = plan.block(i)
        r = np.arange(row0, min(row0 + plan.rows, S * plan.group))
        assert len(r) > 0
        pos, head = plan.row(kh, r)
        assert (head // plan.group == kh).all()
        np.add.at(seen, (b, pos, head), 1)
    assert (seen == 1).all()
    # the grid runs the longest causal tiles first
    assert plan.block(0)[2] == (plan.n_tiles - 1) * plan.rows
    assert plan.block(plan.grid - 1)[2] == 0


def test_mma_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim 48"):
        mma_plan(1, 16, 2, 1, 48)


def test_build_flags_are_per_source():
    """-fmad=false for the float64 sweeps only; no source builds fast-math."""
    for name in ("placement_sweep", "placement_sweep_batch"):
        assert "-fmad=false" in _build.flags(name)
    for name in ("flash_attention", "flash_attention_mma", "ssd_scan", "rglru_scan"):
        assert "-fmad=false" not in _build.flags(name)
    for name in ("placement_sweep", "flash_attention_mma"):
        assert not any("fast-math" in f or "fast_math" in f for f in _build.flags(name))
        assert "arch=compute_90a,code=sm_90a" in _build.flags(name)


def test_library_hash_covers_shared_headers(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// v1\n")
    flags = _build.flags("k")
    first = _build._digest(src, [header], flags)
    assert _build._digest(src, [header], flags) == first
    header.write_text("// v2\n")
    assert _build._digest(src, [header], flags) != first
    assert _build._digest(src, [header], _build.flags("placement_sweep")) != first
    assert (_build._CSRC / "mma_bf16.cuh").exists()
