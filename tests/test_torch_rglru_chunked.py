"""The time-chunked RG-LRU kernel's arithmetic and launch plan, on the CPU.

``csrc/rglru_scan.cu`` runs only on the card.  Here a plain-torch
emulation of its windows, chunks, carry and rerun, driven by
``rglru_plan`` (each chunk's a_t and g_t and its (P, H) from h = 0; the
state entering each chunk folded from the window's entering state and the
chunks before it; the chunk's recurrence rerun from that state; the last
chunk's end state carried into the next window), is held against the JAX
package's ``rglru_scan_pallas`` in interpret mode and against its oracle
``ref.rglru_ref``: y at atol = rtol, the final state at atol alone (2e-5
at float32, 2e-2 at bfloat16), as the reference kernel tests hold them.
The cases add S = 1, S off the chunk and the window, W off the 16-byte
vector, and a slow decay (log_lambda uniform in [-8, -4], a near 1) whose
state carries across many chunks and windows.  The plan is checked to take
every (batch row, step, channel) exactly once at every case and at the
serving path's shapes.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_rglru import DTYPES, TOL, _f32  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_plan  # noqa: E402

# (B, S, W): the reference kernel tests' cases; S = 1; S off the chunk
# (16) and the window, inside one window and past one; W off the 16-byte
# vector (8 bf16, 4 float32 elements: 30) and off the bf16 one only (100).
CASES = [
    (2, 128, 64), (1, 100, 200), (2, 64, 256), (1, 32, 16),
    (2, 1, 64), (1, 77, 48), (2, 150, 40), (2, 70, 30), (1, 50, 100),
]
# Slow decay at the prefill's S and at 4096.
SLOW_CASES = [(1, 1024, 64), (1, 4096, 32)]
# The serving path: recurrentgemma-2b's bf16 prefill (8 prompts of 1024
# tokens, lru_width 2560) and the float32 card-vs-CPU check (2 prompts of 128).
RGEMMA_PREFILL = (8, 1024, 2560)
RGEMMA_CHECK = (2, 128, 2560)
# The reference oracle compiled whole (op by op it compiles each primitive
# anew for every shape, several seconds a case).
_ORACLE = jax.jit(functools.partial(jref.rglru_ref, return_state=True))


def _inputs(seed, B, S, W, name, slow=False):
    """(x, r, i, log_lambda) as jax and torch tensors: x, r, i standard
    normal in the named type, log_lambda float32, standard normal or (slow)
    uniform in [-8, -4]."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, W)).astype(np.float32) for _ in range(3)]
    lam = (rng.uniform(-8.0, -4.0, W) if slow else rng.standard_normal(W)).astype(np.float32)
    jdt, tdt = DTYPES[name]
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs] + [jnp.asarray(lam)]
    targs = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(lam)]
    return jargs, targs


def emulate(x, r_gate, i_gate, log_lambda, *, c=8.0, plan=None):
    """The chunked kernel's arithmetic in plain torch, every (batch row,
    channel) at once, window by window and chunk by chunk as ``plan``
    (``rglru_plan``'s by default) lays them out.  Returns y in float32
    (before the kernel rounds it to x's type) and the float32 final state."""
    B, S, W = x.shape
    plan = plan or rglru_plan(B, S, W, x.dtype)
    L = plan.chunk
    xf, rf, i_f, lf = (t.float() for t in (x, r_gate, i_gate, log_lambda))
    neg_c_lam = -c * (torch.clamp(lf, min=0.0) + torch.log1p(torch.exp(-lf.abs())))
    y = torch.empty(B, S, W)
    st = torch.empty(B, W)
    carry = torch.zeros(B, W)
    for w in range(plan.n_windows):
        chunks = []
        for k in range(plan.n_chunks):
            steps = plan.steps(w, k)
            a, g = torch.ones(B, L, W), torch.zeros(B, L, W)  # past S: a = 1, g = 0
            if len(steps):
                t = slice(steps.start, steps.stop)
                sr = 1.0 / (1.0 + torch.exp(-rf[:, t]))
                si = 1.0 / (1.0 + torch.exp(-i_f[:, t]))
                at = torch.exp(neg_c_lam * sr)
                a[:, :len(steps)] = at
                g[:, :len(steps)] = (torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12))
                                     * (si * xf[:, t]))
            P, H = torch.ones(B, W), torch.zeros(B, W)
            for j in range(L):
                H = a[:, j] * H + g[:, j]
                P = P * a[:, j]
            chunks.append((steps, a, g, P, H))
        for k, (steps, a, g, _, _) in enumerate(chunks):
            h = carry
            for _, _, _, P, H in chunks[:k]:
                h = P * h + H
            for j in range(L):
                h = a[:, j] * h + g[:, j]
                if j < len(steps):
                    y[:, steps.start + j] = h
            if S - 1 in steps:
                st = h
        carry = h  # the last chunk's end state enters the next window
    return y, st


def _check(got, want, name):
    tol = TOL[name]
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), atol=tol, rtol=tol)
    # the final state at atol alone, as the reference kernel tests hold it
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), atol=tol)


def _reference(jargs, against):
    if against == "oracle":
        return _ORACLE(*jargs)
    return rglru_scan_pallas(*jargs, return_state=True, interpret=True)


@pytest.mark.parametrize("against", ["oracle", "pallas-interpret"])
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_chunked_emulation_matches_reference(case, name, against):
    jargs, targs = _inputs(0, *case, name)
    y, st = emulate(*targs)
    assert y.shape == case and st.shape == (case[0], case[2])
    _check((y.to(targs[0].dtype), st), _reference(jargs, against), name)


@pytest.mark.parametrize("against", ["oracle", "pallas-interpret"])
@pytest.mark.parametrize("case", SLOW_CASES, ids=str)
@pytest.mark.parametrize("name", DTYPES)
def test_chunked_emulation_matches_reference_at_slow_decay(case, name, against):
    """a near 1: the state entering a chunk is mostly the carry, so a wrong
    fold or carry would show far beyond the first steps of each chunk."""
    jargs, targs = _inputs(1, *case, name, slow=True)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(targs[3]) * torch.sigmoid(targs[1].float()))
    assert float(a.mean()) > 0.97
    y, st = emulate(*targs)
    _check((y.to(targs[0].dtype), st), _reference(jargs, against), name)


@pytest.mark.parametrize("n_chunks", [1, 3, 16])
def test_chunked_emulation_holds_at_other_windows(n_chunks):
    """Windows the kernel takes besides the plan's default, on a ragged
    slow-decay case held against the oracle at float32."""
    B, S, W = 2, 150, 72
    jargs, targs = _inputs(2, B, S, W, "float32", slow=True)
    plan = dataclasses.replace(rglru_plan(B, S, W, torch.float32), n_chunks=n_chunks)
    _check(emulate(*targs, plan=plan), _ORACLE(*jargs), "float32")


def _plans():
    out = [(f"{case} {name}", case, DTYPES[name][1])
           for case in CASES + SLOW_CASES for name in DTYPES]
    return out + [("recurrentgemma-2b prefill", RGEMMA_PREFILL, torch.bfloat16),
                  ("recurrentgemma-2b float32 check", RGEMMA_CHECK, torch.float32)]


@pytest.mark.parametrize("label,case,dtype", _plans(), ids=[p[0] for p in _plans()])
def test_plan_takes_every_step_and_channel_once(label, case, dtype):
    B, S, W = case
    plan = rglru_plan(B, S, W, dtype)
    assert plan.tile == 32 and plan.chunk == 16
    assert plan.threads == 32 * plan.n_chunks <= 256 and plan.smem <= _build.MAX_SMEM
    assert plan.n_chunks & (plan.n_chunks - 1) == 0  # a power of two
    assert plan.n_chunks == 1 or (plan.n_chunks // 2) * plan.chunk < S
    assert plan.vec in (1, 16 // plan.esize)
    assert plan.vec == 1 or W % plan.vec == 0
    # threads: every (chunk, channel of the tile) once
    pairs = sorted(plan.thread(j) for j in range(plan.threads))
    assert pairs == [(k, cc) for k in range(plan.n_chunks) for cc in range(plan.tile)]
    # time: every step once over the windows and their chunks, each chunk
    # at most `chunk` steps, and one chunk holding the last step (it writes st)
    steps = np.zeros(S, np.int64)
    last = 0
    for w in range(plan.n_windows):
        for k in range(plan.n_chunks):
            taken = plan.steps(w, k)
            assert len(taken) <= plan.chunk
            steps[taken.start:taken.stop] += 1
            last += S - 1 in taken
    assert (steps == 1).all() and last == 1
    assert (plan.n_windows - 1) * plan.window < S <= plan.n_windows * plan.window
    # channels: every (batch row, channel) once over the blocks
    chans = np.zeros((B, W), np.int64)
    for i in range(plan.grid):
        b, c0 = plan.block(i)
        assert c0 < W
        chans[b, c0:c0 + plan.tile] += 1
    assert (chans == 1).all()


def test_plan_at_recurrentgemma_prefill_fills_the_card():
    """640 blocks of 128 threads (4 chunks of 16 steps x 32 channels) in
    16-byte copies: five blocks an SM hold the whole grid at once on 132
    SMs (eight fit at 64 registers), each with 12 KB of a window's copies
    in flight while it computes the window before."""
    plan = rglru_plan(*RGEMMA_PREFILL, torch.bfloat16)
    assert (plan.grid, plan.threads, plan.tile, plan.chunk, plan.n_chunks) == (640, 128, 32, 16, 4)
    assert plan.vec == 8 and plan.window == 64 and plan.n_windows == 16
    assert plan.grid <= 5 * 132 and 5 * (plan.smem + 1024) <= 233_472
    assert 3 * plan.window * plan.tile * plan.esize == 12_288
    check = rglru_plan(*RGEMMA_CHECK, torch.float32)
    assert check.vec == 4 and check.grid == 160 and check.n_chunks == 8 and check.n_windows == 1
    one_prompt = rglru_plan(1, 1024, 2560, torch.bfloat16)
    assert one_prompt.grid == 80 and one_prompt.n_chunks == 8


def test_plan_shrinks_to_short_sequences_and_unaligned_inputs():
    one = rglru_plan(2, 1, 64, torch.bfloat16)
    assert one.n_chunks == 1 and one.window == 16 and one.n_windows == 1 and one.threads == 32
    assert rglru_plan(1, 40, 16, torch.bfloat16).n_chunks == 2  # 3 chunks' worth, rounded down
    assert rglru_plan(1, 8, 100, torch.bfloat16).vec == 1  # 100 % 8
    assert rglru_plan(1, 8, 100, torch.float32).vec == 4
    assert rglru_plan(1, 8, 64, torch.bfloat16, aligned=False).vec == 1


def test_plan_refuses_what_the_kernel_is_not_built_for():
    with pytest.raises(TypeError, match="float16"):
        rglru_plan(1, 64, 64, torch.float16)


def test_chunked_source_builds_for_hopper_without_fmad_false():
    flags = _build.flags("rglru_scan")
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" not in flags
    src = (_build._CSRC / "rglru_scan.cu").read_text()
    assert "rglru_chunk_scan_kernel" in src and "cp_async_16" in src
    assert "constexpr int kChunk = 16;" in src and "constexpr int kTile = 32;" in src
    assert "later work" not in src
