"""The decode-attention kernel's launch plan and arithmetic, on the CPU.

``csrc/decode_attention.cu`` runs only on the card (its tests there are in
``tests/test_torch_decode_attention_cuda.py``).  Here ``decode_plan`` is
held to its coverage (every key of the cache in exactly one split, every
query head in exactly one block), to the launch limits, and to its split
counts at the served models' shapes; a plain-torch emulation of the
kernel's split-K arithmetic (each split's partial over its live keys, the
partials merged in split order) is held to ``chunked_attention``; and
``ops.decode_attention`` on CPU tensors is ``chunked_attention`` over one
chunk of T keys bit for bit, as before the kernel.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    H100_SMS,
    decode_plan,
)
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.ref import chunked_attention  # noqa: E402

# B, H, K, T, hd: the benchmark's chat and doc cells (qwen2-vl-2b: 12 query
# heads on 2 kv heads of 128), smollm-135m (9 on 3 of 64), moonshot (16 of
# 128, one a kv head), seamless (16 of 64), recurrentgemma-2b's local
# attention at one query (10 on 1 of 256: two blocks of 5), and groups
# that do not fill a block evenly
SHAPES = {
    "chat": (256, 12, 2, 768, 128),
    "doc": (16, 12, 2, 8200, 128),
    "smollm": (8, 9, 3, 1056, 64),
    "moonshot": (8, 16, 16, 1056, 128),
    "seamless": (8, 16, 16, 1056, 64),
    "recurrentgemma": (2, 10, 1, 2048, 256),
    "group9": (3, 18, 2, 37, 32),
    "group17": (1, 17, 1, 5, 16),
    "one-key": (1, 4, 4, 1, 64),
}


def _keys(plan, split: int) -> range:
    """The cache rows split ``split`` reads, as the kernel bounds them."""
    return range(split * plan.split_keys, min((split + 1) * plan.split_keys, plan.T))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_decode_plan_covers_every_key_and_head_once(name, dtype):
    B, H, K, T, hd = SHAPES[name]
    plan = decode_plan(B, H, K, T, hd, dtype)
    keys = [t for s in range(plan.splits) for t in _keys(plan, s)]
    assert keys == list(range(T))  # every key in exactly one split, in order
    assert all(len(_keys(plan, s)) >= 1 for s in range(plan.splits))
    assert plan.split_keys % plan.tile == 0 and 1 <= plan.heads <= 8
    # a block's query heads, as the kernel takes them: from kv head * group
    # + chunk * heads, up to the kv head's last
    group = H // K
    heads = sorted(kh * group + c * plan.heads + j for kh in range(K) for c in range(plan.chunks)
                   for j in range(min(plan.heads, group - c * plan.heads)))
    assert heads == list(range(H))
    assert (plan.chunks - 1) * plan.heads < group <= plan.chunks * plan.heads
    # the launch limits: a 1-D grid of one block a (b, kv head, chunk,
    # split), the card's shared memory
    assert plan.grid == B * K * plan.chunks * plan.splits
    assert 1 <= plan.grid <= 2**31 - 1
    assert plan.smem <= _build.MAX_SMEM and plan.smem % 16 == 0
    # a tile's 16-byte copies split evenly over a block's 128 threads
    units = hd * torch.finfo(dtype).bits // 8 // 16
    assert (plan.tile * units) % 128 == 0


def test_decode_plan_splits_at_the_served_shapes():
    """The split count fills 132 SMs about eight blocks deep: the chat
    cell's 512 (b, kv head) pairs take 3 splits of 256 keys, the doc cell's
    32 pairs 33, and a split never falls below one tile."""
    got = {name: (decode_plan(*SHAPES[name], torch.bfloat16).splits,
                  decode_plan(*SHAPES[name], torch.bfloat16).split_keys)
           for name in ("chat", "doc", "smollm", "moonshot", "seamless", "one-key")}
    assert got == {"chat": (3, 256), "doc": (33, 256), "smollm": (17, 64),
                   "moonshot": (9, 128), "seamless": (9, 128), "one-key": (1, 64)}
    chat = decode_plan(*SHAPES["chat"], torch.bfloat16)
    assert (chat.heads, chat.chunks, chat.tile, chat.grid) == (6, 1, 32, 1536)
    assert chat.smem == 65536  # four stages of 16 KB of K and V tiles
    assert chat.grid >= 8 * H100_SMS
    # float32 rows are twice as wide: 32 lanes a row, tiles of 16 keys
    f32 = decode_plan(*SHAPES["chat"], torch.float32)
    assert (f32.tile, f32.splits) == (16, 3)
    # a float32 tile of 256-wide rows is 32 KB: two stages fill the budget
    assert decode_plan(2, 16, 2, 100, 256, torch.float32).smem == 65536
    # fewer SMs, fewer splits; the plan reads nothing but the shapes
    assert decode_plan(*SHAPES["doc"], torch.bfloat16, sm_count=66).splits == 17


def test_decode_plan_raises_on_what_the_kernel_is_not_built_for():
    with pytest.raises(ValueError, match="head dim"):
        decode_plan(2, 4, 2, 64, 48, torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        decode_plan(2, 4, 2, 64, 64, torch.float16)
    with pytest.raises(ValueError, match="p_dtype"):
        decode_plan(2, 4, 2, 64, 64, torch.bfloat16, "float16")
    with pytest.raises(ValueError, match="multiple"):
        decode_plan(2, 6, 4, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="T >= 1"):
        decode_plan(2, 4, 2, 0, 64, torch.bfloat16)


def test_plan_constants_are_the_kernel_sources():
    src = (_build._CSRC / "decode_attention.cu").read_text()
    for line in ("constexpr int kWarps = 4;", "constexpr int kSteps = 4;",
                 "constexpr int kStagesMax = 4;", "constexpr int kStageBudget = 65536;",
"case 8: return launch<T, HD, 8>(a);",
                 "decode_attention_kernel", "decode_attention_merge_kernel", "cp_async_16"):
        assert line in src
    assert "case 9:" not in src  # eight query heads a block at most
    flags = _build.flags("decode_attention")
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" not in flags


# ---------------------------------------------------------------------------
# the kernel's split-K arithmetic, emulated
# ---------------------------------------------------------------------------


def _emulate(q, k, v, *, q_offset, kv_len, causal, window, p_dtype):
    """The kernel's function by its plan: each split's partial (m, l, acc)
    over its live keys (float32 scores and softmax, p and v rounded to
    ``p_dtype`` before p @ v, l over the unrounded p), then the partials
    merged in split order; a row with no live key scores every key 0."""
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    plan = decode_plan(B, H, K, T, hd, q.dtype, p_dtype)
    pdt = getattr(torch, p_dtype)
    qf = q[:, 0].float() * (1.0 / hd**0.5)  # (B, H, hd)
    kf, vf = k.float(), v.to(pdt).float()
    qpos = int(q_offset)
    hi = min(T, T if kv_len is None else int(kv_len))
    if causal:
        hi = min(hi, qpos + 1)
    lo = max(0, qpos - window + 1) if window > 0 else 0
    uniform = lo >= hi
    if uniform:
        lo, hi = 0, T
    kv = torch.arange(H) // (H // K)
    M = torch.full((B, H), float("-inf"))
    parts = []
    for s in range(plan.splits):
        keys = [t for t in _keys(plan, s) if lo <= t < hi]
        if not keys:
            parts.append((torch.full((B, H), float("-inf")), torch.zeros(B, H),
                          torch.zeros(B, H, hd)))
            continue
        ks, vs = kf[:, keys][:, :, kv], vf[:, keys][:, :, kv]  # (B, n, H, hd)
        sc = torch.einsum("bhd,bnhd->bhn", qf, ks)
        if uniform:
            sc = torch.zeros_like(sc)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bhn,bnhd->bhd", p.to(pdt).float(), vs)
        parts.append((m, p.sum(-1), acc))
        M = torch.maximum(M, m)
    L, A = torch.zeros(B, H), torch.zeros(B, H, hd)
    for m, l_, acc in parts:
        f = torch.where(m == float("-inf"), 0.0, torch.exp(m - M))
        L, A = L + l_ * f, A + acc * f[..., None]
    return (A / torch.clamp(L, min=1e-30)[..., None])[:, None].to(q.dtype)


def _qkv(B, H, K, T, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype)
            for s in ((B, 1, H, hd), (B, T, K, hd), (B, T, K, hd))]


# (name, q_offset, kv_len, causal, window): decode at the first, a middle and
# the last fill; a binding window; cross-attention over every key; no live key
EMU_CASES = [
    ("first", 0, 1, True, 0),
    ("middle", 300, 301, True, 0),
    ("last", 599, 600, True, 0),
    ("window", 400, 401, True, 37),
    ("cross", 0, None, False, 0),
    ("window-cross", 250, None, False, 100),
    ("none-live", 5, 0, True, 0),
]


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
@pytest.mark.parametrize("shape", [(3, 12, 2, 600, 32), (2, 10, 1, 600, 16), (2, 3, 3, 600, 64)],
                         ids=["g6", "g10", "g1"])
def test_split_k_emulation_equals_chunked_attention(shape, case, p_dtype):
    """The kernel's split-K function, as its plan splits the keys, is
    chunked_attention's single chunk of T keys (its decode) within float32
    sums in another order; under p_dtype="bfloat16" p is rounded after a
    split's own max rather than the row's, so to one bf16 rounding of p."""
    _, q_offset, kv_len, causal, window = case
    B, H, K, T, hd = shape
    q, k, v = _qkv(B, H, K, T, hd, torch.float32, seed=hd + H)
    kw = dict(q_offset=q_offset, kv_len=kv_len, causal=causal, window=window, p_dtype=p_dtype)
    got = _emulate(q, k, v, **kw)
    want = chunked_attention(q, k, v, kv_chunk=T, **kw)
    tol = 2e-5 if p_dtype == "float32" else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ops_decode_on_the_cpu_is_chunked_attention_bit_for_bit(case, dtype):
    """At S == 1 a CPU tensor still takes chunked_attention, the plain
    version: causal at an int and at a tensor kv_len, a window, and
    non-causal cross-attention."""
    _, q_offset, kv_len, causal, window = case
    q, k, v = _qkv(2, 12, 2, 96, 64, dtype, seed=7)
    kw = dict(causal=causal, window=window)
    want = chunked_attention(q, k, v, q_offset=q_offset, kv_len=kv_len, kv_chunk=96, **kw)
    assert torch.equal(ops.decode_attention(q, k, v, q_offset=q_offset, kv_len=kv_len, **kw),
                       want)
    if kv_len is not None:  # a captured step's position: 0-d int32 tensors
        pos = torch.tensor(q_offset, dtype=torch.int32)
        got = ops.decode_attention(q, k, v, q_offset=pos, kv_len=pos + (kv_len - q_offset), **kw)
        assert torch.equal(got, want)


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("position", ["int", "int32", "int64"])
@pytest.mark.parametrize("T", [1, 37, 600])
def test_ops_decode_attention_is_one_chunk_of_t_keys(T, position, p_dtype):
    """``ops.decode_attention`` on CPU tensors is ``chunked_attention`` over
    one chunk of all T keys, at an int position and at 0-d int32 and int64
    tensor positions (a captured step's), at the first, a middle and the
    last fill, with a scale of its own; the tensor positions give the int
    position's result bit for bit."""
    q, k, v = _qkv(3, 6, 2, T, 32, torch.bfloat16, seed=T)
    for fill in sorted({0, T // 2, T - 1}):
        want = chunked_attention(q, k, v, q_offset=fill, kv_len=fill + 1, kv_chunk=T,
                                 p_dtype=p_dtype, scale=0.3)
        pos = fill if position == "int" else torch.tensor(fill, dtype=getattr(torch, position))
        got = ops.decode_attention(q, k, v, q_offset=pos, kv_len=pos + 1, p_dtype=p_dtype,
                                   scale=0.3)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, want), fill


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_head_dim_plans_in_both_types(hd):
    for dtype in (torch.bfloat16, torch.float32):
        for g in (1, 3, 6, 8, 9):
            plan = decode_plan(2, 2 * g, 2, 100, hd, dtype, "bfloat16")
            assert plan.chunks == (1 if g <= 8 else 2) and plan.smem <= _build.MAX_SMEM
