"""The port's compiled serving steps: ``ServeEngine(jit=True)``.

On the CPU: ``Model.decode_step`` at a 0-d tensor position equals the int
position bit for bit in all six families (the hybrid's ring cache wrapping
past its reduced window of 16); ``sharding.ctx.write_slice`` at a tensor
start equals ``narrow().copy_()``; ``ServeEngine(jit=True)`` on a CPU model
captures nothing and gives the JAX package's greedy tokens, from both of
its engines (``jit=True`` and ``jit=False``), on the same weights carried
across by ``convert.params_from``; ``_pad_cache_to`` writing into kept
buffers equals its eager growth, and prompts of two lengths share them; an
int decode position past the KV cache raises; the graph wrapper's
signatures; the kernels' launch counts and the launches a profiler's
kernel names, or a printed CUDA graph's kernel nodes, stand for.

On the card (``needs_cuda``): captured and eager ``generate`` give equal
tokens in every family; a second ``generate`` of the same shapes replays
without a new capture, and a new prompt of those shapes gives the eager
tokens (stale or aliased pool memory would not); a new shape captures
anew; a replay runs no kernel wrapper (their counts stay), launches the
kernels its graph's nodes name, advances the graph's replay tally, and its
kernels show among the device kernels a profiler traces; a host read planted in a captured step raises, with no
eager retry.
"""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch._tree import leaves, unflatten  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import decode_launches, prefill_launches  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _pad_cache_to  # noqa: E402
from repro_torch.graphs import CudaGraphStep, kernel_nodes, signature  # noqa: E402
from repro_torch.sharding.ctx import write_slice  # noqa: E402

ARCHS = ["smollm-135m", "mamba2-130m", "recurrentgemma-2b", "moonshot-v1-16b-a3b",
         "qwen2-vl-2b", "seamless-m4t-large-v2"]  # dense, ssm, hybrid, moe, vlm, encdec
B = 2
GRID = 2  # the VLM's prompt: a GRID x GRID patch prefix, then text
ENC_LEN = 10  # the enc-dec's encoder frames


def _mrope_positions(grid: int, n_text: int) -> np.ndarray:
    r, c = np.divmod(np.arange(grid * grid), grid)
    patches = np.stack([np.zeros_like(r), r, c], axis=-1)
    text = np.repeat((grid + np.arange(n_text))[:, None], 3, axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(np.concatenate([patches, text])[None], (B, grid * grid + n_text, 3)))


def _batch(cfg, S: int, seed: int) -> dict:
    """A prompt of S positions for the family, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_tok = S - GRID * GRID if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, GRID * GRID, cfg.d_model)).astype(
            np.float32)
        batch["positions"] = _mrope_positions(GRID, n_tok).astype(np.int32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _model(name: str, device, seed: int = 0) -> Model:
    cfg = get_arch(name).reduced()
    return Model(cfg, generator=torch.Generator(device).manual_seed(seed), device=device)


def _equal_trees(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))


# ---------------------------------------------------------------------------
# the decode position as a device scalar (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_at_a_tensor_position_equals_the_int_position(name):
    """Each step's logits and every state leaf, bit for bit; the hybrid's
    prompt of 13 decodes at positions 13-18, so its ring of 16 slots wraps."""
    model = _model(name, "cpu", seed=3)
    S, steps = (13, 6) if model.cfg.family == "hybrid" else (12, 3)
    batch = _torch(_batch(model.cfg, S, 5))
    _, state = model.prefill(batch)
    state = _pad_cache_to(state, model, S + steps)
    st_int = unflatten(state, [t.clone() for t in leaves(state)])
    st_tensor = unflatten(state, [t.clone() for t in leaves(state)])
    tok = batch["tokens"][:, 0]
    for t in range(steps):
        log_int, st_int = model.decode_step(st_int, tok, S + t)
        log_t, st_tensor = model.decode_step(st_tensor, tok,
                                             torch.tensor(S + t, dtype=torch.int32))
        assert torch.equal(log_int, log_t), (name, t)
        assert _equal_trees(st_int, st_tensor), (name, t)
        tok = torch.argmax(log_int, dim=-1).to(torch.int32)


@pytest.mark.parametrize("dim,start,n", [(1, 0, 1), (1, 5, 1), (1, 9, 1), (1, 3, 4), (2, 2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_slice_at_a_tensor_start_equals_narrow_copy(dim, start, n, dtype):
    g = torch.Generator().manual_seed(start * 7 + n)
    dst = torch.randn((2, 10, 6, 4), generator=g).to(dtype)
    shape = list(dst.shape)
    shape[dim] = n
    src = torch.randn(shape, generator=g)  # float32: rounded to dst's type on the way in
    want = dst.clone()
    want.narrow(dim, start, n).copy_(src)
    got = dst.clone()
    write_slice(got, src, torch.tensor(start, dtype=torch.int32), dim=dim)
    assert torch.equal(got, want)
    again = dst.clone()
    write_slice(again, src, start, dim=dim)
    assert torch.equal(again, want)


@pytest.mark.parametrize("name", ARCHS)
def test_pad_cache_into_buffers_equals_the_eager_growth(name):
    """``_pad_cache_to`` into kept buffers (a captured prefill's path) gives
    the eager growth bit for bit; a second, shorter prompt of the same batch
    size reuses the same buffers (its KV caches' tails zeroed again), bar an
    enc-dec model's cross caches, which follow the encoder's length."""
    model = _model(name, "cpu", seed=12)
    family, max_len = model.cfg.family, 20
    buffers: dict = {}
    firsts = None
    for S in (12, 9):
        batch = _batch(model.cfg, S, S)
        if family == "encdec" and S == 9:
            batch["enc_embeds"] = batch["enc_embeds"][:, :7]  # another encoder length
        _, state = model.prefill(_torch(batch))
        want = _pad_cache_to(state, model, max_len)
        got = _pad_cache_to(state, model, max_len, buffers)
        assert _equal_trees(got, want) and signature(got) == signature(want)
        if firsts is None:
            firsts = leaves(got)
            for t in firsts:
                t.fill_(7)  # a decode's writes, which the next prefill must clear
            n_buffers = len(buffers)
            continue
        kept = [a is b for a, b in zip(leaves(got), firsts, strict=True)]
        if family == "encdec":  # the self caches kept, the cross caches new
            assert kept == [False, False, True, True] and len(buffers) == n_buffers + 2
        else:
            assert all(kept) and len(buffers) == n_buffers


@pytest.mark.parametrize("name", ["smollm-135m", "seamless-m4t-large-v2", "recurrentgemma-2b"])
def test_decode_past_the_kv_cache_raises(name):
    """``ServeEngine.decode`` checks an int position against the KV cache
    (on the card a captured write past it would be a device-side fault);
    the hybrid's ring cache takes any position."""
    model = _model(name, "cpu", seed=13)
    S = 8
    engine = ServeEngine(model, ServeConfig(max_len=10))
    last, state = engine.prefill(_batch(model.cfg, S, 14))
    tok = torch.argmax(last, -1).to(torch.int32)
    logits, state = engine.decode(state, tok, 9)  # the cache's last position
    if model.cfg.family == "hybrid":
        assert engine.decode(state, tok, 40)[0].shape == logits.shape
        return
    for idx in (10, -1):
        with pytest.raises(IndexError, match="outside the KV cache's 10 positions"):
            engine.decode(state, tok, idx)


# ---------------------------------------------------------------------------
# the engine on the CPU against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_jit_engine_on_the_cpu_gives_the_reference_greedy_tokens(name):
    """The port's ``ServeEngine`` (``jit=True``, the default, on a CPU
    model: eager steps) against the reference's under ``jax.jit`` and
    without it, on the same weights."""
    cfg = ref_get_arch(name).reduced()
    ref = RefModel(cfg, RefExecConfig(attn_impl="xla", remat="none"))
    params = ref.init(jax.random.PRNGKey(7))
    port = Model(get_arch(name).reduced(),
                 params=params_from(jax.tree.map(np.asarray, params), "cpu"), device="cpu")
    S, new = (13, 6) if cfg.family == "hybrid" else (12, 5)
    batch = _batch(cfg, S, 11)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    engine = ServeEngine(port, ServeConfig(max_len=S + new))
    assert engine.jit and not isinstance(engine._prefill, CudaGraphStep)
    got = engine.generate(batch, new)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    for jit in (True, False):
        want = RefServeEngine(ref, params, RefServeConfig(max_len=S + new), jit=jit).generate(
            ref_batch, new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"jit={jit}")
    eager = ServeEngine(port, ServeConfig(max_len=S + new), jit=False).generate(batch, new)
    assert torch.equal(got, eager)


def test_engine_prefill_and_decode_are_generate_step_by_step():
    """``ServeEngine.prefill`` / ``.decode``, the steps ``generate`` runs,
    at an int and at a tensor position."""
    model = _model("smollm-135m", "cpu", seed=2)
    S, new = 9, 4
    batch = _batch(model.cfg, S, 3)
    engine = ServeEngine(model, ServeConfig(max_len=S + new))
    want = engine.generate(batch, new)
    last, state = engine.prefill(batch)
    assert tuple(state[0].shape) == (model.cfg.n_layers, B, S + new, model.cfg.n_kv_heads,
                                     model.cfg.head_dim)
    toks = [torch.argmax(last, -1).to(torch.int32)]
    for t in range(1, new):
        idx = S + t - 1 if t % 2 else torch.tensor(S + t - 1, dtype=torch.int32)
        logits, state = engine.decode(state, toks[-1], idx)
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(torch.stack(toks, 1), want)


@pytest.mark.parametrize("name", ["smollm-135m", "seamless-m4t-large-v2", "mamba2-130m"])
def test_generate_past_the_cache_raises_before_it_starts(name):
    """A KV cache of ``max(max_len, prompt)`` positions holds the prompt and
    ``max_len - prompt + 1`` new tokens (the last one is never written); one
    more raises before the prefill (on the card a captured write past the
    cache would be a device-side fault).  The SSM state is fixed-size."""
    model = _model(name, "cpu", seed=9)
    S = 10
    batch = _batch(model.cfg, S, 4)
    engine = ServeEngine(model, ServeConfig(max_len=14))
    assert engine.generate(batch, 5).shape == (B, 5)
    if model.cfg.family == "ssm":
        assert engine.generate(batch, 9).shape == (B, 9)
        return
    with pytest.raises(ValueError, match="need 15 cache positions; the cache holds 14"):
        engine.generate(batch, 6)


def test_graph_step_needs_a_cuda_device_and_signatures_are_abstract():
    with pytest.raises(ValueError, match="CUDA device"):
        CudaGraphStep(lambda x: x, torch.device("cpu"))
    a = {"tokens": torch.zeros((2, 5), dtype=torch.int32), "x": (torch.ones(3), torch.ones(2))}
    b = {"x": (torch.full((3,), 7.0), torch.zeros(2)), "tokens": torch.ones((2, 5),
                                                                          dtype=torch.int32)}
    assert signature(a) == signature(b)  # values and key order do not count
    assert signature(a) != signature({**a, "tokens": torch.zeros((2, 6), dtype=torch.int32)})
    assert signature(a) != signature({**a, "tokens": torch.zeros((2, 5), dtype=torch.int64)})
    assert signature((torch.ones(2),)) != signature([torch.ones(2)])
    with pytest.raises(TypeError, match="tensors"):
        signature((torch.ones(2), 3))


def test_launch_counts_read_reset_add_and_delta():
    saved = counts.read()
    try:
        assert set(saved) == {"placement_sweep", "placement_sweep_batch", "flash_attention",
                              "flash_attention_mma", "decode_attention", "mla_decode",
                              "ssd_scan", "ssd_scan_mma", "rglru_scan", "rotary"}
        counts.reset()
        assert set(counts.read().values()) == {0}
        before = counts.read()
        counts.add({"flash_attention": 3, "flash_attention_mma": 2, "rglru_scan": 1})
        after = counts.read()
        assert counts.delta(after, before) == {"flash_attention": 3, "flash_attention_mma": 2,
                                               "rglru_scan": 1}
        counts.add({"flash_attention": -3, "flash_attention_mma": -2, "rglru_scan": -1})
        assert counts.read() == before
    finally:
        counts.reset()
        counts.add(saved)
    assert counts.read() == saved


def test_launches_seen_from_kernel_names():
    """Each wrapper launch by the device kernels a profiler names: one
    flash kernel either way, the bf16 SSD scan's four passes one launch."""
    names = ["void flash_attention_kernel_mma<64>(__nv_bfloat16 const*)",
             "void flash_attention_kernel<float, 64>(float const*)",
             "void ssd_chunk_kernel<64>(float)", "void ssd_score_kernel(float)",
             "void ssd_state_kernel(float)", "void ssd_out_kernel<64>(float)",
             "void ssd_scan_kernel<float, 2>(float)",
             "void (anonymous namespace)::rglru_chunk_scan_kernel<float, float, true>(float)",
             "placement_sweep_kernel(Stack, Plan)", "placement_sweep_batch_kernel(Stack, Plan)",
             "Memcpy HtoD (Pageable -> Device)", "void at::native::elementwise_kernel<128>()",
             "flash_attention_kernel_mma_extra"]
    assert counts.seen(names) == {"placement_sweep": 1, "placement_sweep_batch": 1,
                                  "flash_attention": 2, "flash_attention_mma": 1,
                                  "ssd_scan": 2, "ssd_scan_mma": 1, "rglru_scan": 1}
    assert counts.seen(names[-3:]) == {}


# Nodes of a captured prefill as cudaGraphDebugDotPrint prints them (on an
# H100, CUDA 12.8): kernel nodes named by their mangled symbols, a copy node
_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 214) | _ZN2at6native24vectorized_gather_kernelILi16ElEEvPcS2_PT0_illllb\<\<\<128,32,0\>\>\>}
| {{node handle | func handle} | {0x0000000015A144E0 | 0x000000000B223FC0}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 164) | _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897922flash_attention_kernelIfLi16EEEvPKT_S3_S3_PS1_iiiiiiif\<\<\<\{1,8\},256,0\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 178) | _ZN55_GLOBAL__N__d7916f47_22_flash_attention_mma_cu_179f251526flash_attention_kernel_mmaILi16EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiiiifi\<\<\<8,128,15360\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 206) | _ZN48_GLOBAL__N__b5b04d4c_15_ssd_scan_mma_cu_0513e47816ssd_chunk_kernelILi16EEEvPK13__nv_bfloat16PKfS5_S3_PfS6_iiiiiii\<\<\<256,256,47712\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_4"[style="bold" shape="record" label="{KERNEL
| {ID | 4 (topoId: 203) | _ZN48_GLOBAL__N__b5b04d4c_15_ssd_scan_mma_cu_0513e47814ssd_out_kernelILi16EEEvPK13__nv_bfloat16PKfS5_S3_S5_S5_S3_PS1_iiiiiiiii\<\<\<256,128,38144\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_5"[style="bold" shape="record" label="{KERNEL
| {ID | 5 (topoId: 175) | _ZN46_GLOBAL__N__d8a8c85f_13_rglru_scan_cu_1719ef2723rglru_chunk_scan_kernelI13__nv_bfloat16S1_Lb1EEEvPKT_S4_S4_PKT0_PS2_Pfiifi\<\<\<4,128,26880\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_6"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {6 (topoId: 5) | 0x0000000015B9B1B0}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


def test_kernel_nodes_of_a_printed_graph_stand_for_the_wrappers_launches():
    """A CUDA graph's kernel nodes, read from its printed DOT, and the
    wrappers' launches their mangled names stand for (a replay launches
    each node once): the length before a mangled symbol tells the flash
    kernel from its tensor-core one."""
    nodes = kernel_nodes(_DOT)
    assert len(nodes) == 6 and all(n.startswith("| {ID | ") for n in nodes)
    assert counts.seen(nodes) == {"flash_attention": 2, "flash_attention_mma": 1,
                                  "ssd_scan": 1, "ssd_scan_mma": 1, "rglru_scan": 1}
    assert counts.seen(nodes[:2]) == {"flash_attention": 1}
    assert kernel_nodes(_DOT.replace("{KERNEL", "{MEMSET")) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counted(run):
    counts.reset()
    out = run()
    return out, {k: n for k, n in counts.read().items() if n}


def _traced_launches(run):
    """``run()``'s result and the wrappers' launches its device kernels,
    traced by torch.profiler, stand for.  The card idles 50 ms inside each
    edge of the profiler's window, which drops device events near them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        out = run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.key for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert names, "the profiler recorded no device event"
    return out, counts.seen(names)


def _shows(seen: dict, want: dict) -> bool:
    """A trace ``seen`` shows every kernel of ``want`` launched, and no
    other: the profiler drops a device record now and then (1 of 72 flash
    launches in a traced replay on an H100), so a count may fall short, but
    none is made up."""
    return set(seen) == set(want) and all(1 <= seen[k] <= want[k] for k in want)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ARCHS)
def test_captured_generate_equals_eager_and_replays(cuda_device, name):
    model = _model(name, cuda_device, seed=1)
    S, new = (13, 6) if model.cfg.family == "hybrid" else (12, 5)
    cfg = ServeConfig(max_len=S + new)
    eager, captured = ServeEngine(model, cfg, jit=False), ServeEngine(model, cfg)
    want = prefill_launches(model.cfg)  # float32: no tensor-core launch
    step = decode_launches(model.cfg, 1)  # a decode step's
    first, second = (_torch(_batch(model.cfg, S, seed), cuda_device) for seed in (1, 2))
    got, n_first = _counted(lambda: captured.generate(first, new))  # captures both steps
    assert torch.equal(got, eager.generate(first, new))
    assert len(captured._prefill.graphs) == len(captured._decode.graphs) == 1
    assert n_first == counts.total(want, step)  # the eager warm-ups' launches
    assert captured._prefill.replayed == {}
    (again, seen), n_again = _counted(
        lambda: _traced_launches(lambda: captured.generate(first, new)))  # replays
    assert torch.equal(again, got) and n_again == {}  # a replay runs no wrapper
    (prefill_key,), (decode_key,) = captured._prefill.graphs, captured._decode.graphs
    assert captured._prefill.launches(prefill_key) == want  # the graph's kernel nodes
    assert captured._decode.launches(decode_key) == step
    steps = decode_launches(model.cfg, new - 1)
    assert _shows(seen, counts.total(want, steps)) and captured._prefill.replayed == want
    other, n_other = _counted(lambda: captured.generate(second, new))
    _, n_eager = _counted(lambda: eager.generate(second, new))
    assert torch.equal(other, eager.generate(second, new))
    assert n_other == {} and n_eager == counts.total(want, steps)
    assert captured._prefill.replayed == {k: 2 * n for k, n in want.items()}
    assert len(captured._prefill.graphs) == len(captured._decode.graphs) == 1
    assert len(captured._prefill.captures) == len(captured._decode.captures) == 1


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-2b"])
def test_a_new_shape_captures_anew(cuda_device, name):
    """Another prompt length is another prefill graph; the grown decode
    state is the same (max_len) for a dense model, whose decode graph is
    shared, and fixed-size for the hybrid.  Another batch size is a new
    graph of each step."""
    model = _model(name, cuda_device, seed=4)
    cfg = ServeConfig(max_len=24)
    eager, captured = ServeEngine(model, cfg, jit=False), ServeEngine(model, cfg)
    for S, b in ((10, B), (14, B), (10, 3)):
        batch = {"tokens": torch.from_numpy(np.random.default_rng(S + b).integers(
            0, model.cfg.vocab, (b, S)).astype(np.int32)).to(cuda_device)}
        assert torch.equal(captured.generate(batch, 5), eager.generate(batch, 5)), (S, b)
    assert len(captured._prefill.graphs) == 3
    assert len(captured._decode.graphs) == 2  # one a batch size
    n_leaves = len(leaves(model.abstract_state(B, cfg.max_len)))
    assert len(captured._buffers) == 2 * n_leaves  # a decode state a batch size
    assert {shape[1] for _, shape, _ in captured._buffers} == {B, 3}


@pytest.mark.needs_cuda
def test_a_host_read_in_a_captured_step_raises_without_an_eager_retry(cuda_device):
    model = _model("smollm-135m", cuda_device, seed=5)
    real = model.prefill
    calls = []

    def prefill_with_host_read(batch):
        calls.append(int(batch["tokens"].sum().item()))  # a sync: illegal while capturing
        return real(batch)

    model.prefill = prefill_with_host_read
    engine = ServeEngine(model, ServeConfig(max_len=16))
    batch = _torch(_batch(model.cfg, 8, 6), cuda_device)
    with pytest.raises(RuntimeError):
        engine.generate(batch, 3)
    assert len(calls) == 1  # the warm-up read; the capture raised at its read
    assert not engine._prefill.graphs and not engine._decode.graphs
    torch.cuda.synchronize()
    del model.prefill  # the real step again: the engine still captures and serves
    eager = ServeEngine(model, ServeConfig(max_len=16), jit=False).generate(batch, 3)
    assert torch.equal(ServeEngine(model, ServeConfig(max_len=16)).generate(batch, 3), eager)


@pytest.mark.needs_cuda
def test_a_failed_capture_leaves_no_allocation_routed_into_its_pool(cuda_device):
    """After a capture that raised (a host read inside it), the step's pool
    takes no more allocations (ending them again finds nothing to end),
    and a block freed afterwards goes back to the device on
    ``empty_cache``: with the routing left open the caching allocator kept
    every later engine's blocks."""
    model = _model("smollm-135m", cuda_device, seed=5)
    real = model.prefill
    model.prefill = lambda batch: (int(batch["tokens"].sum().item()), real(batch))[1]
    engine = ServeEngine(model, ServeConfig(max_len=16))
    with pytest.raises(RuntimeError):
        engine.generate(_torch(_batch(model.cfg, 8, 6), cuda_device), 3)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), engine._prefill.pool)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    block = torch.empty(1 << 30, dtype=torch.uint8, device=cuda_device)
    assert torch.cuda.memory_reserved() >= before + (1 << 30)
    del block
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == before


@pytest.mark.needs_cuda
def test_decode_step_at_a_device_position_equals_the_int_position_on_the_card(cuda_device):
    model = _model("recurrentgemma-2b", cuda_device, seed=6)
    S = 13
    batch = _torch(_batch(model.cfg, S, 7), cuda_device)
    _, state = model.prefill(batch)
    other = unflatten(state, [t.clone() for t in leaves(state)])
    tok = batch["tokens"][:, 0]
    for t in range(6):
        a, state = model.decode_step(state, tok, S + t)
        b, other = model.decode_step(other, tok, torch.tensor(S + t, dtype=torch.int32,
                                                               device=cuda_device))
        assert torch.equal(a, b) and _equal_trees(state, other)
        tok = torch.argmax(a, -1).to(torch.int32)


@pytest.mark.needs_cuda
def test_bf16_captured_generate_runs_on_the_tensor_core_kernels(cuda_device):
    """A reduced dense model at bfloat16: every flash launch of a captured
    generate is a tensor-core one, the eager warm-up's as counted by the
    wrapper and a replay's as the graph's kernel nodes name them; the
    profiler sees them run."""
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(), dtype="bfloat16")
    model = Model(cfg, generator=torch.Generator(cuda_device).manual_seed(8), device=cuda_device,
                  dtype=torch.bfloat16)
    engine = ServeEngine(model, ServeConfig(max_len=32))
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 24), device=cuda_device,
                                     generator=torch.Generator(cuda_device).manual_seed(9))}
    want = {"flash_attention": cfg.n_layers, "flash_attention_mma": cfg.n_layers,
            "rotary": cfg.n_layers}
    _, n = _counted(lambda: engine.generate(batch, 4))  # the warm-up and the captures
    assert n == counts.total(want, decode_launches(cfg, 1))
    (_, seen), n = _counted(lambda: _traced_launches(lambda: engine.generate(batch, 4)))
    (key,) = engine._prefill.graphs
    assert n == {} and engine._prefill.launches(key) == want
    assert _shows(seen, counts.total(want, decode_launches(cfg, 3)))
