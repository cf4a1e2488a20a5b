"""The port's ``ExecConfig.moe_impl`` and ``unroll_causal``, and the
dry-run's counting of all-to-alls and of the Griffin gates on a mesh.

* ``moe_impl="batched"``: the reduced moonshot-v1-16b-a3b's loss and
  gradients against the reference's ``Model(cfg, ExecConfig(moe_impl=
  "batched"))`` (loss within 1e-5 relative, each gradient leaf within 1e-4
  of its largest magnitude); on the reduced (4, 2) train cell of
  tests/test_dryrun_small.py, the expert products' dot FLOPs a device are
  "vmap"'s over the data axis's size, by an exact hand count, and every
  other dot FLOP is the same.  A remat recompute in a backward that runs
  without the activation_sharding context (as the card's autograd thread
  does) places as the forward did.
* ``unroll_causal``: ``chunked_attention`` against the reference's, both
  ways, at float32 (2e-5), on causal and windowed cases with a query
  offset, so that whole chunks lie beyond every query's horizon or
  outside every query's window; unrolled, its dot FLOPs fall by exactly
  the skipped chunks'.  A reduced smollm-135m decoding into a cache it
  has filled a quarter of scores only the filled chunks under the knob:
  its logits match the reference's decode (1e-4) and a step's dot FLOPs
  fall by exactly the unfilled chunks'.
* On a fake 4-rank world a Shard(0) -> Shard(1) move counts as one
  all-to-all of the local operand's bytes, with no all-gather and no
  gathered tensor in the peak.
* A reduced recurrentgemma-2b decode cell on a fake mesh with the
  multi-pod axes, whose 16-wide 'model' axis the gates' 8 diagonal blocks
  do not fill (the block-diagonal product is a partial sum there), traces
  with the same counts as the bias added to that partial sum directly.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models import ExecConfig, Model, layers, rglru  # noqa: E402
from repro_torch.roofline.trace_costs import count_costs  # noqa: E402
from repro_torch.sharding import PRESETS  # noqa: E402
from repro_torch.sharding.ctx import einsum, reshape  # noqa: E402

from test_torch_train import GRAD_REL, LOSS_REL, _batch, _grads, _numpy, _params  # noqa: E402

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_kernels.py's float32 tolerance


def test_exec_config_knobs_and_their_defaults():
    ex = ExecConfig()
    assert ex.moe_impl == RefExecConfig().moe_impl == "vmap"
    assert ex.unroll_causal is RefExecConfig().unroll_causal is False
    assert ExecConfig(moe_impl="batched", unroll_causal=True).moe_impl == "batched"
    with pytest.raises(ValueError, match="moe_impl"):
        ExecConfig(moe_impl="sparse")


# ---------------------------------------------------------------------------
# the model under the knobs, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,knobs", [
    ("moonshot-v1-16b-a3b", dict(moe_impl="batched")),
])
def test_loss_and_grads_under_the_knob_match_reference(name, knobs):
    params, batch = _params(name), _batch(name)
    ref = RefModel(ref_get_arch(name).reduced(),
                   RefExecConfig(attn_impl="xla", remat="none", **knobs))
    (want, want_metrics), want_grads = jax.value_and_grad(
        lambda p, b: ref.loss(p, b), has_aux=True)(_numpy(params),
                                                   jax.tree.map(jnp.asarray, batch))
    want_grads = {"/".join(str(k.key) for k in path): np.asarray(g)
                  for path, g in jax.tree_util.tree_leaves_with_path(want_grads)}
    port = Model(get_arch(name).reduced(), ExecConfig(attn_impl="xla", remat="none", **knobs),
                 params={}, device="cpu")
    loss, metrics, grads = _grads(port, params, batch)
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_REL)
    assert float(metrics["aux"].detach()) == pytest.approx(float(want_metrics["aux"]),
                                                           rel=LOSS_REL, abs=1e-7)
    assert sorted(grads) == sorted(want_grads)
    for path, w in want_grads.items():
        bound = GRAD_REL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=0, atol=bound, err_msg=path)


def test_batched_expert_products_split_over_the_data_axis():
    """The reduced (4, 2) moonshot train cell (8 rows of 32 tokens, 4
    experts top-2 at capacity ceil(32·2/4·1.25) = 20, remat "full"): each
    expert product runs 2·capacity·D·F FLOPs an (expert, row) in the
    forward, again in the recompute and twice in the backward, for the 2
    experts a device holds; "vmap" runs them for all 8 rows, "batched"
    for the device's 2."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    B, S, data, model = 8, 32, 4, 2
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = max(1, math.ceil(S * k / E * cfg.moe.capacity))
    per_row = 3 * 4 * 2 * cap * cfg.d_model * cfg.d_ff * (E // model) * cfg.n_layers
    dots = {}
    with fake_world(8):
        mesh = make_mesh((data, model), ("data", "model"))
        for impl in ("vmap", "batched"):
            costs, _ = dryrun.trace_cell(cfg, InputShape("t", S, B, "train"), mesh,
                                         PRESETS["fsdp_tp_sp"],
                                         ex=ExecConfig(remat="full", attn_impl="xla",
                                                       moe_impl=impl))
            dots[impl] = costs.dot_flops
    expert = {"vmap": per_row * B, "batched": per_row * (B // data)}
    assert expert["vmap"] == data * expert["batched"]
    assert dots["vmap"] - expert["vmap"] == dots["batched"] - expert["batched"] > 0


@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_recompute_in_a_backward_without_the_context_places_as_the_forward(impl, monkeypatch):
    """On the card the backward runs on the autograd engine's own thread,
    where the activation_sharding context is not set: the reduced (4, 2)
    moonshot train cell (remat "full") traces with the gradients taken in
    an empty context as it does with the context, to the same counts."""
    import contextvars

    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    ex = ExecConfig(remat="full", attn_impl="xla", moe_impl=impl)

    def trace():
        with fake_world(8):
            mesh = make_mesh((4, 2), ("data", "model"))
            costs, _ = dryrun.trace_cell(cfg, InputShape("t", 32, 8, "train"), mesh,
                                         PRESETS["fsdp_tp_sp"], ex=ex)
        return costs.dot_flops, costs.bytes, dict(costs.coll_bytes), costs.peak_bytes

    want = trace()
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: contextvars.Context().run(grad, *a, **k))
    assert trace() == want


# ---------------------------------------------------------------------------
# chunked attention: unroll_causal
# ---------------------------------------------------------------------------

# (S, T, q_offset, causal, window, kv_chunk, chunks skipped)
ATTN_CASES = {
    "causal": (16, 64, 8, True, 0, 8, 5),  # chunks from 24 lie beyond position 23
    "causal-window": (8, 48, 24, True, 12, 8, 3),  # chunk 0 out of every window; 32, 40 ahead
    "window": (8, 40, 16, False, 8, 8, 1),  # chunk 0 out of every query's window
}


def _qkv(S, T, seed=0, B=2, H=4, K=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_unrolled_chunked_attention_matches_reference(case):
    S, T, off, causal, window, chunk, _ = ATTN_CASES[case]
    q, k, v = _qkv(S, T)
    kw = dict(q_offset=off, causal=causal, window=window, kv_chunk=chunk)
    for unroll in (True, False):
        want = ref_layers.chunked_attention(*map(jnp.asarray, (q, k, v)), unroll_causal=unroll,
                                            **kw)
        got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)), unroll_causal=unroll,
                                       **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL,
                                   err_msg=f"unroll_causal={unroll}")


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_unrolling_drops_exactly_the_skipped_chunks_dot_flops(case):
    S, T, off, causal, window, chunk, skipped = ATTN_CASES[case]
    q, k, v = map(torch.from_numpy, _qkv(S, T))
    B, _, H, hd = q.shape
    dots = {}
    for unroll in (False, True):
        with count_costs() as costs:
            layers.chunked_attention(q, k, v, q_offset=off, causal=causal, window=window,
                                     kv_chunk=chunk, unroll_causal=unroll)
        dots[unroll] = costs.dot_flops
    # a chunk's two products (scores, p @ v): 2 · (2·B·H·S·chunk·hd)
    assert dots[False] - dots[True] == skipped * 4 * B * H * S * chunk * hd
    assert dots[False] == (T // chunk) * 4 * B * H * S * chunk * hd


def test_decode_under_unroll_causal_skips_the_unfilled_cache():
    """Reduced smollm-135m, a 16-token prompt, decode steps at fills 16-18
    of a 64-slot cache at kv chunks of 8: under the knob a step scores the
    3 chunks up to its fill, not the whole cache; the logits match the
    reference's decode under the same knobs (which scores the whole cache)
    and the port's without the knob."""
    from repro_torch.convert import params_from, state_from

    name, B, S, T, chunk, steps = "smollm-135m", 2, 16, 64, 8, 3
    cfg = ref_get_arch(name).reduced()
    knobs = dict(attn_impl="xla", remat="none", unroll_causal=True, kv_chunk=chunk)
    ref = RefModel(cfg, RefExecConfig(**knobs))
    params = ref.init(jax.random.PRNGKey(0))
    tree = params_from(jax.tree.map(np.asarray, params), "cpu")
    port = {u: Model(get_arch(name).reduced(), ExecConfig(**{**knobs, "unroll_causal": u}),
                     params=tree, device="cpu") for u in (True, False)}
    tok = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + steps)).astype(np.int32)
    _, state = ref.prefill(params, {"tokens": jnp.asarray(tok[:, :S])})
    pad = ((0, 0), (0, 0), (0, T - S), (0, 0), (0, 0))
    state = (jnp.pad(state[0], pad), jnp.pad(state[1], pad))
    ours = {u: state_from(jax.tree.map(np.asarray, state), "cpu") for u in port}
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    for t in range(steps):
        step = tok[:, S + t]
        want, state = ref.decode_step(params, state, jnp.asarray(step), jnp.int32(S + t))
        got, dots = {}, {}
        for u, model in port.items():
            with count_costs() as costs:
                got[u], ours[u] = model.decode_step(ours[u], torch.from_numpy(step), S + t)
            dots[u] = costs.dot_flops
            np.testing.assert_allclose(got[u].numpy(), np.asarray(want), atol=1e-4, rtol=1e-4,
                                       err_msg=f"unroll_causal={u}")
        kept = (S + t) // chunk + 1
        # each layer's two products (scores, p @ v) over T keys, or over
        # the kept chunks' keys: 2 · (2·B·H·keys·hd)
        assert dots[False] - dots[True] == cfg.n_layers * 4 * B * H * (T - kept * chunk) * hd


@pytest.mark.parametrize("unroll", [False, True], ids=["whole", "unroll"])
@pytest.mark.parametrize("position", ["int", "tensor"])
@pytest.mark.parametrize("S", [1, 3], ids=["decode", "continuation"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_cached_attention_makes_one_plain_call_with_the_knobs_it_honours(monkeypatch, impl, S,
                                                                         position, unroll):
    """Queries against a cache on CPU tensors, on either ``attn_impl``, at
    an int or a 0-d tensor position, with ``unroll_causal`` on or off: one
    ``chunked_attention`` call (``ops.decode_attention``'s plain route for
    one query on ``"pallas"``, the model's own otherwise) over all T keys
    as one chunk for one query, over ``kv_chunk`` keys a chunk where the
    knob skips or more queries come, the knob honoured at an int position
    alone; the step's output is that call's."""
    from repro_torch.kernels import decode_attention
    from repro_torch.models import transformer

    T, chunk, pos = 24, 8, 9
    calls = []
    real = layers.chunked_attention

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(transformer, "chunked_attention", spy)
    monkeypatch.setattr(decode_attention, "chunked_attention", spy)
    q, k, v = map(torch.from_numpy, _qkv(S, T, seed=3))
    idx = pos if position == "int" else torch.tensor(pos)
    ex = ExecConfig(attn_impl=impl, unroll_causal=unroll, kv_chunk=chunk)
    got = transformer._cached_attention(ex, q, k, v, idx)
    skip = unroll and position == "int"
    (kw,) = calls
    assert kw["kv_chunk"] == (T if S == 1 and not skip else chunk)
    assert kw.get("unroll_causal", False) == skip
    assert kw["q_offset"] is idx and int(kw["kv_len"]) == pos + S
    assert kw.get("causal", True) and not kw.get("window", 0) and kw.get("scale") is None
    assert torch.equal(got, real(q, k, v, q_offset=idx, kv_len=idx + S, kv_chunk=kw["kv_chunk"],
                                 unroll_causal=skip))


# ---------------------------------------------------------------------------
# the dry-run's counts: all-to-alls, and the Griffin gates' partial sum
# ---------------------------------------------------------------------------


def test_a_shard_to_shard_move_counts_as_one_all_to_all():
    from torch.distributed.tensor import DTensor, Shard

    n, B, S, D = 4, 8, 32, 16
    local = B // n * S * D * 4
    with fake_world(n):
        mesh = make_mesh((n,), ("model",))
        x = DTensor.from_local(torch.empty(B // n, S, D, device="meta"), mesh, [Shard(0)],
                               run_check=False)
        with count_costs() as costs:
            y = x.redistribute(mesh, [Shard(1)])
    assert tuple(y.to_local().shape) == (B, S // n, D)
    assert costs.coll_counts["all-to-all"] == 1 and costs.coll_bytes["all-to-all"] == local
    assert costs.coll_counts["all-gather"] == costs.coll_bytes["all-gather"] == 0
    assert costs.peak_bytes == local  # the output alone: no gathered (B, S, D) copy
    assert costs.bytes == 2 * local  # the all-to-all's input and output, nothing else


def _bias_on_the_partial_sum(x, w, b):
    """The gates' block-diagonal product with the bias added to the
    product as it comes (on the mesh below, a partial sum)."""
    B, S, W = x.shape
    nb, wb = w.shape[0], w.shape[1]
    y = einsum("bsnw,nwv->bsnv", reshape(x, B, S, nb, wb), w.to(x.dtype))
    return reshape(y, B, S, W) + b.to(x.dtype)


def test_griffin_decode_cell_traces_on_the_multi_pod_axes(monkeypatch):
    """Reduced recurrentgemma-2b with an LRU width of 128 (blocks of 16,
    which the 16-wide 'model' axis splits: the product contracts a sharded
    dim) decoding at a 64-slot cache on a (2, 2, 16) mesh with sp_serve,
    the decode preset."""
    from torch.distributed.tensor import DTensor

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").reduced(), lru_width=128)
    products = []

    def spy(eq, *ops):
        out = einsum(eq, *ops)
        if eq == "bsnw,nwv->bsnv" and isinstance(out, DTensor):
            products.append(any(p.is_partial() for p in out.placements))
        return out

    def trace():
        with fake_world(64):
            mesh = make_mesh((2, 2, 16), ("pod", "data", "model"))
            costs, _ = dryrun.trace_cell(cfg, InputShape("d", 64, 8, "decode"), mesh,
                                         PRESETS["sp_serve"])
        return (costs.dot_flops, costs.ew_flops, costs.bytes, dict(costs.coll_bytes),
                dict(costs.coll_counts), costs.peak_bytes)

    monkeypatch.setattr(rglru, "einsum", spy)
    got = trace()
    assert products and all(products)  # every gate's product a partial sum
    monkeypatch.setattr(rglru, "_block_diag", _bias_on_the_partial_sum)
    assert got == trace()
    assert got[3]["reduce-scatter"] > 0


@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_moe_rows_are_gathered_whole_when_the_sequence_is_on_the_experts_axis(impl,
                                                                              monkeypatch):
    """sp_serve puts a prefill's sequence on 'model', the experts' axis.
    The routing (``rowwise``) and, under "batched", the slot fill
    (``expertwise``) then each gather x's rows whole: an all-gather of x's
    local shard, no all-to-all.  An all-to-all cannot take its place
    exactly: a row's pairs go to experts by data-dependent counts, and the
    reference routes each row whole with one capacity.  The load-balance
    loss reshapes the sequence-split router probabilities
    (``ctx.reshape``: DTensor cannot merge a split non-leading dim)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import activation_sharding
    from repro_torch.sharding.rules import placements, resolve_spec

    B, S, D, E, F, k = 4, 32, 16, 8, 24, 2
    seen = {}

    def spy(name, real):
        def run(fn, *args, **kwargs):
            before = dict(costs.coll_bytes)
            out = real(fn, *args, **kwargs)
            seen.setdefault((name, fn.__name__), []).append(
                {op: costs.coll_bytes[op] - before[op] for op in before})
            return out
        return run

    monkeypatch.setattr(layers, "rowwise", spy("rowwise", layers.rowwise))
    monkeypatch.setattr(layers, "expertwise", spy("expertwise", layers.expertwise))
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        rules = PRESETS["sp_serve"]

        def put(shape, axes):
            pl = placements(resolve_spec(axes, shape, mesh, rules), mesh)
            local = [n // math.prod(mesh.shape[j] for j, p in enumerate(pl) if p.is_shard(d))
                     for d, n in enumerate(shape)]
            return DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                                      run_check=False)

        x = put((B, S, D), ("batch", "seq", None))
        ws = [put((D, E), ("embed", None)), put((E, D, F), ("expert", "embed", None)),
              put((E, D, F), ("expert", "embed", None)), put((E, F, D), ("expert", None, "embed"))]
        with activation_sharding(mesh, rules), count_costs() as costs:
            out, probs = layers.moe_layer(x, *ws, top_k=k, capacity_factor=1.25, impl=impl)
            layers.moe_aux_loss(probs, k)
    x_local = B // 2 * S // 4 * D * 4
    router_local = D // 2 * E * 4
    assert tuple(out.shape) == (B, S, D) and out.placements == x.placements
    route = seen[("rowwise", "_route" if impl == "batched" else "_dispatch")]
    assert route == [{**dict.fromkeys(route[0], 0), "all-gather": x_local + router_local}]
    if impl == "batched":
        assert seen[("expertwise", "_slots")] == [
            {**dict.fromkeys(route[0], 0), "all-gather": x_local}]
    assert costs.coll_bytes["all-to-all"] == 0
