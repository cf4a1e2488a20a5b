"""The port's MoE, VLM (M-RoPE) and encoder-decoder models against the JAX
package's, on the CPU.

Reduced moonshot-v1-16b-a3b (top-2 of 4 experts: at the default capacity
factor of 1.25, which drops tokens here, and at a factor of 2, which keeps
every token), qwen2-vl-2b (a patch-embedding prefix on a 4 x 4 grid, with
distinct t, h and w position streams, then text) and seamless-m4t-large-v2
(2 encoder and 3 decoder layers, fewer encoder frames than decoder tokens)
run on the reference's own weights, carried across by
``convert.params_from``.  ``forward`` logits and the MoE aux loss,
``prefill`` logits and every state leaf are held against the reference
under both of its attention paths (the Pallas kernel in interpret mode,
and XLA) and, for the MoE model, both of its ``moe_impl``s; ``decode_step``
continues from the reference's prefill state (``convert.state_from``); all
at the tolerance of the reference's model tests (1e-4).  Greedy ``generate``
tokens equal the reference's.  Also: ``moe_layer`` alone where it drops
tokens, ``apply_mrope`` alone on a 16 x 16 patch grid, and the spec trees
and parameter counts of all ten registered archs.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs.base import MoESpec as RefMoESpec  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.params import map_specs as ref_map_specs  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve.engine import _pad_cache_to as ref_pad_cache_to  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.convert import params_from, state_from  # noqa: E402
from repro_torch.models import Model, init_params, map_specs, param_count  # noqa: E402
from repro_torch.models import encdec, layers, rglru, ssm, transformer  # noqa: E402
from repro_torch.models.model import PORTED_FAMILIES, VLM_PATCHES  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _pad_cache_to  # noqa: E402

from test_torch_models import _port_leaves, _ref_leaves  # noqa: E402

# "name@nodrop": the reduced MoE config at capacity factor 2 (capacity = S:
# no expert can overflow).
ARCHS = ["moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b@nodrop", "qwen2-vl-2b",
         "seamless-m4t-large-v2"]
B, S, EXTRA = 2, 24, 3
GRID = 4  # the VLM prompt: a GRID x GRID patch grid, then S - GRID**2 text tokens
ENC_LEN = 20  # the enc-dec prompt: 20 frames against S decoder tokens
TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_models.py's prefill/decode tolerance


def _reduced(get, moe_spec, name):
    base, _, variant = name.partition("@")
    cfg = get(base).reduced()
    if variant == "nodrop":
        cfg = dataclasses.replace(cfg, moe=moe_spec(cfg.moe.n_experts, cfg.moe.top_k, 2.0))
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, its params, the port's model on them)."""
    cfg = _reduced(ref_get_arch, RefMoESpec, request.param)
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    port = Model(_reduced(get_arch, MoESpec, request.param),
                 params=params_from(jax.tree.map(np.asarray, params), "cpu"), device="cpu")
    return request.param, cfg, params, port


def _mrope_positions(batch: int, grid: int, n_text: int) -> np.ndarray:
    """Qwen2-VL's position ids: patch (r, c) at (t, h, w) = (0, r, c), then
    text token i at grid + i in all three streams."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    patches = np.stack([np.zeros_like(r), r, c], axis=-1)
    text = np.repeat((grid + np.arange(n_text))[:, None], 3, axis=1)
    return np.broadcast_to(np.concatenate([patches, text])[None], (batch, grid * grid + n_text, 3))


def _batch(cfg, seed, n=S + EXTRA) -> dict:
    """A prompt of n positions for the family, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n_text = n - GRID * GRID
        return {"tokens": rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32),
                "patch_embeds": rng.standard_normal((B, GRID * GRID, cfg.d_model)).astype(
                    np.float32),
                "positions": _mrope_positions(B, GRID, n_text).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return batch


def _cut(cfg, batch, n) -> dict:
    """The batch's first n positions (the VLM's patches count)."""
    out = dict(batch)
    if cfg.family == "vlm":
        out["tokens"] = batch["tokens"][:, : n - GRID * GRID]
        out["positions"] = batch["positions"][:, :n]
    else:
        out["tokens"] = batch["tokens"][:, :n]
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _impls(cfg):
    return [("pallas", "vmap"), ("xla", "vmap")] + (
        [("pallas", "batched"), ("xla", "batched")] if cfg.family == "moe" else [])


def _ref_ex(attn, moe="vmap"):
    return RefExecConfig(attn_impl=attn, remat="none", moe_impl=moe)


def _forward(cfg, ex_or_model, params, batch, port: bool):
    if cfg.family == "encdec":
        fn = encdec.encdec_forward if port else ref_encdec.encdec_forward
    else:
        fn = transformer.lm_forward if port else ref_transformer.lm_forward
    return fn(cfg, ex_or_model, params, batch)


def _step_tokens(cfg, batch, t):
    """The decode input at prompt position S + t."""
    tok = batch["tokens"]
    return tok[:, tok.shape[1] - EXTRA + t]


def _ref_prefill_state(cfg, params, batch, ex):
    ref = RefModel(cfg, ex)
    last, state = ref.prefill(params, _jnp(_cut(cfg, batch, S)))
    return ref, last, ref_pad_cache_to(state, cfg.family, S + EXTRA)


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


def test_forward_logits_and_aux_match_reference(pair):
    _, cfg, params, port = pair
    batch = _batch(cfg, 7)
    got_logits, got_aux = _forward(cfg, port.ex, port.params, _torch(batch), port=True)
    assert got_logits.shape == (B, S + EXTRA, cfg.vocab) and got_aux.dtype == torch.float32
    for attn, moe in _impls(cfg):
        want_logits, want_aux = _forward(cfg, _ref_ex(attn, moe), params, _jnp(batch), port=False)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL,
                                   err_msg=f"{attn}/{moe}")
        np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    if cfg.family == "moe":
        assert float(got_aux) > 0
    np.testing.assert_array_equal(port.forward(_torch(batch)).numpy(), got_logits.numpy())


def test_prefill_logits_and_state_match_reference(pair):
    _, cfg, params, port = pair
    batch = _batch(cfg, 8)
    got_last, got_state = port.prefill(_torch(batch))
    for attn, moe in _impls(cfg):
        want_last, want_state = RefModel(cfg, _ref_ex(attn, moe)).prefill(params, _jnp(batch))
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)
        want_leaves, ported = _ref_leaves(want_state), _port_leaves(got_state)
        assert sorted(ported) == sorted(want_leaves)
        for path, w in want_leaves.items():
            g = ported[path]
            assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32, path
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=path)


def test_decode_steps_from_reference_state_match_reference(pair):
    """The port's decode_step continues from the reference's prefill state
    (grown to S + EXTRA positions, handed over by state_from) and stays with
    the reference's logits and state over EXTRA steps fed the same tokens."""
    _, cfg, params, port = pair
    batch = _batch(cfg, 9)
    ref, _, state = _ref_prefill_state(cfg, params, batch, _ref_ex("xla"))
    port_state = state_from(jax.tree.map(np.asarray, state), "cpu")
    for t in range(EXTRA):
        step = _step_tokens(cfg, batch, t)
        want, state = ref.decode_step(params, state, jnp.asarray(step), jnp.int32(S + t))
        got, port_state = port.decode_step(port_state, torch.from_numpy(step), S + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_leaves, ported = _ref_leaves(state), _port_leaves(port_state)
    assert sorted(ported) == sorted(want_leaves)
    for path, w in want_leaves.items():
        np.testing.assert_allclose(ported[path].numpy(), np.asarray(w), **TOL, err_msg=path)


def test_prefill_then_decode_matches_forward(pair):
    """Port-internal consistency: prefill S positions, decode EXTRA more,
    and each step's logits equal the full forward's at that position.  The
    MoE model routes each prompt as one group, so it matches where no
    token is dropped; the VLM's decode positions continue its text stream
    (t = h = w), as the batch's do."""
    name, cfg, _, port = pair
    batch = _batch(cfg, 10)
    if cfg.family == "vlm":  # text positions equal to the cache index, as decode uses
        batch["positions"] = np.broadcast_to(np.arange(S + EXTRA)[None, :, None],
                                             (B, S + EXTRA, 3)).astype(np.int32)
    full = port.forward(_torch(batch))
    last, state = port.prefill(_torch(_cut(cfg, batch, S)))
    if name.endswith("@nodrop") or cfg.family != "moe":
        np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(), **TOL)
    state = _pad_cache_to(state, port, S + EXTRA)
    for t in range(EXTRA):
        logits, state = port.decode_step(state, torch.from_numpy(_step_tokens(cfg, batch, t)),
                                         S + t)
        if name.endswith("@nodrop") or cfg.family != "moe":
            np.testing.assert_allclose(logits.numpy(), full[:, S + t].numpy(), **TOL)


def test_default_capacity_drops_tokens_and_the_nodrop_factor_keeps_them(monkeypatch):
    """The reduced MoE config's capacity factor of 1.25 drops tokens at the
    prefill shape of these tests (so the drop path is what the parity tests
    above hold), and a factor of 2 drops none."""
    seen = []

    def spy(x, router, *w, top_k, capacity_factor, impl):
        out, probs = real(x, router, *w, top_k=top_k, capacity_factor=capacity_factor,
                          impl=impl)
        E = router.shape[1]
        cap = max(1, int(np.ceil(x.shape[1] * top_k / E * capacity_factor)))
        idx = layers._top_k(probs, top_k)[1].reshape(x.shape[0], -1)
        counts = torch.stack([torch.bincount(r, minlength=E) for r in idx])
        seen.append(int((counts - cap).clamp(min=0).sum()))
        return out, probs

    real = transformer.moe_layer
    monkeypatch.setattr(transformer, "moe_layer", spy)
    for name, dropped in (("moonshot-v1-16b-a3b", True), ("moonshot-v1-16b-a3b@nodrop", False)):
        cfg = _reduced(ref_get_arch, RefMoESpec, name)
        tree = jax.tree.map(np.asarray, RefModel(cfg).init(jax.random.PRNGKey(0)))
        port = Model(_reduced(get_arch, MoESpec, name), params=params_from(tree, "cpu"),
                     device="cpu")
        seen.clear()
        port.forward(_torch(_batch(cfg, 7)))
        assert len(seen) == cfg.n_layers and (sum(seen) > 0) == dropped, (name, seen)


@pytest.mark.parametrize("name,new,seed", [
    ("moonshot-v1-16b-a3b", 6, 0),
    ("moonshot-v1-16b-a3b@nodrop", 5, 1),
    ("qwen2-vl-2b", 6, 0),
    ("seamless-m4t-large-v2", 6, 0),
])
def test_greedy_generate_equals_reference(name, new, seed):
    cfg = _reduced(ref_get_arch, RefMoESpec, name)
    ref = RefModel(cfg, _ref_ex("xla"))
    params = ref.init(jax.random.PRNGKey(seed))
    port = Model(_reduced(get_arch, MoESpec, name),
                 params=params_from(jax.tree.map(np.asarray, params), "cpu"), device="cpu")
    batch = _cut(cfg, _batch(cfg, seed + 10), S)
    want = RefServeEngine(ref, params, RefServeConfig(max_len=S + new), jit=False).generate(
        _jnp(batch), new)
    got = ServeEngine(port, ServeConfig(max_len=S + new)).generate(batch, new)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the layers alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 4.0])
@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_moe_layer_matches_reference(cf, impl):
    """moe_layer alone, 3 groups of 40 tokens, top-2 of 8 experts: at
    factors below 2 experts overflow and drop tokens (counted here), at 4
    none does."""
    rng = np.random.default_rng(int(cf * 10))
    Bm, Sm, D, E, Fd, k = 3, 40, 16, 8, 24, 2
    x = rng.standard_normal((Bm, Sm, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(sh) * 0.2).astype(np.float32)
          for sh in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
    want_out, want_probs = ref_layers.moe_layer(
        jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, ws), top_k=k,
        capacity_factor=cf, impl=impl)
    got_out, got_probs = layers.moe_layer(torch.from_numpy(x), torch.from_numpy(router),
                                          *map(torch.from_numpy, ws), top_k=k,
                                          capacity_factor=cf, impl=impl)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(want_probs), **TOL)
    np.testing.assert_allclose(float(layers.moe_aux_loss(got_probs, k)),
                               float(ref_layers.moe_aux_loss(want_probs, k)), **TOL)
    cap = max(1, int(np.ceil(Sm * k / E * cf)))
    top = np.argsort(-np.asarray(want_probs), axis=-1, kind="stable")[..., :k].reshape(Bm, -1)
    over = sum(max(0, c - cap) for row in top for c in np.bincount(row, minlength=E))
    assert (over > 0) == (cf < 2), over


def test_top_k_breaks_ties_to_the_lower_index_as_lax_does():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.2, 0.3, 0.2]],
                     np.float32)
    want_w, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_w, got_i = layers._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert float(layers.moe_aux_loss(torch.from_numpy(probs), 2)) == pytest.approx(
        float(ref_layers.moe_aux_loss(jnp.asarray(probs), 2)), rel=1e-6)


def test_apply_mrope_matches_reference_on_a_patch_grid():
    """A 16 x 16 patch grid, then text, at qwen2-vl-2b's head width and
    sections: t, h and w differ on the patches, so a wrong section map
    shows (the result is not plain RoPE of any one stream)."""
    cfg = get_arch("qwen2-vl-2b")
    hd, secs, theta = cfg.resolved_head_dim, cfg.mrope_sections, cfg.rope_theta
    pos = _mrope_positions(2, 16, 12).astype(np.int32)
    x = np.random.default_rng(3).standard_normal((2, pos.shape[1], 3, hd)).astype(np.float32)
    want = np.asarray(ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, secs))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, secs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for stream in range(3):
        plain = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., stream]), theta)
        assert float((plain - got).abs().max()) > 1e-2
    text = slice(256, None)  # t = h = w: plain RoPE
    plain = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), theta)
    np.testing.assert_allclose(got[:, text].numpy(), plain[:, text].numpy(), **TOL)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, (16, 24, 23))


# ---------------------------------------------------------------------------
# specs, counts, families, initialisation
# ---------------------------------------------------------------------------


def _flat(specs, mapper=map_specs):
    out = []
    mapper(lambda p, s: out.append(("/".join(p), (s.shape, s.axes, s.init))), specs)
    return dict(out)


@pytest.mark.parametrize("name", ref_list_archs())
def test_spec_trees_and_counts_equal_reference_for_every_arch(name):
    """Full-width spec trees: the same names, shapes, axes and initializers
    for all ten registered archs, and the same parameter counts."""
    assert name in list_archs()
    ref = RefModel(ref_get_arch(name))
    port_specs = _specs(get_arch(name))
    assert _flat(port_specs) == _flat(ref.specs(), ref_map_specs)
    assert param_count(port_specs) == ref_param_count(ref.specs()) == ref.n_params()


def _specs(cfg):
    """The family's spec tree, as ``Model.specs`` builds it, without
    materialising the model."""
    if cfg.family == "ssm":
        return ssm.ssm_specs(cfg)
    if cfg.family == "hybrid":
        return rglru.hybrid_specs(cfg)
    if cfg.family == "encdec":
        return encdec.encdec_specs(cfg)
    return transformer.lm_specs(cfg)


def test_every_family_is_ported_and_vlm_patches_match():
    from repro.models.model import VLM_PATCHES as REF_VLM_PATCHES

    assert sorted(PORTED_FAMILIES) == sorted({get_arch(n).family for n in list_archs()})
    assert VLM_PATCHES == REF_VLM_PATCHES == 256


def test_encdec_state_and_padding():
    cfg = get_arch("seamless-m4t-large-v2").reduced()
    port = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = port.init_state(B, 30, enc_len=ENC_LEN)
    assert [tuple(t.shape) for t in (*state["self"], *state["cross"])] == \
        [(cfg.n_layers, B, 30, cfg.n_kv_heads, cfg.head_dim)] * 2 \
        + [(cfg.n_layers, B, ENC_LEN, cfg.n_kv_heads, cfg.head_dim)] * 2
    assert tuple(port.init_state(B, 30)["cross"][0].shape)[2] == 30
    _, pre = port.prefill(_torch(_batch(cfg, 4, n=S)))
    grown = _pad_cache_to(pre, port, S + 5)
    assert grown["self"][0].shape[2] == S + 5 and grown["cross"][0] is pre["cross"][0]
    assert torch.equal(grown["self"][1][:, :, :S], pre["self"][1])


def test_sliced_draws_are_seeded_and_follow_the_law():
    """A stacked leaf is drawn a layer at a time: one seed, one draw; every
    layer keeps the initializer's law; the stored type is the asked one."""
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    specs = transformer.lm_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(5), "cpu", torch.bfloat16)
    b = init_params(specs, torch.Generator().manual_seed(5), "cpu", torch.bfloat16)
    w, w2 = a["blocks"]["moe"]["w_gate"], b["blocks"]["moe"]["w_gate"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == specs["blocks"]["moe"]["w_gate"].shape
    assert torch.equal(w, w2)
    assert not torch.equal(w[0], w[1])  # the layers are separate draws
    fan_in = cfg.moe.n_experts * cfg.d_model  # lecun: the layer axis skipped
    for layer in w.float():
        assert abs(float(layer.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert not a["blocks"]["ln1"].any()
