"""The port's models against the JAX package's, on the CPU.

Reduced smollm-135m (dense GQA), mamba2-130m (SSD) and recurrentgemma-2b
(Griffin hybrid, at its reduced 3 layers and at 5 layers, where the two
``rest`` layers after the super-block run) use the reference's own
weights, carried across by ``convert.params_from``: ``forward`` and
``prefill`` logits and every state leaf are held against the reference's
``Model`` under both of its attention paths (the Pallas kernels in
interpret mode, and the XLA path), and ``decode_step`` continues from the
reference's prefill state (``convert.state_from``), at the tolerance of
the reference's model tests (1e-4).  The reduced hybrid's local window is
16 and its prompts are longer, so the ring cache wraps.  The configs, spec
trees and parameter counts equal the reference's.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models.params import map_specs as ref_map_specs  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.convert import params_from, state_from  # noqa: E402
from repro_torch.models import Model, init_params, map_specs, param_count  # noqa: E402
from repro_torch.models import rglru, ssm, transformer  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402

# "name@L": the reduced config cut to L layers (recurrentgemma-2b@5: one
# (rec, rec, attn) super-block and the two-layer ``rest``).
ARCHS = ["smollm-135m", "mamba2-130m", "recurrentgemma-2b", "recurrentgemma-2b@5"]
IMPLS = ["pallas", "xla"]
B, S, EXTRA = 2, 24, 3
TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_models.py's prefill/decode tolerance


def _reduced(get, name):
    base, _, layers = name.partition("@")
    cfg = get(base).reduced()
    return dataclasses.replace(cfg, n_layers=int(layers)) if layers else cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model factory, its params, the port's model on them)."""
    cfg = _reduced(ref_get_arch, request.param)
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    port = Model(_reduced(get_arch, request.param), params=params_from(tree, "cpu"),
                 device="cpu")
    return request.param, cfg, params, port


def _ref_leaves(tree) -> dict:
    """A reference state's leaves by tree path ("0", "super/2/ck", ...)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, prefix=()) -> dict:
    """The port's state leaves by the same paths."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {"/".join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, (*prefix, str(k))))
    return out


def _tokens(cfg, seed=7, n=S + EXTRA):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _ref_model(cfg, impl):
    return RefModel(cfg, RefExecConfig(attn_impl=impl, remat="none"))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_reference(pair, impl):
    _, cfg, params, port = pair
    tok = _tokens(cfg)
    want = np.asarray(_ref_model(cfg, impl).forward(params, {"tokens": jnp.asarray(tok)}))
    got = port.forward({"tokens": torch.from_numpy(tok)})
    assert got.shape == (B, S + EXTRA, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_state_match_reference(pair, impl):
    _, cfg, params, port = pair
    tok = _tokens(cfg, seed=8)
    want_last, want_state = _ref_model(cfg, impl).prefill(params, {"tokens": jnp.asarray(tok)})
    got_last, got_state = port.prefill({"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)
    want_leaves, ported = _ref_leaves(want_state), _port_leaves(got_state)
    assert sorted(ported) == sorted(want_leaves)
    for path, w in want_leaves.items():
        g = ported[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == (torch.float32 if w.dtype == jnp.float32 else torch.bfloat16), path
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **TOL,
                                   err_msg=path)


def test_decode_steps_from_reference_state_match_reference(pair):
    """The port's decode_step continues from the reference's prefill state
    (handed over by state_from) and stays with the reference's logits and
    state over EXTRA steps fed the same tokens."""
    name, cfg, params, port = pair
    tok = _tokens(cfg, seed=9)
    ref = _ref_model(cfg, "xla")
    _, state = ref.prefill(params, {"tokens": jnp.asarray(tok[:, :S])})
    if cfg.family == "dense":
        pad = ((0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0))
        state = (jnp.pad(state[0], pad), jnp.pad(state[1], pad))
    port_state = state_from(jax.tree.map(np.asarray, state), "cpu")
    for t in range(EXTRA):
        step = tok[:, S + t]
        want, state = ref.decode_step(params, state, jnp.asarray(step), jnp.int32(S + t))
        got, port_state = port.decode_step(port_state, torch.from_numpy(step), S + t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_leaves, ported = _ref_leaves(state), _port_leaves(port_state)
    assert sorted(ported) == sorted(want_leaves)
    for path, w in want_leaves.items():
        np.testing.assert_allclose(ported[path].float().numpy(), np.asarray(w, np.float32),
                                   **TOL, err_msg=path)


def test_prefill_then_decode_matches_forward(pair):
    """Port-internal consistency: prefill S tokens, decode EXTRA more, and
    each step's logits equal the full forward's at that position."""
    _, cfg, _, port = pair
    tok = torch.from_numpy(_tokens(cfg, seed=10))
    full = port.forward({"tokens": tok})
    last, state = port.prefill({"tokens": tok[:, :S]})
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(), **TOL)
    if cfg.family == "dense":
        grown = port.init_state(B, S + EXTRA)
        for g, s in zip(grown, state, strict=True):
            g[:, :, :S] = s
        state = grown
    for t in range(EXTRA):
        logits, state = port.decode_step(state, tok[:, S + t], S + t)
        np.testing.assert_allclose(logits.numpy(), full[:, S + t].numpy(), **TOL)


def test_configs_equal_reference():
    assert list_archs() == ref_list_archs()
    for name in list_archs():
        for port_cfg, ref_cfg in ((get_arch(name), ref_get_arch(name)),
                                  (get_arch(name).reduced(), ref_get_arch(name).reduced())):
            assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
            assert port_cfg.param_count() == ref_cfg.param_count()


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m", "recurrentgemma-2b"])
def test_spec_trees_and_counts_equal_reference(name):
    """Full-width spec trees: the same names, shapes, axes and initializers,
    so the reference's parameters carry across name for name."""
    ref_specs = RefModel(ref_get_arch(name)).specs()
    port_specs = _specs(get_arch(name))
    ref_flat = {"/".join(p): (s.shape, s.axes, s.init) for p, s in _flat(ref_specs, ref_map_specs)}
    port_flat = {"/".join(p): (s.shape, s.axes, s.init) for p, s in _flat(port_specs)}
    assert port_flat == ref_flat
    assert param_count(port_specs) == ref_param_count(ref_specs)


def test_recurrentgemma_full_config_counts_the_published_parameters():
    """26 layers, (rec, rec, attn) x 8 then the (rec, rec) ``rest``: the
    reference's 3,343,495,680 parameters, counted by the port's Model
    without building it."""
    cfg = get_arch("recurrentgemma-2b")
    specs = _specs(cfg)
    assert sorted(specs["super"]) == ["0", "1", "2"] and sorted(specs["rest"]) == ["0", "1"]
    assert specs["super"]["0"]["log_lambda"].shape == (8, cfg.lru_width)
    assert specs["rest"]["1"]["w_out"].shape == (1, cfg.lru_width, cfg.d_model)
    assert param_count(specs) == 3_343_495_680 == RefModel(ref_get_arch(cfg.name)).n_params()


def _specs(cfg):
    if cfg.family == "ssm":
        return ssm.ssm_specs(cfg)
    if cfg.family == "hybrid":
        return rglru.hybrid_specs(cfg)
    return transformer.lm_specs(cfg)


def _flat(specs, mapper=map_specs):
    out = []
    mapper(lambda p, s: out.append((p, s)), specs)
    return out


def test_init_params_follow_the_initializer_laws():
    cfg = get_arch("mamba2-130m").reduced()
    specs = _specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    for (path, spec), x, y in zip(_flat(specs), _leaves(a), _leaves(b), strict=True):
        assert tuple(x.shape) == spec.shape and x.dtype == torch.float32, path
        assert torch.equal(x, y), path  # one seed, one draw
        if spec.init == "zeros":
            assert not x.any(), path
        elif spec.init == "ones":
            assert bool((x == 1).all()), path
        elif spec.init in ("normal", "embed"):
            assert abs(float(x.std()) - 0.02) < 0.005, path
    w_x = a["blocks"]["w_x"]  # lecun over fan-in d_model, the layer axis skipped
    assert abs(float(w_x.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    half = init_params(specs, torch.Generator().manual_seed(3), "cpu", torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in _leaves(half))


def _leaves(tree):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_model_keeps_the_reference_tree_names(pair):
    _, cfg, params, port = pair
    ref_names = {"/".join(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    port_names = {n.replace(".", "/").removeprefix("tree/") for n, _ in port.named_parameters()}
    assert port_names == ref_names
    assert not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "dbrx-132b",
                                  "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_unported_families_raise(name):
    """The families that once raised NotImplementedError (MoE, enc-dec,
    VLM) are ported: each builds on the CPU and its forward gives finite
    logits (their parity with the reference:
    tests/test_torch_models_moe_vlm_encdec.py)."""
    cfg = get_arch(name).reduced()
    model = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.zeros((B, 5, cfg.d_model))
    logits = model.forward(batch)
    assert logits.shape == (B, S + EXTRA, cfg.vocab) and bool(torch.isfinite(logits).all())


def test_model_asks_for_cuda_by_default():
    """Without device= a model goes to the card, and on a host without one
    it raises instead of falling back to the CPU."""
    cfg = get_arch("smollm-135m").reduced()
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
