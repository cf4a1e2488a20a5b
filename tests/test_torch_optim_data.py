"""The port's optimizers, schedules, gradient compression and data stream
against the JAX package's, on the CPU.

Both packages get the same numpy inputs.  Optimizer updates (AdamW with a
warm-up cosine schedule and its global-norm clip, SGD with momentum,
Adafactor with factored and full second moments) agree with the
reference's within 1e-6 relative after three steps, parameters and every
moment; ``global_norm``, ``clip_by_global_norm`` and the schedules within
one float32 ulp; int8 compression bit for bit; the synthetic token stream
and every family's batch bit for bit.  The reference's own substrate
behaviours (``tests/test_substrate.py``) are checked on the port.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data as ref_data  # noqa: E402
import repro.optim as ref_optim  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.shapes import InputShape as RefInputShape  # noqa: E402
from repro_torch import data, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402

FAMILY_ARCHS = ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-2b",
                "seamless-m4t-large-v2", "qwen2-vl-2b"]  # dense, moe, ssm, hybrid, encdec, vlm
REL = 1e-6  # optimizer updates: of the leaf's largest magnitude


def _params(seed=0) -> dict:
    """A small tree with a stacked 3-D leaf, a matrix and a vector (the
    shapes Adafactor factors and does not)."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((2, 6, 5)).astype(np.float32),
                       "ln": rng.standard_normal((2, 5)).astype(np.float32)},
            "embed": rng.standard_normal((7, 4)).astype(np.float32),
            "bias": rng.standard_normal((4,)).astype(np.float32)}


def _grads(step: int, scale: float) -> dict:
    return jax.tree.map(lambda a: a * scale, _params(100 + step))


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat(tree) -> dict:
    """Leaves of a nested dict by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in _flat(v).items()})
        else:
            out[k] = v
    return out


def _close(got, want, what: str, rel: float = REL) -> None:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path].numpy() if isinstance(got[path], torch.Tensor) else got[path]
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        bound = rel * max(float(np.abs(w).max()), np.finfo(np.float32).tiny)
        np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=f"{what}: {path}")


def _optimizers(mod):
    return {
        "adamw": mod.AdamW(mod.linear_warmup_cosine(0.05, 1, 5), weight_decay=0.1,
                           grad_clip=1.0),
        "adamw-noclip": mod.AdamW(0.01, grad_clip=0.0),
        "sgd": mod.SGD(0.05, momentum=0.9, grad_clip=2.0),
        "adafactor": mod.Adafactor(0.1, weight_decay=0.01),
    }


@pytest.mark.parametrize("name", ["adamw", "adamw-noclip", "sgd", "adafactor"])
@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_optimizer_updates_match_reference(name, scale):
    """Three updates on identical grads: parameters and every moment within
    1e-6 relative of the reference's (scale 3 makes the clip bind)."""
    ref, port = _optimizers(ref_optim)[name], _optimizers(optim)[name]
    p_ref, p_port = jax.tree.map(jnp.asarray, _params()), _torch(_params())
    s_ref, s_port = ref.init(p_ref), port.init(p_port)
    for step in range(3):
        g = _grads(step, scale)
        p_ref, s_ref = ref.update(jax.tree.map(jnp.asarray, g), s_ref, p_ref, jnp.int32(step))
        p_port, s_port = port.update(_torch(g), s_port, p_port,
                                     torch.tensor(step, dtype=torch.int32))
        _close(p_port, jax.tree.map(np.asarray, p_ref), f"{name} params, step {step}")
        _close(s_port, jax.tree.map(np.asarray, s_ref), f"{name} state, step {step}")


def test_adafactor_state_factors_matrices_only():
    st = optim.Adafactor().init(_torch(_params()))["f"]
    assert sorted(st["blocks"]["w"]) == ["col", "row"]
    assert tuple(st["blocks"]["w"]["row"].shape) == (2, 6)
    assert tuple(st["blocks"]["w"]["col"].shape) == (2, 5)
    assert sorted(st["bias"]) == ["v"] and tuple(st["bias"]["v"].shape) == (4,)


def _ulps(got: torch.Tensor, want) -> float:
    g, w = np.float32(got.item()), np.float32(want)
    return float(abs(g - w) / np.spacing(abs(w))) if w != 0 else float(abs(g) > 0)


@pytest.mark.parametrize("scale", [0.1, 1.0, 50.0])
def test_global_norm_and_clip_within_one_ulp(scale):
    g = _grads(0, scale)
    want = ref_optim.global_norm(jax.tree.map(jnp.asarray, g))
    assert _ulps(optim.global_norm(_torch(g)), want) <= 1
    ref_c, ref_n = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    got_c, got_n = optim.clip_by_global_norm(_torch(g), 1.0)
    assert _ulps(got_n, ref_n) <= 1
    for path, w in _flat(jax.tree.map(np.asarray, ref_c)).items():
        np.testing.assert_array_max_ulp(_flat(got_c)[path].numpy(), w, maxulp=1)


SCHEDULES = [
    ("constant_lr", (3e-4,), (0, 1, 7)),
    ("cosine_lr", (2.0, 50), (0, 1, 25, 49, 50, 60)),
    ("cosine_lr", (1e-3, 100, 0.05), (0, 1, 33, 100)),
    ("linear_warmup_cosine", (1.0, 10, 100), (0, 1, 9, 10, 11, 50, 99, 100, 120)),
    ("linear_warmup_cosine", (1e-3, 1, 20), (0, 1, 2, 19, 20)),
]


@pytest.mark.parametrize("name,args,steps", SCHEDULES)
def test_schedules_within_one_ulp(name, args, steps):
    """At step 0, 1, the warm-up's end and the schedule's end (and past it)."""
    ref, port = getattr(ref_optim, name)(*args), getattr(optim, name)(*args)
    for s in steps:
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert _ulps(got, ref(jnp.int32(s))) <= 1, (name, args, s)


@pytest.mark.parametrize("shape", [(7,), (16,), (3, 5), (128,), (300,), (2, 257)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_compress_int8_bitwise(shape, scale):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * scale
    q_ref, s_ref = ref_optim.compress_int8(jnp.asarray(x))
    q, s = optim.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    back = optim.decompress_int8(q, s, shape, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_optim.decompress_int8(q_ref, s_ref, shape, jnp.float32)))


def test_error_feedback_residuals_match_reference():
    rng = np.random.default_rng(4)
    zeros = {"a": np.zeros((3, 100), np.float32), "b": np.zeros((9,), np.float32)}
    r_ref = ref_optim.ErrorFeedback.init(jax.tree.map(jnp.asarray, zeros))
    r_port = optim.ErrorFeedback.init(_torch(zeros))
    for _ in range(5):
        g = {"a": rng.standard_normal((3, 100)).astype(np.float32),
             "b": rng.standard_normal(9).astype(np.float32)}
        out_ref, r_ref = ref_optim.ErrorFeedback.apply(jax.tree.map(jnp.asarray, g), r_ref)
        out, r_port = optim.ErrorFeedback.apply(_torch(g), r_port)
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_ref[k]))
            np.testing.assert_array_equal(r_port[k].numpy(), np.asarray(r_ref[k]))


# ---------------------------------------------------------------------------
# the data stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab=1000, seq_len=32, global_batch=8, seed=3),
                                dict(vocab=49152, seq_len=17, global_batch=3, seed=0,
                                     structure=0.5)])
def test_synthetic_stream_bitwise(kw):
    ref, port = ref_data.SyntheticLM(**kw), data.SyntheticLM(**kw)
    for step in (0, 5):
        for host_id, host_count in ((0, 1), (1, kw["global_batch"] // 2 or 1)):
            a = ref.batch(step, host_id=host_id, host_count=host_count)
            b = port.batch(step, host_id=host_id, host_count=host_count)
            for k in ("tokens", "labels"):
                assert b[k].dtype == a[k].dtype
                np.testing.assert_array_equal(b[k], a[k])
    for a, b, _ in zip(ref, port, range(3)):
        np.testing.assert_array_equal(b["tokens"], a["tokens"])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_make_batch_fn_bitwise_every_family(arch, full):
    """Tokens, labels and the stub frontends' inputs (enc-dec frame
    embeddings, a vision model's patch prefix and 3-D positions)."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    if not full:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    S = 48 if full else 24  # a VLM's prefix: min(256, S // 2) patches
    if full:  # the published configs (types, vocab) at a narrow d_model, to stay small
        ref_cfg = dataclasses.replace(ref_cfg, d_model=32)
        cfg = dataclasses.replace(cfg, d_model=32)
    ref_fn = ref_data.make_batch_fn(ref_cfg, RefInputShape("t", S, 2, "train"), seed=5)
    port_fn = data.make_batch_fn(cfg, InputShape("t", S, 2, "train"), seed=5)
    for step in (0, 3):
        a, b = ref_fn(step), port_fn(step)
        assert sorted(b) == sorted(a)
        for k in a:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, (arch, k)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{arch} {k}")


# ---------------------------------------------------------------------------
# the reference's substrate behaviours (tests/test_substrate.py), on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["adamw", "sgd", "adafactor"])
def test_optimizer_minimises_quadratic(opt_name):
    opt = {
        "adamw": optim.AdamW(0.1, weight_decay=0.0),
        "sgd": optim.SGD(0.05),
        "adafactor": optim.Adafactor(0.3),
    }[opt_name]
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2))}
    state = opt.init(params)
    for step in range(1000 if opt_name == "adafactor" else 200):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state = opt.update(g, state, params, torch.tensor(step, dtype=torch.int32))
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_adamw_weight_decay_shrinks_params():
    opt = optim.AdamW(0.1, weight_decay=0.5, grad_clip=0.0)
    params = {"w": torch.ones((4,)) * 10.0}
    p1, _ = opt.update({"w": torch.zeros((4,))}, opt.init(params), params,
                       torch.tensor(0, dtype=torch.int32))
    assert float(p1["w"][0]) < 10.0


def test_updates_are_pure_and_keep_types():
    """update returns new tensors and leaves its inputs alone; a bfloat16
    parameter stays bfloat16, its moments float32."""
    opt = optim.AdamW(0.1)
    params = {"w": torch.ones((3,), dtype=torch.bfloat16), "v": torch.ones((2, 2))}
    state = opt.init(params)
    before = {k: v.clone() for k, v in params.items()}
    g = {"w": torch.full((3,), 0.5, dtype=torch.bfloat16), "v": torch.ones((2, 2))}
    new, new_state = opt.update(g, state, params, torch.tensor(0, dtype=torch.int32))
    assert new["w"].dtype == torch.bfloat16 and new_state["m"]["w"].dtype == torch.float32
    for k in params:
        assert torch.equal(params[k], before[k]) and not torch.equal(new[k], before[k])
    assert float(state["m"]["v"].abs().sum()) == 0.0


def test_global_norm_and_clip():
    tree = {"a": torch.ones((3,)) * 3.0, "b": torch.ones((4,)) * 4.0}
    n = float(optim.global_norm(tree))
    assert n == pytest.approx(np.sqrt(9 * 3 + 16 * 4))
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(n)


def test_schedules_shapes():
    s = optim.linear_warmup_cosine(1.0, 10, 100)
    step = lambda i: torch.tensor(i, dtype=torch.int32)  # noqa: E731
    assert float(s(step(0))) == pytest.approx(0.0)
    assert float(s(step(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(s(step(100))) == pytest.approx(0.1, rel=1e-2)
    assert float(optim.cosine_lr(2.0, 50)(step(0))) == pytest.approx(2.0)


@pytest.mark.parametrize("shape", [(7,), (16,), (3, 5), (128,), (300,)])
@pytest.mark.parametrize("scale", [1e-3, 0.7, 1e3])
def test_int8_roundtrip_error_bounded(shape, scale):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * scale
    q, s = optim.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    back = optim.decompress_int8(q, s, shape, torch.float32).numpy()
    # per-block max error <= scale/127 within each 256-block
    assert np.abs(back - x).max() <= np.abs(x).max() / 127.0 + 1e-6


def test_error_feedback_converges_in_mean():
    """With EF, quantisation error doesn't accumulate: the running sum of
    compressed grads tracks the true sum."""
    rng = np.random.default_rng(1)
    g_true = [rng.standard_normal(64).astype(np.float32) for _ in range(50)]
    residual = optim.ErrorFeedback.init({"g": torch.zeros(64)})
    acc_c, acc_t = np.zeros(64), np.zeros(64)
    for g in g_true:
        out, residual = optim.ErrorFeedback.apply({"g": torch.from_numpy(g)}, residual)
        acc_c += out["g"].numpy()
        acc_t += g
    assert np.abs(acc_c - acc_t).max() < np.abs(g_true[-1]).max()


def test_data_deterministic_and_host_sharded():
    ds = data.SyntheticLM(vocab=1000, seq_len=32, global_batch=8, seed=3)
    a, b, c = ds.batch(5), ds.batch(5), ds.batch(6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    h0 = ds.batch(5, host_id=0, host_count=2)
    h1 = ds.batch(5, host_id=1, host_count=2)
    assert h0["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_data_has_learnable_structure():
    ds = data.SyntheticLM(vocab=257, seq_len=128, global_batch=4, seed=0, structure=1.0)
    t = ds.batch(0)["tokens"]
    a = 6364136223846793005 % 257
    b = 1442695040888963407 % 257
    np.testing.assert_array_equal(t[:, 1:], (t[:, :-1] * a + b) % 257)


def test_public_names_equal_reference():
    import repro.ckpt as ref_ckpt
    import repro.launch.train as ref_launch_train
    import repro.train as ref_train
    from repro_torch import ckpt, train
    from repro_torch.launch import train as launch_train

    for ref, port in ((ref_optim, optim), (ref_data, data), (ref_ckpt, ckpt),
                      (ref_train, train), (ref_launch_train, launch_train)):
        assert port.__all__ == ref.__all__, port.__name__
        for name in port.__all__:
            assert hasattr(port, name), (port.__name__, name)
