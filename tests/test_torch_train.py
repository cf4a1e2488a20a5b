"""The port's training path against the JAX package's, on the CPU.

``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
reference's for each of the six families at reduced size on the same
weights (drawn by the port, handed to the reference as numpy), on the
differentiable ``attn_impl="xla"`` route: loss within 1e-5 relative, each
gradient leaf within 1e-4 of its largest magnitude (the MoE model's aux
term and router included).  The three ``remat`` policies give equal gradients.  The loop's
behaviours mirror ``tests/test_train_serve.py`` (the loss falls, resume is
bit for bit, microbatching equals the full batch, compressed gradients
still learn), and examples/quickstart.py's 20-step curve, from the
reference's initial weights, stays within 1e-3 of the reference's at
every step.  A state the reference trained continues in the port
(``convert.train_state_from``) as it does in the reference.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.shapes import InputShape as RefInputShape  # noqa: E402
from repro.data import make_batch_fn as ref_make_batch_fn  # noqa: E402
from repro.launch.train import build_loop as ref_build_loop  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import linear_warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.train.step import init_train_state as ref_init_train_state  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from, train_state_from  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.train import build_loop  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.optim import AdamW, linear_warmup_cosine  # noqa: E402
from repro_torch.train import TrainState, make_train_step, train_state_axes  # noqa: E402

FAMILY_ARCHS = ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-2b",
                "seamless-m4t-large-v2", "qwen2-vl-2b"]  # dense, moe, ssm, hybrid, encdec, vlm
B, S = 2, 32  # the reduced hybrid's window is 16 and its SSM chunk 16: both bind at S = 32
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _batch(name: str, step: int = 0) -> dict:
    """The reference's synthetic batch for the reduced arch (numpy)."""
    return ref_make_batch_fn(ref_get_arch(name).reduced(), RefInputShape("t", S, B, "train"),
                             seed=3)(step)


def _port_model(name: str, **ex) -> Model:
    return Model(get_arch(name).reduced(), ExecConfig(**{"attn_impl": "xla", "remat": "none",
                                                         **ex}), params={}, device="cpu")


def _params(name: str) -> dict:
    """Float32 weights of the reduced arch, drawn from a seeded generator."""
    return _port_model(name).init(torch.Generator().manual_seed(0))


def _grads(model: Model, params: dict, batch: dict):
    """(loss, metrics, grads by path) of ``model.loss`` at ``params``."""
    live = {k: v.detach().requires_grad_(True) for k, v in _flat(params).items()}
    loss, metrics = model.loss(_unflat(live), {k: torch.from_numpy(np.asarray(v))
                                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss, metrics, {k: g for k, g in zip(live, grads, strict=True)}


def _numpy(tree: dict) -> dict:
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    """(arch, params, the reference's loss/metrics/grads by path, batch)."""
    name = request.param
    cfg = ref_get_arch(name).reduced()
    params = _params(name)
    batch = _batch(name)
    model = RefModel(cfg, RefExecConfig(attn_impl="xla", remat="none"))
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b), has_aux=True))
    (loss, metrics), grads = fn(_numpy(params), jax.tree.map(jnp.asarray, batch))
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return name, params, (float(loss), {k: float(v) for k, v in metrics.items()}, flat), batch


def test_loss_and_grads_match_reference(family):
    name, params, (want_loss, want_metrics, want_grads), batch = family
    loss, metrics, grads = _grads(_port_model(name), params, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0 and loss.requires_grad
    loss = loss.detach()
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_REL)
    ce, aux = (float(metrics[k].detach()) for k in ("ce", "aux"))
    assert ce == pytest.approx(want_metrics["ce"], rel=LOSS_REL)
    assert aux == pytest.approx(want_metrics["aux"], rel=LOSS_REL, abs=1e-7)
    if name.startswith("moonshot"):
        assert want_metrics["aux"] > 0  # the load-balance term is live
    assert sorted(grads) == sorted(want_grads)
    for path, w in want_grads.items():
        g = grads[path]
        assert g is not None, path
        bound = GRAD_REL * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound, err_msg=f"{name}: {path}")
        if path.endswith("router") or path == "embed":
            assert float(np.abs(w).max()) > 0, path  # a gradient that flows


def test_remat_policies_give_equal_grads(family):
    name, params, _, batch = family
    _, _, want = _grads(_port_model(name, remat="none"), params, batch)
    for remat in ("dots", "full"):
        _, _, got = _grads(_port_model(name, remat=remat), params, batch)
        for path, w in want.items():
            assert torch.equal(got[path], w), (name, remat, path)


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-130m", "recurrentgemma-2b"])
def test_pallas_route_on_cpu_runs_the_plain_kernels_with_grad(name):
    """On CPU tensors the "pallas" route runs the kernels' plain versions,
    which are differentiable: its loss and grads equal the "xla" route's
    within the reference kernels' float32 tolerance (2e-5)."""
    tree, batch = _params(name), _batch(name)
    want_loss, _, want = _grads(_port_model(name), tree, batch)
    loss, _, got = _grads(_port_model(name, attn_impl="pallas"), tree, batch)
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()), rel=2e-5)
    for path, w in want.items():
        bound = 2e-5 * max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), rtol=0, atol=bound)


KERNEL_CALLS = {
    "flash_attention_cuda": lambda t: flash_attention_cuda(*t((1, 8, 2, 16), (1, 8, 1, 16),
                                                              (1, 8, 1, 16))),
    "ssd_scan_cuda": lambda t: ssd_scan_cuda(*t((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 1, 4),
                                                (1, 8, 1, 4), (2,)), chunk=4),
    "rglru_scan_cuda": lambda t: rglru_scan_cuda(*t((1, 8, 4), (1, 8, 4), (1, 8, 4), (4,))),
}


@pytest.mark.parametrize("kernel", sorted(KERNEL_CALLS))
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """Under grad mode, a kernel wrapper given an input that requires grad
    raises before it looks at the device, naming the differentiable route;
    without grad mode it goes on to its device check (CPU tensors here)."""
    def tensors(*shapes):
        return [torch.zeros(s, requires_grad=(i == 0)) for i, s in enumerate(shapes)]

    with pytest.raises(RuntimeError, match='attn_impl="xla"'):
        KERNEL_CALLS[kernel](tensors)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        KERNEL_CALLS[kernel](tensors)


def test_exec_config_knobs():
    assert ExecConfig().attn_impl == "pallas"  # serving keeps its kernels
    assert ExecConfig().moe_aux_coef == 0.01
    with pytest.raises(ValueError):
        ExecConfig(attn_impl="triton")
    with pytest.raises(ValueError):
        ExecConfig(remat="some")
    loop, _ = build_loop("smollm-135m", steps=1, device="cpu")
    assert loop.model.ex.attn_impl == "xla" and loop.model.params == {}


def test_train_state_axes_mirror_params():
    model = _port_model("smollm-135m")
    axes = train_state_axes(model, compress=True)
    assert isinstance(axes, TrainState) and axes.step == ()
    assert axes.params["blocks"]["attn"]["wq"] == ("layers", "embed", "heads", None)
    assert axes.opt_state["m"] == axes.params == axes.ef_residual
    assert train_state_axes(model).ef_residual is None


# ---------------------------------------------------------------------------
# the loop (tests/test_train_serve.py's behaviours)
# ---------------------------------------------------------------------------


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def test_train_loss_decreases(tmp_path):
    loop, _ = build_loop("smollm-135m", steps=80, seq_len=64, batch=4, lr=3e-3,
                         ckpt_dir=str(tmp_path / "ck"), log_every=0, device="cpu")
    loop.run(_gen(0))
    first = np.mean([h["loss"] for h in loop.history[:5]])
    last = np.mean([h["loss"] for h in loop.history[-5:]])
    assert last < first * 0.9, f"loss did not fall: {first:.3f} -> {last:.3f}"


def test_train_resume_is_bitwise_deterministic(tmp_path):
    loop_a, _ = build_loop("smollm-135m", steps=20, seq_len=32, batch=4, log_every=0,
                           device="cpu")
    state_a = loop_a.run(_gen(1))
    ck = str(tmp_path / "ck")
    # 10 steps, a "crash", then a fresh loop resumes to 20 (the same 20-step
    # horizon, so the same LR schedule; the first run stops early by config)
    loop_b1, _ = build_loop("smollm-135m", steps=20, seq_len=32, batch=4, ckpt_dir=ck,
                            log_every=0, device="cpu")
    loop_b1.config.total_steps = 10
    loop_b1.config.ckpt_every = 10
    loop_b1.run(_gen(1))
    loop_b2, _ = build_loop("smollm-135m", steps=20, seq_len=32, batch=4, ckpt_dir=ck,
                            log_every=0, device="cpu")
    state_b = loop_b2.run(_gen(99))  # the checkpoint, not the generator, decides
    assert int(loop_b2.history[0]["step"]) == 10  # actually resumed
    assert [h["loss"] for h in loop_b2.history] == [h["loss"] for h in loop_a.history[10:]]
    for a, b in zip(leaves(state_a), leaves(state_b), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_microbatch_matches_full_batch():
    loop_full, _ = build_loop("smollm-135m", steps=1, seq_len=32, batch=8, log_every=0,
                              device="cpu")
    loop_mb, _ = build_loop("smollm-135m", steps=1, seq_len=32, batch=8, microbatch=4,
                            log_every=0, device="cpu")
    sa, sb = loop_full.run(_gen(2)), loop_mb.run(_gen(2))
    assert loop_full.history[0]["loss"] == pytest.approx(loop_mb.history[0]["loss"], rel=1e-4)
    assert loop_mb.history[0]["aux"] == 0.0
    for a, b in zip(leaves(sa.params), leaves(sb.params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4)


def test_compressed_grads_still_learn():
    loop, _ = build_loop("smollm-135m", steps=25, seq_len=64, batch=4, lr=1e-3,
                         compress_grads=True, log_every=0, device="cpu")
    state = loop.run(_gen(3))
    assert state.ef_residual is not None
    first = np.mean([h["loss"] for h in loop.history[:5]])
    last = np.mean([h["loss"] for h in loop.history[-5:]])
    assert last < first


def test_quickstart_curve_matches_reference():
    """examples/quickstart.py step 3 (reduced smollm-135m, seq 64, batch 4,
    lr 1e-3, 20 steps) from the reference's initial weights: every step's
    loss and grad norm within 1e-3 relative of the reference's."""
    ref, _ = ref_build_loop("smollm-135m", steps=20, seq_len=64, batch=4, lr=1e-3, log_every=0)
    ref.run(jax.random.PRNGKey(0))
    tree = params_from(jax.tree.map(np.asarray, ref.model.init(jax.random.PRNGKey(0))), "cpu")
    loop, _ = build_loop("smollm-135m", steps=20, seq_len=64, batch=4, lr=1e-3, log_every=0,
                         device="cpu")
    loop.model.init = lambda _generator: tree  # the reference's initial weights
    loop.run(_gen(0))
    assert len(loop.history) == len(ref.history) == 20
    for got, want in zip(loop.history, ref.history, strict=True):
        for key in ("loss", "grad_norm"):
            assert got[key] == pytest.approx(want[key], rel=1e-3), (got["step"], key)
    assert loop.history[-1]["loss"] < loop.history[0]["loss"]


@pytest.mark.parametrize("compress", [False, True])
def test_reference_state_continues_in_port(compress):
    """Three reference steps, the state (params, moments, step, error-feedback
    residual) carried over by train_state_from, then two steps in each
    package: losses within 1e-5 relative, params and moments within 1e-4 of
    each leaf's largest magnitude.  With compression a gradient element can
    round to the next int8 step in one package and not the other, which
    moves that element's moments and weight further: at most one element in
    a thousand of a leaf may do so.  The residual is a rounding error, a
    small difference of the gradient's large values, so the gradients'
    float32 noise is large beside it: each residual leaf is held at 10% of
    its norm (a residual not carried over would be off by all of it)."""
    name = "smollm-135m"
    fn = ref_make_batch_fn(ref_get_arch(name).reduced(), RefInputShape("t", S, 4, "train"))
    ref_model = RefModel(ref_get_arch(name).reduced(), RefExecConfig(attn_impl="xla",
                                                                     remat="none"))
    ref_opt = RefAdamW(ref_warmup_cosine(1e-3, 1, 5))
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt, compress_grads=compress))
    state = ref_init_train_state(ref_model, ref_opt, jax.random.PRNGKey(4), compress=compress)
    for step in range(3):
        state, _ = ref_step(state, jax.tree.map(jnp.asarray, fn(step)))
    port_state = train_state_from(jax.tree.map(np.asarray, state), "cpu")
    assert (port_state.ef_residual is not None) == compress
    port_step = make_train_step(_port_model(name), AdamW(linear_warmup_cosine(1e-3, 1, 5)),
                                compress_grads=compress)
    for step in range(3, 5):
        state, want = ref_step(state, jax.tree.map(jnp.asarray, fn(step)))
        port_state, got = port_step(port_state, {k: torch.from_numpy(v)
                                                 for k, v in fn(step).items()})
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=LOSS_REL)
    assert int(port_state.step) == 5 and port_state.step.dtype == torch.int32
    held = (port_state.params, port_state.opt_state)
    for i, (a, b) in enumerate(zip(leaves(held), jax.tree.leaves((state.params, state.opt_state)),
                                   strict=True)):
        b = np.asarray(b)
        off = np.abs(a.numpy() - b) > 1e-4 * float(np.abs(b).max())
        assert int(off.sum()) <= (b.size // 1000 if compress else 0), f"leaf {i}"
    for a, b in zip(leaves(port_state.ef_residual), jax.tree.leaves(state.ef_residual),
                    strict=True):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 0.1 * np.linalg.norm(b)


def test_launch_train_main_on_cpu(tmp_path, capsys):
    rc = launch_train.main(["--arch", "mamba2-130m", "--steps", "3", "--seq-len", "32",
                            "--batch", "2", "--ckpt-dir", str(tmp_path / "ck"),
                            "--device", "cpu"])
    assert rc == 0
    assert "done: step=3" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] == "step_00000003"


def test_launch_train_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "smollm-135m", "--steps", "1"])
