"""The port's checkpoints: the reference's checkpoint behaviours
(``tests/test_ckpt_ft.py``) on the port, and train states written by
either package restored by the other, leaf for leaf and bit for bit
(float32, int32 and bfloat16 leaves).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.ckpt as ref_ckpt  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import Adafactor as RefAdafactor  # noqa: E402
from repro.optim import ErrorFeedback as RefErrorFeedback  # noqa: E402
from repro.train.step import TrainState as RefTrainState  # noqa: E402
from repro_torch._tree import leaves, tree_map, unflatten  # noqa: E402
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree  # noqa: E402
from repro_torch.convert import train_state_from  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2,), dtype=torch.int32),
                   "c": torch.zeros((5,), dtype=torch.bfloat16)},
    }


def _bits(x) -> np.ndarray:
    """A leaf's exact bits: bfloat16 as uint16 (torch or ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _same_leaves(got, want) -> None:
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w, strict=True)):
        assert _dtype_name(a) == _dtype_name(b), i
        assert tuple(a.shape) == tuple(np.shape(b)), i
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# checkpoint primitives (the reference's tests/test_ckpt_ft.py cases)
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path / "ck"), t, meta={"step": 7})
    loaded, meta = load_pytree(str(tmp_path / "ck"), t)
    assert meta["step"] == 7
    for a, b in zip(leaves(t), leaves(loaded), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_publication(tmp_path):
    """A directory missing its manifest is never considered LATEST."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), sync=True)
    os.makedirs(tmp_path / "step_00000002")  # a torn write of step 2
    with open(tmp_path / "LATEST", "w") as f:
        f.write("2")
    assert mgr.latest_step() == 1  # falls back past the torn step


def test_manager_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree())
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_manager_keep_every(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, keep_every=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, _tree(), sync=True)
    steps = mgr.all_steps()
    assert 5 in steps and 2 in steps and 4 in steps


def test_restore_into_like(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(3, t, sync=True)
    restored, meta = mgr.restore(tree_map(torch.zeros_like, t))
    assert meta["step"] == 3
    assert torch.equal(restored["a"], t["a"])


def test_restore_none_when_empty(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore(_tree()) is None


def test_latest_step_scan_is_order_independent(tmp_path):
    """The torn-pointer fallback scans the directory; creation order must
    not leak into the answer."""
    mgr = CheckpointManager(str(tmp_path))
    for step in (7, 2, 31, 16):  # deliberately non-monotone creation order
        save_pytree(mgr.step_dir(step), {"w": np.arange(3) + step})
    assert not os.path.exists(os.path.join(str(tmp_path), "LATEST"))
    assert mgr.all_steps() == [2, 7, 16, 31]
    assert mgr.latest_step() == 31


def test_async_save_snapshots_and_surfaces_errors(tmp_path):
    """The save copies the leaves before returning (a later in-place
    change is not written), and a failed background write raises on the
    next wait()."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    t["a"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(t)
    assert float(restored["a"][0, 0]) == 0.0
    # a file where the step's scratch directory goes makes the write fail
    (tmp_path / "step_00000002.tmp").write_text("in the way")
    mgr.save(2, t)
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    assert mgr.latest_step() == 1


def test_leaf_order_is_jax_order():
    """dict keys sorted, dataclass fields in declaration order, None no
    leaf: jax.tree.leaves' order on the same structure."""
    st = TrainState(params={"b": torch.tensor(1.0), "a": {"z": torch.tensor(2.0),
                                                          "y": torch.tensor(3.0)}},
                    opt_state=(torch.tensor(4.0), [torch.tensor(5.0)]),
                    step=torch.tensor(6, dtype=torch.int32), ef_residual=None)
    ref = RefTrainState(params={"b": 1.0, "a": {"z": 2.0, "y": 3.0}}, opt_state=(4.0, [5.0]),
                        step=6, ef_residual=None)
    assert [float(x) for x in leaves(st)] == [float(x) for x in jax.tree.leaves(ref)]
    back = unflatten(st, [torch.tensor(float(i)) for i in range(6)])
    assert isinstance(back, TrainState) and back.ef_residual is None
    assert list(back.params) == ["b", "a"]  # the like tree's key order is kept
    assert [float(back.params["a"]["y"]), float(back.params["b"]), float(back.step)] == [0, 2, 5]


# ---------------------------------------------------------------------------
# train states across the two packages
# ---------------------------------------------------------------------------


def _ref_state(opt: str, compress: bool):
    """A reference TrainState after a made-up update: float32 master
    weights, one bfloat16 leaf, the optimizer's moments, step 7."""
    rng = np.random.default_rng(11)
    params = {"blocks": {"w": jnp.asarray(rng.standard_normal((2, 4, 3)), jnp.float32)},
              "embed": jnp.asarray(rng.standard_normal((5, 3)), jnp.float32),
              "scale": jnp.asarray(rng.standard_normal((3,)), jnp.bfloat16)}
    optimizer = RefAdamW(1e-3) if opt == "adamw" else RefAdafactor(1e-3)
    state = optimizer.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, p.dtype), params)
    params, state = optimizer.update(grads, state, params, jnp.int32(6))
    return RefTrainState(params=params, opt_state=state, step=jnp.int32(7),
                         ef_residual=RefErrorFeedback.init(params) if compress else None)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, opt, compress):
    ref = _ref_state(opt, compress)
    ref_ckpt.CheckpointManager(str(tmp_path)).save(7, ref, sync=True)
    like = train_state_from(jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), ref), "cpu")
    restored, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta["step"] == 7 and isinstance(restored, TrainState)
    assert restored.step.dtype == torch.int32 and int(restored.step) == 7
    assert restored.params["scale"].dtype == torch.bfloat16
    _same_leaves(restored, ref)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_reference(tmp_path, opt, compress):
    ref = _ref_state(opt, compress)
    port = train_state_from(jax.tree.map(np.asarray, ref), "cpu")
    _same_leaves(port, ref)  # convert carries every leaf over exactly
    CheckpointManager(str(tmp_path)).save(7, port, sync=True)
    like = jax.tree.map(jnp.zeros_like, ref)
    restored, meta = ref_ckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert meta["step"] == 7
    _same_leaves(port, restored)
