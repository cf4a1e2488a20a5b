"""The port's sharding rules and meshes against the JAX package's.

Exact: the presets' tables, ``resolve_spec`` entry for entry (the
reference gets a duck-typed mesh with ``axis_names`` and ``devices.shape``,
which is all its ``resolve_spec`` reads) for every arch, all four presets
and both production meshes, over the parameter tree, the train state, the
batch of each shape kind and the decode state at decode_32k; the abstract
trees (params, batches, decode states, ``abstract_ssm_state``) in paths,
shapes and dtypes, and ``param_bytes``.  The placements DTensor derives
from a spec give local shapes of ``dim // prod(sizes)`` on a fake
512-rank world.  ``shard`` is the identity outside a context and on plain
tensors, and raises on a rank mismatch.  A 4-process gloo group on a
(2, 2) CPU mesh computes the reduced smollm-135m, moonshot-v1-16b-a3b
(under both ``moe_impl``s), mamba2-130m and recurrentgemma-2b losses with
their parameters sharded by ``fsdp_tp_sp`` and activation sharding on,
equal to the plain CPU port's within 1e-6 relative, and the norm of each
parameter's gradient within 1e-5.
"""

import json
import math
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.mesh as ref_mesh  # noqa: E402
import repro.sharding as ref_sharding  # noqa: E402
import repro.sharding.ctx as ref_ctx  # noqa: E402
import repro.sharding.rules as ref_rules  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import model as ref_model_mod  # noqa: E402
from repro.models.params import param_bytes as ref_param_bytes  # noqa: E402
from repro.models.ssm import abstract_ssm_state as ref_abstract_ssm_state  # noqa: E402
from repro.train.step import TrainState as RefTrainState  # noqa: E402
from repro.train.step import train_state_axes as ref_train_state_axes  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.dryrun import _abstract_train_state, _local_shape  # noqa: E402
from repro_torch.models import ExecConfig, Model, param_bytes  # noqa: E402
from repro_torch.models import model as port_model_mod  # noqa: E402
from repro_torch.models.ssm import abstract_ssm_state  # noqa: E402
from repro_torch.sharding import ctx, rules  # noqa: E402
from repro_torch.train.step import train_state_axes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
PRESETS = list(ref_rules.PRESETS)
MESHES = {"single": ref_mesh.SINGLE_POD, "multi": ref_mesh.MULTI_POD}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    port = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return ref, port


def _ref_specs(abstract, axes, mesh, rules_):
    out = []
    jax.tree.map(lambda s, a: out.append((tuple(s.shape), tuple(
        ref_rules.resolve_spec(tuple(a), s.shape, mesh, rules_)))), abstract, axes)
    return out


def _port_specs(abstract, axes, mesh, rules_):
    out = []
    tree_map(lambda t, a: out.append((tuple(t.shape), rules.resolve_spec(
        tuple(a), tuple(t.shape), mesh, rules_))), abstract, axes)
    return out


def _ref_train_state(model):
    def f32(t):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), t)

    params = model.abstract_params()
    return RefTrainState(params=params, opt_state={"m": f32(params), "v": f32(params)},
                         step=jax.ShapeDtypeStruct((), jnp.int32), ef_residual=None)


def _sds_leaves(tree):
    return [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(tree)]


def _meta_leaves(tree):
    from repro_torch._tree import leaves

    return [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves(tree)]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (i,))]
    return [prefix]


# ---------------------------------------------------------------------------
# the rules, as data and as resolution
# ---------------------------------------------------------------------------


def test_public_names_equal_reference():
    import repro.roofline as ref_roofline
    import repro.roofline.analysis as ref_analysis
    import repro.roofline.hlo_costs as ref_hlo
    from repro_torch import roofline
    from repro_torch.roofline import analysis, hlo_costs

    for ref, port in ((ref_sharding, sharding), (ref_rules, rules), (ref_ctx, ctx),
                      (ref_mesh, port_mesh), (ref_roofline, roofline),
                      (ref_analysis, analysis), (ref_hlo, hlo_costs)):
        assert port.__all__ == ref.__all__, port.__name__
        for name in port.__all__:
            assert hasattr(port, name), (port.__name__, name)
    import repro.models as ref_models
    import repro_torch.models as port_models

    assert set(ref_models.__all__) <= set(port_models.__all__)
    assert ref_mesh.SINGLE_POD == port_mesh.SINGLE_POD
    assert ref_mesh.MULTI_POD == port_mesh.MULTI_POD


def test_presets_equal_reference():
    assert list(rules.PRESETS) == list(ref_rules.PRESETS)
    for name, ref in ref_rules.PRESETS.items():
        port = rules.PRESETS[name]
        assert port.name == ref.name
        assert dict(port.table) == dict(ref.table)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_specs_equal_reference(arch, mesh_name, preset):
    rmesh, pmesh = _meshes(mesh_name)
    rrules, prules = ref_rules.PRESETS[preset], rules.PRESETS[preset]
    ref, port = RefModel(ref_get_arch(arch)), Model(get_arch(arch), params={}, device="meta")
    assert (_port_specs(port.abstract_params(), port.param_axes(), pmesh, prules)
            == _ref_specs(ref.abstract_params(), ref.param_axes(), rmesh, rrules))
    assert (_port_specs(_abstract_train_state(port), train_state_axes(port), pmesh, prules)
            == _ref_specs(_ref_train_state(ref), ref_train_state_axes(ref), rmesh, rrules))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_state_specs_equal_reference(arch, mesh_name, preset):
    rmesh, pmesh = _meshes(mesh_name)
    rrules, prules = ref_rules.PRESETS[preset], rules.PRESETS[preset]
    rcfg, pcfg = ref_get_arch(arch), get_arch(arch)
    for kind in ("train_4k", "prefill_32k"):
        builder = "train_batch_specs" if kind == "train_4k" else "prefill_batch_specs"
        rb = getattr(ref_model_mod, builder)(rcfg, REF_SHAPES[kind])
        pb = getattr(port_model_mod, builder)(pcfg, SHAPES[kind])
        assert (_port_specs(pb, rules.batch_axes_tree(pb), pmesh, prules)
                == _ref_specs(rb, ref_rules.batch_axes_tree(rb), rmesh, rrules))
    rs = ref_model_mod.decode_input_specs(rcfg, REF_SHAPES["decode_32k"])
    ps = port_model_mod.decode_input_specs(pcfg, SHAPES["decode_32k"])
    assert (_port_specs(ps["state"], rules.state_axes_tree(ps["state"]), pmesh, prules)
            == _ref_specs(rs["state"], ref_rules.state_axes_tree(rs["state"]), rmesh, rrules))
    assert (rules.resolve_spec(("batch",), tuple(ps["tokens"].shape), pmesh, prules)
            == tuple(ref_rules.resolve_spec(("batch",), rs["tokens"].shape, rmesh, rrules)))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_reference(arch):
    rcfg, pcfg = ref_get_arch(arch), get_arch(arch)
    ref, port = RefModel(rcfg), Model(pcfg, params={}, device="meta")
    for dtype in (None, "bfloat16"):
        rp, pp = ref.abstract_params(dtype), port.abstract_params(dtype)
        assert _paths(pp) == _paths(rp)
        assert _meta_leaves(pp) == _sds_leaves(rp)
        assert all(t.device.type == "meta" for t in jax.tree.leaves(pp))
    assert param_bytes(port.specs()) == ref_param_bytes(ref.specs())
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = SHAPES[name]
        if shape.kind == "decode":
            rs = ref_model_mod.decode_input_specs(rcfg, REF_SHAPES[name])
            ps = port_model_mod.decode_input_specs(pcfg, shape)
            assert sorted(ps) == sorted(rs)
            assert _paths(ps["state"]) == _paths(rs["state"])
            assert _meta_leaves(ps) == _sds_leaves(rs)
            B, T = shape.global_batch, shape.seq_len
            ra = ref.abstract_state(B, T, min(T, 4096))
            assert _meta_leaves(port.abstract_state(B, T, min(T, 4096))) == _sds_leaves(ra)
        else:
            builder = "train_batch_specs" if shape.kind == "train" else "prefill_batch_specs"
            rb = getattr(ref_model_mod, builder)(rcfg, REF_SHAPES[name])
            pb = getattr(port_model_mod, builder)(pcfg, shape)
            assert sorted(pb) == sorted(rb)
            assert _meta_leaves(pb) == _sds_leaves(rb)
    if pcfg.family == "ssm":
        for dtype in (None, torch.float32):
            rdt = None if dtype is None else "float32"
            assert (_meta_leaves(abstract_ssm_state(pcfg, 4, dtype))
                    == _sds_leaves(ref_abstract_ssm_state(rcfg, 4, rdt)))


def test_resolve_spec_drops_axes_as_the_reference_does():
    """tests/test_substrate.py's cases, at both production meshes."""
    for mesh_name in MESHES:
        rmesh, pmesh = _meshes(mesh_name)
        for preset in PRESETS:
            for axes, shape in ((("vocab", "embed"), (7, 16)), (("vocab", "embed"), (256206, 1024)),
                                (("batch", "act_seq", "mlp"), (16, 64, 64)),
                                (("batch", "seq", "heads", None), (256, 4096, 9, 64)),
                                (("batch",), (1,)), ((None, None), (3, 5)), ((), ())):
                got = rules.resolve_spec(axes, shape, pmesh, rules.PRESETS[preset])
                want = ref_rules.resolve_spec(axes, shape, rmesh, ref_rules.PRESETS[preset])
                assert got == tuple(want), (mesh_name, preset, axes, shape)
                used = [a for e in got if e for a in ((e,) if isinstance(e, str) else e)]
                assert len(used) == len(set(used))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert rules.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert rules.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        rules.placements((("data", "pod"),), mesh)
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 4))
    assert rules.placements(("data", "model"), one) == [Replicate(), Shard(1)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dtensor_local_shapes_are_dim_over_sizes(mesh_name):
    """On a fake 512-rank world, DTensor's own local shape of each leaf of
    every arch's parameter tree and decode state under the placements of
    each preset equals dim // prod(sizes), the shard shape ``_shard_bytes``
    uses."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, axes = MESHES[mesh_name]
    with port_mesh.fake_world(512):
        mesh = port_mesh.make_mesh(shape, axes)
        for arch in ARCHS:
            model = Model(get_arch(arch), params={}, device="meta")
            state = port_model_mod.decode_input_specs(get_arch(arch), SHAPES["decode_32k"])
            for preset in PRESETS:
                prules = rules.PRESETS[preset]
                for tree, axes_tree in ((model.abstract_params(), model.param_axes()),
                                        (state["state"], rules.state_axes_tree(state["state"]))):
                    def check(t, a):
                        spec = rules.resolve_spec(tuple(a), tuple(t.shape), mesh, prules)
                        pl = rules.placements(spec, mesh)
                        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
                        sizes = dict(zip(axes, shape, strict=True))
                        names = [(e,) if isinstance(e, str) else e or () for e in spec]
                        names += [()] * (t.ndim - len(spec))
                        want = tuple(d // math.prod(sizes[a] for a in n)
                                     for d, n in zip(t.shape, names, strict=True))
                        assert tuple(local) == want == _local_shape(t.shape, pl, mesh)

                    tree_map(check, tree, axes_tree)


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------


def test_shard_is_identity_outside_a_context_and_on_plain_tensors():
    x = torch.randn(4, 8)
    assert ctx.shard(x, "batch", None) is x
    assert ctx.current_ctx() is None and ctx.mesh_axis_size("model") is None
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with ctx.activation_sharding(mesh, rules.PRESETS["fsdp_tp"]):
        assert ctx.current_ctx() == (mesh, rules.PRESETS["fsdp_tp"])
        assert ctx.mesh_axis_size("model") == 2 and ctx.mesh_axis_size("pod") is None
        assert ctx.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            ctx.shard(torch.randn(2, 3, 4), "batch", None)
    assert ctx.current_ctx() is None


def test_exec_config_cp_attention():
    assert ExecConfig().cp_attention == "auto"
    for v in ("auto", "on", "off"):
        assert ExecConfig(cp_attention=v).cp_attention == v
    with pytest.raises(ValueError, match="cp_attention"):
        ExecConfig(cp_attention="sometimes")


def test_meshes_need_a_world_of_their_size():
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_production_mesh()
    with port_mesh.fake_world(8):
        with pytest.raises(RuntimeError, match="need 256 ranks"):
            port_mesh.make_production_mesh()
        mesh = port_mesh.make_mesh((4, 2), ("data", "model"))
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (4, 2)
        assert mesh.device_type == "cpu"
        with pytest.raises(RuntimeError, match="already initialized"):
            with port_mesh.fake_world(8):
                pass
    import torch.distributed as dist

    assert not dist.is_initialized()
    with port_mesh.fake_world(512):
        assert tuple(port_mesh.make_production_mesh(multi_pod=True).shape) == (2, 16, 16)
        assert tuple(port_mesh.make_production_mesh().shape) == (16, 16)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# sharded numerics: 4 processes, gloo, a (2, 2) CPU mesh
# ---------------------------------------------------------------------------

_GLOO = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, store, arch, out):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch._tree import leaves, tree_map, unflatten
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ExecConfig, Model
    from repro_torch.sharding import PRESETS, activation_sharding, batch_axes_tree, tree_shardings

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        rules = PRESETS["fsdp_tp_sp"]
        arch, _, moe_impl = arch.partition("@")
        cfg = get_arch(arch).reduced()
        ex = ExecConfig(attn_impl="xla", remat="none", moe_impl=moe_impl or "vmap")
        model = Model(cfg, ex, params={}, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 32)))
        batch = {"tokens": tok, "labels": tok}
        def loss_and_grads(tree, batch):
            flat = leaves(tree)
            live = [t.detach().requires_grad_(True) for t in flat]
            loss = model.loss(unflatten(tree, live), batch)[0]
            return loss, torch.autograd.grad(loss, live)

        loss, grads = loss_and_grads(params, batch)
        plain = [loss.item(), [g.double().norm().item() for g in grads]]
        place = lambda tree, axes: tree_map(  # noqa: E731
            lambda t, p: distribute_tensor(t, mesh, p), tree,
            tree_shardings(tree, axes, mesh, rules))
        d_params = place(params, model.param_axes())
        with activation_sharding(mesh, rules):
            loss, grads = loss_and_grads(d_params, place(batch, batch_axes_tree(batch)))
        sharded = [loss.full_tensor().item(),
                   [g.full_tensor().double().norm().item() for g in grads]]
        local = tuple(d_params["embed"].to_local().shape)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"plain": plain, "sharded": sharded, "local": local}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.json")
        mp.spawn(worker, args=(4, os.path.join(d, "store"), sys.argv[1], out), nprocs=4)
        print("RESULT " + open(out).read())
"""


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m",
                                  "recurrentgemma-2b", "moonshot-v1-16b-a3b@batched"])
def test_gloo_sharded_loss_equals_plain(arch, tmp_path):
    script = tmp_path / "gloo_loss.py"
    script.write_text(_GLOO)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), arch], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    res = json.loads(line[len("RESULT "):])
    (loss, norms), (want, want_norms) = res["sharded"], res["plain"]
    assert abs(loss - want) <= 1e-6 * abs(want), res
    # every parameter's gradient, summed across the shards and replicas
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5, atol=1e-9)
    # the weights really are sharded: the table's vocab over model, embed over data
    cfg = get_arch(arch.partition("@")[0]).reduced()
    assert tuple(res["local"]) == (cfg.vocab // 2, cfg.d_model // 2)
