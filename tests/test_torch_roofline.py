"""The port's roofline against the JAX package's, and its trace counter.

Exact: ``parse_hlo_costs`` and ``collective_bytes`` on every HLO string of
tests/test_roofline.py (the two synthetic modules, and the text of the
jax-compiled functions that file builds: a loop-free product, a scan at
two depths, nested scans, ``a @ b``), ``roofline_terms`` and
``RooflineResult`` (terms, bottleneck, step time, useful-FLOPs share,
MFU, ``to_row``) on the same numbers.  ``count_costs()`` counts per
device: one ``(B, S, D) @ (D, F)`` product with the batch over 'data'
and F over 'model' on a (4, 2) fake mesh reads exactly
``2·B·S·D·F / 8`` dot FLOPs, and its ``a @ b`` case of
``test_analyze_compiled_end_to_end`` reads a useful-FLOPs share of 1.0
within 5%.
"""

import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import hlo_costs as ref_hlo  # noqa: E402
from repro_torch.roofline import analysis, hlo_costs  # noqa: E402
from repro_torch.roofline.trace_costs import TraceCosts, count_costs, counting  # noqa: E402

_SYNTH_AR_AG = """
HloModule m

ENTRY %main (p: f32[8,16]) -> f32[8,16] {
  %p = f32[8,16]{1,0} parameter(0)
  %ar = f32[8,16]{1,0} all-reduce(%p), replica_groups={}
  ROOT %ag = f32[8,32]{1,0} all-gather(%ar), dimensions={1}
}
"""

_SYNTH_DEFS = """
HloModule m

ENTRY %main (p: f32[8,16]) -> f32[8,16] {
  %p = f32[8,16]{1,0} parameter(0)
  %c = f32[8,16]{1,0} copy(%p)
  %ar = f32[8,16]{1,0} all-reduce(%c), replica_groups={}
  ROOT %r = f32[8,16]{1,0} copy(%ar)
}
"""


def _loop_free():
    a, b = jnp.ones((64, 128)), jnp.ones((128, 32))
    return jax.jit(lambda a, b: (a @ b).sum()).lower(a, b).compile().as_text()


def _scan(L):
    def f(x, ws):
        def body(h, w):
            return jnp.tanh(h @ w), ()

        h, _ = jax.lax.scan(body, x, ws)
        return h.sum()

    return jax.jit(f).lower(jnp.ones((32, 64)), jnp.ones((L, 64, 64))).compile().as_text()


def _nested():
    def f(x, ws):
        def outer(h, w):
            def inner(h2, _):
                return jnp.tanh(h2 @ w), ()

            h2, _ = jax.lax.scan(inner, h, jnp.arange(3))
            return h2, ()

        h, _ = jax.lax.scan(outer, x, ws)
        return h.sum()

    return jax.jit(f).lower(jnp.ones((16, 32)), jnp.ones((5, 32, 32))).compile().as_text()


def _matmul():
    a = jnp.ones((64, 64))
    return jax.jit(lambda a, b: a @ b).lower(a, a).compile().as_text()


HLO = {
    "synthetic_all_reduce_all_gather": lambda: _SYNTH_AR_AG,
    "synthetic_defs": lambda: _SYNTH_DEFS,
    "loop_free": _loop_free,
    "scan_2": lambda: _scan(2),
    "scan_8": lambda: _scan(8),
    "nested_scans": _nested,
    "matmul": _matmul,
    "empty": lambda: "",
}


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("name", list(HLO))
def test_hlo_walker_equals_reference(name):
    text = HLO[name]()
    got, want = hlo_costs.parse_hlo_costs(text), ref_hlo.parse_hlo_costs(text)
    assert _fields(got) == _fields(want)
    assert (got.flops, got.total_coll_bytes) == (want.flops, want.total_coll_bytes)
    assert _fields(got.scaled(3.0)) == _fields(want.scaled(3.0))
    c, r = analysis.collective_bytes(text), ref_analysis.collective_bytes(text)
    assert (c.per_op, c.per_op_count, c.total_bytes, c.total_count) == (
        r.per_op, r.per_op_count, r.total_bytes, r.total_count)


def test_hlo_walker_reads_the_references_cases():
    """tests/test_roofline.py's own expectations, on the port's walker."""
    assert hlo_costs.parse_hlo_costs(_loop_free()).dot_flops == pytest.approx(
        2 * 64 * 128 * 32, rel=0.01)
    f2, f8 = (hlo_costs.parse_hlo_costs(_scan(L)).dot_flops for L in (2, 8))
    assert f8 == pytest.approx(4 * f2, rel=0.01)
    assert hlo_costs.parse_hlo_costs(_nested()).dot_flops == pytest.approx(
        5 * 3 * 2 * 16 * 32 * 32, rel=0.01)
    stats = analysis.collective_bytes(_SYNTH_AR_AG)
    assert stats.per_op_count["all-reduce"] == 1 and stats.per_op_count["all-gather"] == 1
    assert stats.per_op["all-reduce"] == 8 * 16 * 4


@pytest.mark.parametrize("numbers", [
    (197e12, 819e9, 0.0), (1.3e13, 2.5e12, 6.7e10), (0.0, 0.0, 0.0), (1.0, 1e15, 3e11)])
def test_roofline_terms_and_result_equal_reference(numbers):
    flops, hbm, coll = numbers
    assert analysis.roofline_terms(flops, hbm, coll) == ref_analysis.roofline_terms(
        flops, hbm, coll)
    assert analysis.roofline_terms(flops, hbm, coll, links=2) == ref_analysis.roofline_terms(
        flops, hbm, coll, links=2)
    kw = dict(arch="a", shape="s", mesh="single", n_chips=256, flops_per_device=flops,
              hbm_bytes_per_device=hbm, coll_bytes_per_device=coll,
              bytes_per_device_peak=3e9, model_flops=8.4e14)
    port = analysis.RooflineResult(**kw, coll=analysis.CollectiveStats({"all-gather": 3}, {
        "all-gather": 1}))
    ref = ref_analysis.RooflineResult(**kw, coll=ref_analysis.CollectiveStats(
        {"all-gather": 3}, {"all-gather": 1}))
    assert port.terms() == ref.terms()
    assert port.step_time() == ref.step_time()
    assert port.useful_flops_frac() == ref.useful_flops_frac()
    assert port.mfu() == ref.mfu()
    if any(numbers):
        assert port.bottleneck() == ref.bottleneck()
    assert port.to_row() == ref.to_row()


def test_analyze_compiled_takes_hlo_text_as_the_reference_does():
    text = _matmul()
    kw = dict(arch="t", shape="s", mesh_name="m", n_chips=1, model_flops=2 * 64 ** 3)
    port = analysis.analyze_compiled(None, **kw, hlo_text=text)
    ref = ref_analysis.analyze_compiled(None, **kw, hlo_text=text)
    for f in ("flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device"):
        assert getattr(port, f) == getattr(ref, f)
    assert port.coll.per_op == ref.coll.per_op


# ---------------------------------------------------------------------------
# count_costs
# ---------------------------------------------------------------------------


def test_analyze_compiled_end_to_end():
    """test_roofline.py's case on the port: ``a @ b`` traced by count_costs."""
    a = torch.ones(64, 64)
    with count_costs() as rec:
        a @ a
    res = analysis.analyze_compiled(rec, arch="t", shape="s", mesh_name="m", n_chips=1,
                                    model_flops=2 * 64 * 64 * 64)
    assert res.flops_per_device > 0
    assert res.bottleneck() in ("compute", "memory", "collective")
    assert res.to_row()["useful_flops_frac"] == pytest.approx(1.0, rel=0.05)
    assert rec.dot_flops == 2 * 64 ** 3
    assert rec.bytes == 3 * 64 * 64 * 4  # two operands and the result
    assert res.bytes_per_device_peak == rec.peak_bytes == 64 * 64 * 4


def test_count_costs_elementwise_bytes_and_peak():
    x = torch.ones(1024, 256)
    with count_costs() as rec:
        for _ in range(5):
            y = torch.exp(x * 2.0)  # two ops of 2^18 elements each
            del y
        s = x.sum()
        v = x.view(256, 1024).t()  # views move nothing
        d = x.detach()
    del s, v, d
    n = 1024 * 256
    assert rec.dot_flops == 0
    assert rec.ew_flops == 10 * n + 1
    assert rec.bytes == 10 * 2 * 4 * n + 4 * n + 4
    # one step's product and exp live at once; each loop frees both
    assert rec.peak_bytes == 2 * 4 * n
    assert isinstance(rec, TraceCosts) and rec.total_coll_bytes == 0


def test_count_costs_by_op_adds_up_to_the_totals():
    """experiments/dryrun_by_op.py's breakdown of the counter: each op's
    count, FLOPs and bytes, summing to the totals, and the bytes each op
    created that are live at the peak, summing to the peak."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "experiments" / "dryrun_by_op.py"
    spec = importlib.util.spec_from_file_location("dryrun_by_op", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    x = torch.ones(256, 128)
    w = torch.ones(128, 64)
    rec = TraceCosts()
    mode = script.ByOpMode(rec)
    with counting(mode):
        y = torch.exp(x @ w)
        z = y * 2.0
        del y
    by_op = mode.breakdown()
    assert set(by_op) == {"mm", "exp", "mul"}
    assert all(v["count"] == 1 for v in by_op.values())
    assert by_op["mm"]["flops"] == rec.dot_flops == 2 * 256 * 128 * 64
    assert sum(v["flops"] for v in by_op.values()) == rec.flops
    assert sum(v["bytes"] for v in by_op.values()) == rec.bytes
    # the peak is first reached with the product and its exp live (the
    # product dies before the scaled copy is made)
    assert sum(v["peak_bytes"] for v in by_op.values()) == rec.peak_bytes
    assert by_op["mm"]["peak_bytes"] == by_op["exp"]["peak_bytes"] == z.numel() * 4
    assert by_op["mul"]["peak_bytes"] == 0


def test_count_costs_counts_per_device_on_a_fake_mesh():
    """One (B, S, D) @ (D, F) with the batch over 'data' and F over 'model'
    on a (4, 2) fake mesh: 2·B·S·D·F / 8 dot FLOPs a device, no collective;
    then moving F's shards onto the batch is one all-gather of the local
    result's bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_mesh

    B, S, D, F = 8, 16, 32, 64
    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"))
        x = DTensor.from_local(torch.empty(B // 4, S, D, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(D, F // 2, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with count_costs() as rec:
            y = x @ w
        assert rec.dot_flops == 2 * B * S * D * F / 8
        assert rec.total_coll_bytes == 0
        assert tuple(y.to_local().shape) == (B // 4, S, F // 2)
        with count_costs() as rec:
            y.redistribute(mesh, [Shard(0), Replicate()])
        assert rec.dot_flops == 0
        assert rec.coll_counts["all-gather"] == 1
        assert rec.coll_bytes["all-gather"] == (B // 4) * S * (F // 2) * 4


def test_count_costs_restores_dtensor_propagation():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    before = ShardingPropagator._propagate_tensor_meta_non_cached
    with count_costs():
        assert ShardingPropagator._propagate_tensor_meta_non_cached is not before
    assert ShardingPropagator._propagate_tensor_meta_non_cached is before
