"""The MoE layer's fixed-order backward, and ``transformer.abstract_cache``,
on the CPU.

``layers._slots`` reads each token ``top_k`` times with ``torch.gather``,
whose own backward adds a token's ``top_k`` rows with atomics on the card,
in no fixed order.  It now reads them through ``layers._TokenRows``: the
same gather forward, and a backward through ``index_put_(accumulate=True)``,
which sorts the indices and adds in one order.  Here the old formulation
is kept as a local helper: ``moe_layer``'s outputs, router probabilities
and slot buffers are bitwise what they were under both ``moe_impl``s,
where the layer drops tokens and where it keeps them all, in float32 and
bfloat16; its gradients lie within 1e-6 of the old ones and within the
reference's 1e-4 of the JAX package's.  ``abstract_cache`` gives the JAX
package's shapes and dtypes for the reduced configs of all six families.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_backward.py
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

FAMILY_ARCHS = ["smollm-135m", "moonshot-v1-16b-a3b", "mamba2-130m", "recurrentgemma-2b",
                "seamless-m4t-large-v2", "qwen2-vl-2b"]  # dense, moe, ssm, hybrid, encdec, vlm
# 3 rows of 40 tokens, top-2 of 8 experts (test_torch_models_moe_vlm_encdec's
# shape): at factor 1.25 experts overflow and drop pairs, at 4 none does;
# the gradients also at top-6 (moonshot-v1-16b-a3b's k: six rows a token)
B, S, D, E, F, K = 3, 40, 16, 8, 24, 2
GRAD_REL = 1e-6  # the new backward against the old one, on the CPU
REF_TOL = dict(rtol=1e-4, atol=1e-4)  # against the JAX package, as the MoE parity tests


def _gather_slots(x, e_s, pos, keep, w_s, order, *, lo, hi, n_experts, top_k, capacity):
    """``layers._slots`` as it was: the pairs read with ``torch.gather``."""
    Bx, _, Dx = x.shape
    SK = e_s.shape[1]
    mine, e_mine = layers._mine(e_s, keep, lo, hi, n_experts)
    pos_c = torch.where(mine, pos, capacity)
    b_idx = torch.arange(Bx, device=x.device)[:, None]
    x_sorted = torch.gather(x, 1, (order // top_k)[..., None].expand(Bx, SK, Dx))
    buf = torch.zeros((Bx, hi - lo, capacity + 1, Dx), dtype=x.dtype, device=x.device)
    buf[b_idx, e_mine, pos_c] = x_sorted * mine[..., None].to(x.dtype)
    return (buf,)


def _inputs(seed: int, dtype=torch.float32) -> list:
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, S, D)), rng.standard_normal((D, E)) * 0.5,
              rng.standard_normal((E, D, F)) * 0.2, rng.standard_normal((E, D, F)) * 0.2,
              rng.standard_normal((E, F, D)) * 0.2]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _layer(args, cf: float, impl: str, k: int = K):
    return layers.moe_layer(*args, top_k=k, capacity_factor=cf, impl=impl)


def _grads(args, cf: float, impl: str, cot: torch.Tensor, k: int = K) -> list:
    """The gradients of every input of ``sum(out * cot) + aux``."""
    live = [a.detach().clone().requires_grad_(True) for a in args]
    out, probs = _layer(live, cf, impl, k)
    loss = (out.float() * cot).sum() + layers.moe_aux_loss(probs, k)
    return [g.float() for g in torch.autograd.grad(loss, live)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_forward_is_bitwise_the_old_one(impl, cf, dtype, monkeypatch):
    args = _inputs(1, dtype)
    with torch.no_grad():
        out, probs = _layer(args, cf, impl)
        x, router = args[:2]
        capacity = max(1, int(np.ceil(S * K / E * cf)))
        route = layers._route(x, router, top_k=K, capacity=capacity)[1:]
        slots = [layers._slots(x, *route, lo=lo, hi=hi, n_experts=E, top_k=K,
                               capacity=capacity)[0] for lo, hi in ((0, E), (2, 5))]
        monkeypatch.setattr(layers, "_slots", _gather_slots)
        old_out, old_probs = _layer(args, cf, impl)
        old_slots = [_gather_slots(x, *route, lo=lo, hi=hi, n_experts=E, top_k=K,
                                   capacity=capacity)[0] for lo, hi in ((0, E), (2, 5))]
    assert torch.equal(out, old_out) and torch.equal(probs, old_probs)
    for got, want in zip(slots, old_slots, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)
    kept = int(route[2].sum())  # the pairs the slots keep: fewer than all where cf drops
    assert (kept < B * S * K) == (cf < 2), kept


@pytest.mark.parametrize("k", [K, 6])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_gradients_within_1e6_of_the_old_ones(impl, cf, k, monkeypatch):
    args = _inputs(2)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32))
    got = _grads(args, cf, impl, cot, k)
    monkeypatch.setattr(layers, "_slots", _gather_slots)
    want = _grads(args, cf, impl, cot, k)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_REL * scale, (i, float((g - w).abs().max()))
    assert float(got[0].abs().max()) > 0  # the input's gradient flows through the slots


@pytest.mark.parametrize("k", [K, 6])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("impl", ["vmap", "batched"])
def test_gradients_match_the_reference(impl, cf, k):
    args = _inputs(4)
    cot = np.random.default_rng(5).standard_normal((B, S, D)).astype(np.float32)

    def ref_loss(*a):
        out, probs = ref_layers.moe_layer(*a, top_k=k, capacity_factor=cf, impl=impl)
        return jnp.sum(out * cot) + ref_layers.moe_aux_loss(probs, k)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(*(jnp.asarray(a.numpy()) for a in args))
    got = _grads(args, cf, impl, torch.from_numpy(cot), k)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **REF_TOL)


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_abstract_cache_matches_reference(name):
    cfg, ref_cfg = get_arch(name).reduced(), ref_get_arch(name).reduced()
    for dtype, ref_dtype in ((None, None), (torch.float32, "float32")):
        got = transformer.abstract_cache(cfg, 3, 24, dtype)
        want = ref_transformer.abstract_cache(ref_cfg, 3, 24, ref_dtype)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want, strict=True):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert "abstract_cache" not in transformer.__all__  # as the reference keeps it
    assert "abstract_cache" not in ref_transformer.__all__
