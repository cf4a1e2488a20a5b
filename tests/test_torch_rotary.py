"""The rotary kernel's routes and wrapper on the CPU (kernel 8,
``kernels/rotary.py``; its card tests are ``test_torch_rotary_cuda.py``).

CPU tensors, and ``attn_impl="xla"`` on any device, rotate q and k by the
plain route, ``layers.apply_rope`` / ``apply_mrope``: what each caller
computed before the kernel, bit for bit.  The wrapper refuses what the
kernel does not take before it looks for a card, so its checks run here,
and the launch counts know the kernel's name.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import counts, ops, rotary  # noqa: E402
from repro_torch.kernels.rotary import _strides, _vec, rotary_cuda, rotary_plain  # noqa: E402
from repro_torch.models import ExecConfig, Model  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.model import decode_launches, prefill_launches  # noqa: E402

THETA = 1e6


def _qk(B=2, S=5, Hq=3, Hk=2, D=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, S, Hq, D), generator=g).to(dtype),
            torch.randn((B, S, Hk, D), generator=g).to(dtype))


def _mrope_positions(B, S, seed=0):
    """Distinct t, h and w streams, as image patches have them."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 8200, (B, S, 3), generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sections", [None, (2, 3, 3)], ids=["rope", "mrope"])
def test_cpu_tensors_take_the_plain_route_bit_for_bit(dtype, sections):
    q, k = _qk(dtype=dtype)
    pos = (_mrope_positions(2, 5) if sections else
           torch.randint(0, 8200, (2, 5), generator=torch.Generator().manual_seed(1)))
    if sections:
        want = (layers.apply_mrope(q, pos, THETA, sections),
                layers.apply_mrope(k, pos, THETA, sections))
    else:
        want = layers.apply_rope(q, pos, THETA), layers.apply_rope(k, pos, THETA)
    q0, k0 = q.clone(), k.clone()
    for got in (ops.rotary(q, k, pos, THETA, sections), rotary_plain(q, k, pos, THETA, sections)):
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert torch.equal(q, q0) and torch.equal(k, k0)  # the plain route leaves them as they were


ARCHS = ["smollm-135m", "qwen2-vl-2b", "moonlight-16b-a3b", "recurrentgemma-2b"]


def _batch(cfg, B=2, S=6):
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    if cfg.rope == "mrope":
        batch["positions"] = torch.randint(0, 40, (B, S, 3), generator=g)
    return batch


@pytest.mark.parametrize("name", ARCHS)
def test_both_routes_on_the_cpu_rotate_by_apply_rope(monkeypatch, name):
    """A model's forward on the CPU rotates through ``apply_rope`` /
    ``apply_mrope`` (``kernels.rotary``, which ``layers`` names) under
    either ``attn_impl``, once for q and once for k in every layer that
    rotates."""
    cfg = get_arch(name).reduced()
    calls = []
    for fn in ("apply_rope", "apply_mrope"):
        real = getattr(rotary, fn)
        assert getattr(layers, fn) is real
        monkeypatch.setattr(rotary, fn, lambda *a, _r=real, _n=fn: calls.append(_n) or _r(*a))
    params = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").params
    batch = _batch(cfg)
    for impl in ("pallas", "xla"):
        calls.clear()
        Model(cfg, ExecConfig(attn_impl=impl), params=params, device="cpu").forward(batch)
        n = prefill_launches(cfg)["rotary"]
        assert calls == ["apply_mrope" if cfg.rope == "mrope" else "apply_rope"] * (2 * n)


def test_the_rotary_helper_is_the_plain_functions_on_either_route():
    q, k = _qk(D=16)
    pos = _mrope_positions(2, 5)
    for impl in ("pallas", "xla"):
        got = transformer._rotary(ExecConfig(attn_impl=impl), q, k, pos, THETA, (2, 3, 3))
        assert torch.equal(got[0], layers.apply_mrope(q, pos, THETA, (2, 3, 3)))
        assert torch.equal(got[1], layers.apply_mrope(k, pos, THETA, (2, 3, 3)))


@pytest.mark.parametrize("case,match", [
    ("sections", "do not cover"),
    ("zero_section", "do not cover"),
    ("last_axis", "dense along their last axis"),
    ("positions_rope", "do not fit"),
    ("positions_mrope", "do not fit"),
    ("positions_streams", "do not fit"),
    ("odd", "odd"),
    ("wide", "at most"),
    ("many_sections", "at most"),
    ("heads_shape", "want q"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    q, k = _qk(D=16)
    pos2, pos3 = torch.zeros((2, 5), dtype=torch.long), torch.zeros((2, 5, 3), dtype=torch.long)
    args = {
        "sections": (q, k, pos3, (2, 3, 2)),
        "zero_section": (q, k, pos3, (0, 4, 4)),
        "last_axis": (q.transpose(2, 3).contiguous().transpose(2, 3), k, pos2, None),
        "positions_rope": (q, k, pos3, None),
        "positions_mrope": (q, k, pos2, (2, 3, 3)),
        "positions_streams": (q, k, pos3[..., :2], (2, 3, 3)),
        "odd": (q[..., :15], k[..., :15], pos2, None),
        "wide": (*_qk(D=1024), pos2, None),
        "many_sections": (q, k, torch.zeros((2, 5, 5), dtype=torch.long), (1, 1, 2, 2, 2)),
        "heads_shape": (q, k[:1], pos2, None),
    }[case]
    with pytest.raises(ValueError, match=match):
        rotary_cuda(args[0], args[1], args[2], THETA, args[3])


def test_the_wrapper_refuses_types_grad_and_cpu_tensors():
    q, k = _qk(D=16)
    pos = torch.zeros((2, 5), dtype=torch.long)
    with pytest.raises(TypeError, match="int32 or int64"):
        rotary_cuda(q, k, pos.float(), THETA)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rotary_cuda(q.half(), k.half(), pos, THETA)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rotary_cuda(q, k.bfloat16(), pos, THETA)
    with pytest.raises(RuntimeError, match="no backward"):
        rotary_cuda(q.requires_grad_(), k, pos, THETA)
    with pytest.raises(ValueError, match="one CUDA device"):
        rotary_cuda(q.detach(), k, pos, THETA)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.rotary(q.detach().to("meta"), k.to("meta"), pos.to("meta"), THETA)


def test_the_wrapper_loads_16_bytes_where_rows_and_heads_allow():
    """``_vec``: 16 bytes a load (8 bf16, 4 float32) when every row and
    head starts 16-byte aligned and the half width is whole units, else one
    element; an axis of one has no stride to align."""
    q = torch.zeros((2, 3, 16, 192), dtype=torch.bfloat16)
    kv = torch.zeros((2, 3, 576), dtype=torch.bfloat16)
    q_rope, kr = q[..., 128:], kv[:, :, None, 512:]  # latent attention's rope columns
    assert _strides(kr) == (3 * 576, 576, 0) and _vec(32, q_rope, kr) == 8
    assert _vec(32, q_rope.float(), kr.float()) == 4
    assert _vec(4, q[..., 184:], kv[:, :, None, 568:]) == 1  # the reduced model's half of 4
    odd = torch.zeros((2, 3, 4, 129), dtype=torch.bfloat16)[..., 1:]  # rows off 16 bytes
    assert _vec(64, odd, odd) == 1
    padded = torch.zeros((2, 3, 4, 132), dtype=torch.bfloat16)[..., :128]  # strides off 16 B
    assert _vec(64, padded, padded) == 1
    shifted = torch.zeros((2, 3, 4, 136), dtype=torch.bfloat16)[..., 8:]  # 16 B in, aligned
    assert _vec(64, shifted, shifted) == 8


def test_the_launch_counts_know_the_rotary_kernel():
    names = ["void (anonymous namespace)::rotary_kernel<__nv_bfloat16, 8>((anonymous "
             "namespace)::Args)",
             "_ZN12_GLOBAL__N_113rotary_kernelIfLi4EEEvNS_4ArgsE",
             "void (anonymous namespace)::rotary_kernel_extra<float, 1>(Args)"]
    assert counts.seen(names) == {"rotary": 2}
    assert "rotary" in counts.read()
    assert decode_launches(get_arch("qwen2-vl-2b"), 1) == {"decode_attention": 28,
                                                                  "rotary": 28}
    assert decode_launches(get_arch("moonlight-16b-a3b"), 1) == {"mla_decode": 27,
                                                                        "rotary": 27}
    assert decode_launches(get_arch("recurrentgemma-2b"), 2) == {"rotary": 16}
    assert decode_launches(get_arch("mamba2-130m"), 2) == {}
    assert prefill_launches(get_arch("qwen2-vl-2b")) == {"flash_attention": 28,
                                                               "rotary": 28}
    seamless = get_arch("seamless-m4t-large-v2")
    assert "rotary" not in prefill_launches(seamless)
    with_rope = dataclasses.replace(seamless, rope="rope")
    assert prefill_launches(with_rope)["rotary"] == 24 + 24
    assert decode_launches(with_rope, 1)["rotary"] == 24
