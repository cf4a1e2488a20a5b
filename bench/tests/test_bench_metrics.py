"""The per-layer readers on made-up traces: the attention patterns pick the
program's kernel 3 and the libraries' attention kernels and nothing else,
and a reader with nothing to read returns nothing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import tiny
from common import load_module

ROOFLINE = load_module(tiny.BENCH / "metrics" / "attn_roofline.prompt.py")
COUNTS = load_module(tiny.BENCH / "counts" / "transformer.py")

ATTENTION = [
    "void (anonymous namespace)::flash_attention_kernel_mma<128>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int)",
    "void (anonymous namespace)::flash_attention_kernel<float>(float const*, float const*)",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 128, 64, 4, false, "
    "false, cutlass::bfloat16_t>, false, true, false>(Flash_fwd_params)",
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel)",
    "cudnn_generated_fort_native_sdpa_sm90_knob_7_64x128x128_4x1x1_kernel0_0",
]
OTHER = [
    "nvjet_tst_128x16_64x11_2x1_v_bz_NNT",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda"
    "(at::TensorIteratorBase&)::{lambda()#3}>",
    "void gemv2N_kernel<int, int, float, float, float, float, 128, 1, 2, 4, 1, false>",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps>>",
]


@pytest.mark.parametrize("name", ATTENTION)
def test_attention_kernels_are_picked(name):
    assert ROOFLINE.is_attention(name)


@pytest.mark.parametrize("name", OTHER)
def test_other_kernels_are_not(name):
    assert not ROOFLINE.is_attention(name)


def _run(trace):
    a = tiny.CONFIGS["tiny-vlm"]["as_run"]
    return SimpleNamespace(prefill_trace=trace, peak={"bf16_flops_s": 989e12,
                                                      "hbm_bytes_s": 3.35e12},
                           traffic=SimpleNamespace(batch_size=2, prompt=8), counts=COUNTS,
                           as_run=a)


def test_roofline_share_is_the_bound_over_the_median_launch():
    ops, n_bytes = COUNTS.attention_launch(tiny.CONFIGS["tiny-vlm"]["as_run"], 2, 8)
    bound_ns = max(ops / 989e12, n_bytes / 3.35e12) * 1e9
    trace = [(ATTENTION[0], 0, 100), (OTHER[0], 100, 900), (ATTENTION[0], 1000, 1300),
             (ATTENTION[0], 2000, 2200)]
    assert ROOFLINE.read(_run(trace)) == pytest.approx(100 * bound_ns / 200)


def test_a_reader_with_nothing_to_read_returns_nothing():
    assert ROOFLINE.read(_run([(OTHER[0], 0, 100)])) is None
