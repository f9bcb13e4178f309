"""The readers of label.tower_pct, label.conv_roofline_pct and train.nccl_pct on records built from kernel names
that the card's traces hold: what each counts, what it leaves out, and None where it finds nothing."""

from __future__ import annotations

import pytest

from portbench import roofline_resnet, run

RECORD_NAMES = {
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8_stage3_warpsize2x2x1": 6.0,
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_warpsize2x2x1_ffma_aligna8_alignc8": 0.5,
    "void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int, int, int)": 0.25,
    "void DSE::vector_fft<0, 1, 128, 8, 8, 1, float, float, float2>(float2*, float2*, int, int3, int3)": 0.125,
    "void convolve_common_engine_float_NHWC<float, float, 1024, 5, 5, 3, 3, 3, true, false, false>": 0.125,
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>": 9.0,
    "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(float, float)": 9.0,
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4": 9.0,
    "nccl:all_reduce": 2.0,
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 2.0,
}


def reader(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py").read


def record(work):
    return {"window_s": 40.0, "kernels": {n: [s, 1] for n, s in RECORD_NAMES.items()}, "work": work}


def test_conv_roofline_counts_convolution_kernels_only():
    flops = 495e12 * 0.7  # 0.7 s at the peak, over the 7.0 s of convolution kernels above
    assert reader("label.conv_roofline_pct")(record({"conv_flops": flops, "dtype": "float32"})) == pytest.approx(10.0)
    assert reader("label.conv_roofline_pct")(record({"dtype": "float32"})) is None


def test_nccl_share_counts_kernels_not_ranges():
    assert reader("train.nccl_pct")(record({})) == pytest.approx(5.0)
    assert reader("train.nccl_pct")({"window_s": 1.0, "kernels": {"nccl:all_reduce": [1.0, 1]}, "work": {}}) is None


def test_tower_share_is_none_without_the_counter():
    assert reader("label.tower_pct")(record({"tower_s": 30.0})) == pytest.approx(75.0)
    assert reader("label.tower_pct")(record({})) is None


def test_resnet_counts_by_hand():
    # the ModifiedResNet-50 at 224 (a 3-conv stem): 5.37 G multiply-adds of convolutions; RN50x64 at 448: 507.0
    # GFLOP of convolutions and 13.3 of the attention pool, 199 convolutions (the stem, 64 blocks, 4 shortcuts)
    assert round(roofline_resnet.conv_flops_per_frame(64, (3, 4, 6, 3), 224) / 2e9, 2) == 5.37
    assert round(roofline_resnet.conv_flops_per_frame(128, (3, 15, 36, 10), 448) / 1e9, 1) == 507.0
    assert round(roofline_resnet.attnpool_flops_per_frame(128, 448, 1024) / 1e9, 1) == 13.3
    assert len(roofline_resnet.conv_layers(128, (3, 15, 36, 10), 448)) == 3 + 3 * 64 + 4
