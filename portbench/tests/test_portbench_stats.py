"""The frozen arithmetic on known answers: percentiles, spreads, the
union of intervals, and a synthetic trace's idle share and families."""

import statistics

import pytest

from portbench import registry
from portbench.lib import trace as tr
from portbench.lib.stats import gaps, percentile, spread, union_length


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))           # 1 .. 100
    assert percentile(xs, 90) == pytest.approx(90.1)
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile([5.0], 90) == 5.0
    assert percentile([3, 1, 2], 100) == 3


def test_spread_is_statistics_quartiles_over_the_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 20)]
    assert union_length(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert gaps([], 0, 1) == [(0, 1)]
    assert union_length(iv, 4, 5.6) == pytest.approx(0.6)


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_a_synthetic_trace():
    fams = tr.Families(registry.families())
    events = [
        _ev("sm90_xmma_fprop_implicit_gemm_bf16", 100, 300),
        _ev("void cudnn::engines_precompiled::nchwToNhwcKernel", 350, 100),
        _ev("vectorized_elementwise_kernel", 600, 100),
        _ev("Memcpy HtoD", 800, 50, cat="gpu_memcpy"),
        _ev("aten::conv2d", 0, 1000, cat="cpu_op"),     # not the card's
        _ev("void wavelet_dec_kernel<float>", 1100, 10),  # after the window
    ]
    s = tr.summarize(events, fams, 0.0, 1000.0,
                     [(0.0, 900.0, "restore_call"), (900.0, 1000.0, "sync")])
    assert s["window_s"] == pytest.approx(1e-3)
    # [100, 450] as two overlapping kernels, [600, 700], [800, 850]
    assert s["busy_s"] == pytest.approx(350e-6 + 100e-6 + 50e-6)
    assert s["conv_s"] == pytest.approx(400e-6)
    assert s["family_s"]["memcpy"] == pytest.approx(50e-6)
    assert "wavelet" not in s["family_s"]
    # the gaps, longest first: [450, 600], [850, 1000], [0, 100], [700, 800]
    assert s["idle_gaps"] == [["restore_call", pytest.approx(150e-6)],
                              ["sync", pytest.approx(150e-6)],
                              ["restore_call", pytest.approx(100e-6)],
                              ["restore_call", pytest.approx(100e-6)]]
    assert s["device_ops"][0][0].startswith("cudnn_conv | sm90_xmma_fprop")


@pytest.mark.parametrize("name,family", [
    ("void wavelet_rec_kernel<float>", "wavelet"),
    ("void group_norm_onchip_kernel<__nv_bfloat16>", "group_norm"),
    ("void conv_kernel<WgmmaBf16>", "fused_conv"),
    ("sm90_xmma_dgrad_implicit_gemm_f32f32", "cudnn_conv"),
    ("void DSE::vector_fft<0, 1, 128, 8, 8, 1, float, float, float2>",
     "cudnn_fft_conv"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8",
     "cudnn_fft_conv"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>", "cudnn_fft_conv"),
    ("cutlass_80_tensorop_s1688gemm", "gemm"),
    ("void at::native::softmax_warp_forward<float>", "softmax"),
    ("RowwiseMomentsCUDAKernel<float>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("some_new_kernel", "other"),
])
def test_families_by_name(name, family):
    assert tr.Families(registry.families()).of(name) == family
