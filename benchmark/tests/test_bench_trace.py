"""The trace attribution on a synthetic Chrome trace: buckets (NCCL
included), kernels by the span that launched them with nested and
overlapping spans, the union of busy time, idle and its gaps."""

import pytest

from benchmark.harness.trace import Trace, bucket_of, is_port_kernel, union_length


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    # one tick 0-100 us on the host; forecast 5-20 inside controller? no:
    # forecast 5-20, controller 18-40 (overlapping forecast by 2 us), fetch 40-90
    return [
        ev("user_annotation", "tick", 0, 100),
        ev("user_annotation", "forecast", 5, 15),
        ev("user_annotation", "controller", 18, 22),
        ev("user_annotation", "fetch", 40, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 19, 1, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 25, 1, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 41, 1, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1, corr=5),
        ev("kernel", "nvjet_tst_128x288_64x4_1x2_h_bz_coopA_TNT", 10, 10, corr=1),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 20, 5, corr=2),
        ev("kernel", "void step_whole_kernel<__nv_bfloat16>(ndp::StepPtrs)", 30, 40, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 72, 3, corr=4),
        ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 60, 20,
           corr=5),
        ev("kernel", "mystery", 95, 0),  # zero length: not a kernel event
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 6},
    ]


def test_buckets():
    assert bucket_of("ncclDevKernel_AllGather_RING_LL") == "nccl"
    assert bucket_of("void step_whole_kernel<float>") == "step_whole_kernel"
    assert bucket_of("ipm_whole_kernel") == "ipm_kernel"
    assert bucket_of("riccati_backward_glue") == "ipm_kernel"
    assert bucket_of("linearize_kernel") == "linearize_kernel"
    assert bucket_of("sm80_xmma_gemm_f32f32") == "gemm"
    assert bucket_of("Memcpy DtoH (Device -> Pinned)") == "layout_copies"
    assert bucket_of("at::native::reduce_kernel") == "torch_glue"
    assert bucket_of("mystery") == "other"
    assert is_port_kernel("step_whole_kernel") and not is_port_kernel("ncclKernel")


def test_union_and_idle():
    assert union_length([(0, 10), (5, 12), (20, 25)]) == 17
    tr = Trace.from_events(synthetic(), n_ticks=1)
    assert tr.window == (0, 100)
    # kernels 10-20, 20-25, 30-70, 60-80 (overlapping), 72-75: union 10-25, 30-80
    assert tr.busy_us() == 65
    assert tr.idle_pct() == pytest.approx(35.0)


def test_kernels_by_span():
    tr = Trace.from_events(synthetic(), n_ticks=2)
    names = lambda ks: sorted(k.name[:12] for k in ks)
    assert names(tr.in_span("forecast")) == ["nvjet_tst_12", "void at::nat"]
    assert names(tr.in_span("controller")) == ["void at::nat", "void step_wh"]
    assert names(tr.in_span("fetch")) == ["Memcpy DtoH ", "ncclDevKerne"]
    assert len(tr.in_span("tick")) == 5
    assert tr.per_tick_ms(tr.in_span("fetch")) == pytest.approx((3 + 20) / 1e3 / 2)
    b = tr.by_bucket_ms()
    assert b["nccl"] == pytest.approx(0.010) and b["step_whole_kernel"] == pytest.approx(0.020)


def test_breakdown():
    tr = Trace.from_events(synthetic(), n_ticks=1)
    ops = tr.device_ops(top=2)
    assert [o[0][:16] for o in ops] == ["void step_whole_", "ncclDevKernel_Al"]
    assert ops[0][1] == pytest.approx(40e-6)
    gaps = dict(tr.idle_gaps())
    # 0-10 (host in forecast at 0? no: tick), 25-30 (controller), 80-100 (fetch)
    assert gaps == pytest.approx({"tick": 10e-6, "controller": 5e-6, "fetch": 20e-6})
