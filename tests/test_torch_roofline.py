"""PyTorch port vs JAX: the roofline accounting (`utils/roofline.py`).

The port's counts are the JAX package's for the same flags (its (s, d, B)
layout has the JAX layout's memory order and no padding): `step_cost` and
`ipm_bytes` equal JAX's exactly for every combination of their flags, at 1
and 3 QP iterations. `test_roofline.py`'s four relations hold on the port's
copy, the deployed configuration counts 14,024 B and 582,304 FLOP a solve,
and the report names the H100's peaks.
"""

import itertools

import pytest

from ndp_nmpc_qd_tpu.utils import roofline as jax_roofline
from ndp_nmpc_qd_tpu_torch.utils.roofline import (
    F32_FLOPS_PER_S, HBM_BYTES_PER_S, PEAKS, ipm_bytes, roofline_report, step_cost,
)

FLAGS = ("jac_bf16", "whole_kernel", "lqr_start", "packed_state", "whole_step")


@pytest.mark.parametrize("qp_iters", [1, 3])
def test_counts_equal_jax_for_every_flag_combination(qp_iters):
    for values in itertools.product((False, True), repeat=len(FLAGS)):
        kw = dict(zip(FLAGS, values), N=20, qp_iters=qp_iters)
        assert step_cost(**kw) == jax_roofline.step_cost(**kw), kw
    for whole, lqr, jb in itertools.product((False, True), (False, True), (2, 4)):
        kw = dict(N=20, qp_iters=qp_iters, jac_bytes=jb, whole_kernel=whole, lqr_start=lqr)
        assert ipm_bytes(**kw) == jax_roofline.ipm_bytes(**kw), kw


def test_whole_kernel_cuts_ipm_traffic():
    per_iter = ipm_bytes(N=20, qp_iters=6, whole_kernel=False)
    whole = ipm_bytes(N=20, qp_iters=6, whole_kernel=True)
    assert whole["ipm"] < per_iter["ipm"] / 2.5
    p12 = ipm_bytes(N=20, qp_iters=12, whole_kernel=False)
    assert abs(p12["ipm"] - 2 * per_iter["ipm"]) < 1e-6
    assert ipm_bytes(N=20, qp_iters=12, whole_kernel=True)["ipm"] == whole["ipm"]


def test_bf16_cuts_payload():
    f32 = step_cost(N=20, qp_iters=6, jac_bf16=False, whole_kernel=True)
    b16 = step_cost(N=20, qp_iters=6, jac_bf16=True, whole_kernel=True)
    assert b16.hbm_bytes < 0.9 * f32.hbm_bytes


def test_lqr_start_adds_a_sweep():
    assert (step_cost(N=20, qp_iters=6, lqr_start=True).hbm_bytes
            > step_cost(N=20, qp_iters=6, lqr_start=False).hbm_bytes)


def test_report_names_the_h100_peaks():
    cost = step_cost()
    rep = roofline_report(cost, solves_per_s=2.0e6)
    assert rep["achieved_gb_s"] > 0
    assert 0 < rep["h100_hbm_pct"] < 1000
    assert set(rep["bytes_breakdown"]) == {"mlp", "pack", "linearize", "ipm", "rti_glue"}
    assert rep["peaks"] == PEAKS == {"h100_sxm_hbm_gb_s": 3350.0, "h100_sxm_f32_tflops": 67.0}
    assert HBM_BYTES_PER_S == 3.35e12 and F32_FLOPS_PER_S == 67e12
    assert not any("v5e" in k or "vpu" in k for k in rep)


def test_deployed_configuration():
    """N=20, warm@3, bf16 payloads, the one-kernel step with kernel-layout
    state: 14,024 B and 582,304 FLOP a solve; at 65536 solves in 10.99 ms
    that is ~84 GB/s, ~2.5% of the HBM peak."""
    cost = step_cost(N=20, qp_iters=3, jac_bf16=True, whole_kernel=True, packed_state=True,
                     whole_step=True)
    assert cost.hbm_bytes == 14024 and cost.flops == 582304
    rep = roofline_report(cost, 65536 / 10.99e-3)
    assert rep["achieved_gb_s"] == pytest.approx(83.63, abs=0.01)
    assert rep["h100_hbm_pct"] == pytest.approx(2.496, abs=1e-3)
    assert rep["h100_f32_pct_est"] < 100


def test_bench_roofline_row():
    """`bench_torch.py`'s roofline of the deployed row (its flags at their
    defaults): the deployed configuration's counts against the H100's peaks,
    no share over 100% at 5.9M solves/s, the deployed step's rate on an H100."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "bench_torch.py"
    spec = importlib.util.spec_from_file_location("bench_torch_roofline", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    roof = bench.roofline_row(bench.deployed_flags(), 5.9e6)
    assert roof["hbm_bytes_per_solve"] == 14024 and roof["flops_per_solve_est"] == 582304
    assert 0 < roof["h100_hbm_pct"] < 100 and 0 < roof["h100_f32_pct_est"] < 100
    assert roof["peaks"] == PEAKS
