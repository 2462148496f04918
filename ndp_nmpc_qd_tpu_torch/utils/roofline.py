"""Roofline accounting for the fused NDP-NMPC control step, on the H100.

Port of `ndp_nmpc_qd_tpu/utils/roofline.py`: the per-solve memory traffic
and operation count of the device step, computed analytically from the
payload and state layouts, so that the bench reports achieved GB/s and the
share of the card's peak next to solves/s. The port's kernel layout (s, d,
B) has the JAX layout's memory order and no padding, so each count equals
the JAX one for the same flags; the JAX module's docstring gives the
counting rules (useful traffic per solve; each kernel launch counts the
inputs it maps; layout copies, the `pack` term, count a read and a write).
Real traffic is at least this count, so a share computed from it is a
lower bound.

Peaks (PEAKS): one H100 SXM from NVIDIA's data sheet, 3.35 TB/s of HBM3
and 67 TFLOP/s in float32 outside the tensor cores, at the full 700 W power
limit. The IPM's stage algebra runs on the CUDA cores in f32; the
operation count is an estimate (the JAX module's per-stage counts), a
diagnostic rather than a claim.
"""

from __future__ import annotations

from typing import NamedTuple

NX = 10
NU = 4

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores
PEAKS = {
    "h100_sxm_hbm_gb_s": HBM_BYTES_PER_S / 1e9,
    "h100_sxm_f32_tflops": F32_FLOPS_PER_S / 1e12,
}


class StepCost(NamedTuple):
    hbm_bytes: float  # per scenario per control step
    flops: float  # per scenario per control step (FMA = 2)
    breakdown: dict  # bytes by component


def _payload_floats(N: int):
    """(jac_dtype floats, f32 floats) of the SparseQp payload + bounds + dx0.

    jac part: hq (N+1,16), a (N,40), b (N,30) — stored in `jac_dtype`
    (f32 default, bf16 in the validated split-precision mode where the six
    collective-thrust columns `bc` stay f32, `ocp_sparse.py` docstring).
    """
    jac = 16 * (N + 1) + 40 * N + 30 * N
    f32 = (
        10 * (N + 1)  # gx
        + 4 * N  # gu
        + 6 * N  # bc
        + 10 * N  # r
        + 2 * 4 * N  # lu, uu
        + 2 * 3 * (N + 1)  # lx, ux
        + 10  # dx0
    )
    return jac, f32


def _state_floats(N: int):
    """Primal iterate + slack + dual floats (all f32)."""
    zxzu = 10 * (N + 1) + 4 * N
    slacks = 2 * 4 * N + 2 * 3 * (N + 1)
    duals = slacks
    return zxzu, slacks, duals


def ipm_bytes(
    N: int = 20,
    qp_iters: int = 6,
    jac_bytes: int = 4,
    whole_kernel: bool = False,
    lqr_start: bool = False,
) -> dict:
    """HBM bytes per scenario for ONE QP solve (the IPM part of the step)."""
    jac_f, f32_f = _payload_floats(N)
    payload = jac_bytes * jac_f + 4 * f32_f
    zxzu, slacks, duals = _state_floats(N)
    bounds = 4 * (2 * 4 * N + 2 * 3 * (N + 1))

    if whole_kernel:
        # K2 (csrc/ipm_whole.cu): payload + carried duals in once, solution
        # + duals out once; slacks/directions live in shared memory only.
        rd = payload + 4 * (duals + 1)
        wr = 4 * (zxzu + duals + 2)
        return {
            "ipm_read": rd, "ipm_write": wr,
            "ipm": rd + wr, "ipm_iters_counted": qp_iters,
        }

    # per-iteration path: K4 + K5 (backward + forward kernel), then the
    # torch axpy glue over state and directions
    K = 4 * (NU * NX * N + NU * N)  # gains
    rhat = 4 * 10 * N
    dirs = 4 * (zxzu + 2 * slacks + 2 * duals)  # dzx,dzu + ds,dl both sides
    bwd_rd = (
        payload - 4 * 10  # dx0 not read by backward
        + 4 * (10 * (N + 1) * 2)  # zx windows at s and s+1
        + 4 * (4 * N)  # zu
        + 4 * (slacks + duals)
    )
    bwd_wr = K + rhat + 4 * (2 * N)  # + res2 partials
    fwd_rd = (
        jac_bytes * (70 * N)  # a, b re-read
        + 4 * (6 * N)  # bc re-read
        + rhat + K
        + 4 * (4 * N + 10 * (N + 1))  # zu, zx
        + 4 * (slacks + duals + 1 + 10)
        + bounds
    )
    fwd_wr = dirs + 4 * (2 * N + 4 * N)  # + ap/ad/comp partials
    glue = 4 * (zxzu + slacks + duals) * 2 + dirs  # state r/w + dirs read
    per_iter = bwd_rd + bwd_wr + fwd_rd + fwd_wr + glue
    total = qp_iters * per_iter
    if lqr_start:
        # one extra backward+forward sweep (K6 + K7) for the clipped-LQR
        # start, payload re-read again
        total += bwd_rd + bwd_wr + (fwd_rd - bounds) + 4 * zxzu
    return {
        "ipm_per_iter": per_iter, "ipm": total,
        "ipm_iters_counted": qp_iters,
    }


def step_cost(
    N: int = 20,
    qp_iters: int = 6,
    jac_bf16: bool = False,
    whole_kernel: bool = False,
    lqr_start: bool = False,
    packed_state: bool = False,
    whole_step: bool = False,
) -> StepCost:
    """Full fused control step: MLP forecast + linearize + IPM + RTI glue.

    `packed_state` is the kernel-layout-resident RtiState mode
    (`solver/rti.py`): iterates and carried duals stay in kernel layout
    across ticks, so their pack transposes and the batch-first axpy/unpack
    disappear; the whole-IPM kernel additionally reads x_bar/u_bar and
    emits the UPDATED iterates in place of the solution delta (same write
    bytes, one extra iterate read, zero delta round trip).
    """
    jac_bytes = 2 if jac_bf16 else 4
    jac_f, f32_f = _payload_floats(N)
    payload = jac_bytes * jac_f + 4 * f32_f
    zxzu, _, duals = _state_floats(N)

    # downwash MLP forecast: reads other (N+1,10) + xr (N+1,10) + gate,
    # writes f_dist (N+1,3); weights amortized
    mlp = 4 * (2 * 10 * (N + 1) + 3 + 3 * (N + 1)) * 2  # + activations est.

    # linearize kernel: packed x_bar/u_bar/xr/ur/f_dist/x0 in, payload out
    lin_in = 4 * (2 * 10 * (N + 1) + 2 * 4 * N + 3 * (N + 1) + 10)
    lin = lin_in + payload

    if whole_step:
        # the one-kernel control step (K1, `csrc/step_whole.cu`): the QP
        # payload lives only in shared memory. HBM traffic = iterates +
        # per-tick inputs + carried duals in; updated iterates + duals +
        # health out. Implies packed_state (kernel-layout-resident state).
        zxzu_, slacks_, duals_ = _state_floats(N)
        pack = 2 * (lin_in - 4 * zxzu_)  # per-tick refs/x0/f_dist only
        rd = lin_in + 4 * (duals_ + 1)
        wr = 4 * (zxzu_ + duals_ + 2)
        rti = 4 * zxzu_  # health checks read packed iterates
        breakdown = {
            "mlp": 4 * (2 * 10 * (N + 1) + 3 + 3 * (N + 1)) * 2,
            "pack": pack, "fused_step": rd + wr, "rti_glue": rti,
        }
        total = sum(breakdown.values())
        per_iter_flops = 2 * (2900 + 300) * N
        flops = (
            qp_iters * per_iter_flops + 2 * 2500 * N + 2 * 2 * 64 * 128 * 3
        )
        return StepCost(
            hbm_bytes=float(total), flops=float(flops), breakdown=breakdown
        )

    if packed_state:
        # pack copies only for the per-tick inputs (xr/ur/f_dist/x0);
        # x_bar/u_bar arrive in kernel layout (no transpose)
        pack = 2 * (lin_in - 4 * zxzu)
        # axpy folded in-kernel (whole path): + iterate read inside the
        # kernel; remaining glue = health checks reading packed iterates +
        # the tiny u0/ok unpacks. The per-iteration path still pays the
        # torch axpy (in kernel layout, no unpack).
        extra_ipm_rd = 4 * zxzu
        rti = 4 * zxzu if whole_kernel else 4 * (3 * zxzu + zxzu)
        # the carried-dual pack/unpack of the batch-first warm path is not
        # counted on either side, so no term changes here
    else:
        # pack layout copies for the 6 linearizer inputs (read+write)
        pack = 2 * lin_in
        extra_ipm_rd = 0
        # RTI glue: unpack dx/du (read+write), axpy onto x_bar/u_bar
        # (read both + dx/du + write both), health checks read u_bar/x_bar
        rti = 4 * (2 * zxzu + 3 * zxzu + zxzu)

    ipm = ipm_bytes(
        N, qp_iters=qp_iters, jac_bytes=jac_bytes,
        whole_kernel=whole_kernel, lqr_start=lqr_start,
    )

    breakdown = {
        "mlp": mlp, "pack": pack, "linearize": lin,
        "ipm": ipm["ipm"] + extra_ipm_rd,
        "rti_glue": rti,
    }
    total = sum(breakdown.values())

    # FLOPs (diagnostic): backward stage core ~2.9k FMA/stage (PA/PB/Qh/S/Rh
    # contractions + 4x4 Cholesky, the JAX module's count), forward
    # ~0.2k, glue ~0.1k; linearize ~8 RK4 tangent columns ~2.5k FMA/stage.
    per_iter_flops = 2 * (2900 + 300) * N
    flops = qp_iters * per_iter_flops + 2 * 2500 * N + 2 * 2 * 64 * 128 * 3
    if lqr_start and not whole_kernel:
        flops += per_iter_flops
    return StepCost(hbm_bytes=float(total), flops=float(flops),
                    breakdown=breakdown)


def roofline_report(cost: StepCost, solves_per_s: float) -> dict:
    """Achieved bandwidth and operation rate of a step at `solves_per_s`,
    against the H100's peaks (PEAKS)."""
    gbps = cost.hbm_bytes * solves_per_s / 1e9
    tflops = cost.flops * solves_per_s / 1e12
    return {
        "hbm_bytes_per_solve": round(cost.hbm_bytes),
        "achieved_gb_s": round(gbps, 3),
        "h100_hbm_pct": round(100.0 * gbps / PEAKS["h100_sxm_hbm_gb_s"], 3),
        "flops_per_solve_est": round(cost.flops),
        "achieved_tflops_est": round(tflops, 4),
        "h100_f32_pct_est": round(100.0 * tflops / PEAKS["h100_sxm_f32_tflops"], 3),
        "peaks": dict(PEAKS),
        "bytes_breakdown": {k: round(v) for k, v in cost.breakdown.items()},
    }
