"""Structure-sparse OCP data: the stage payload, its two linearizers, and
the one-kernel control step.

Port of `ndp_nmpc_qd_tpu/solver/ocp_sparse.py` (`SparseQp`, `SparseQpConsts`,
`a_dense_from_sparse`, `b_dense_from_sparse`, `make_linearizer_pallas`,
`make_ocp_functions_sparse`, `make_whole_step`). The payload's fields and
their structure are described in the JAX module's docstring.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import const
from ..ops import quat
from ..ops.kernels.linearize import linearize_stage_data
from ..ops.kernels.step_whole import control_step_whole
from ..ops.layout import pack
from ..params import OcpParams, VehicleParams
from .ocp import BIG, make_discrete_jacobians, make_ocp_functions


class SparseQp(NamedTuple):
    """Varying QP data in kernel layout (stage, element, B). hq, a and b are
    in the jac dtype (bf16 with `jac_bf16`); everything else in the compute
    dtype. The constant parts live in `SparseQpConsts`."""

    hq: torch.Tensor  # (N+1, 16) 4x4 quaternion Hessian block, row-major
    gx: torch.Tensor  # (N+1, 10)
    gu: torch.Tensor  # (N, 4)
    a: torch.Tensor  # (N, 40) [Apq(12), Avq(12), Aqq(16)] row-major blocks
    b: torch.Tensor  # (N, 30) omega columns [Bp(9), Bv(9), Bq(12)]
    bc: torch.Tensor  # (N, 6) collective columns [Bp[:,3], Bv[:,3]]
    r: torch.Tensor  # (N, 10) defects
    lu: torch.Tensor  # (N, 4) control box, relative to the iterate
    uu: torch.Tensor
    lx: torch.Tensor  # (N+1, 3) velocity box; rows 0 and N are -+BIG
    ux: torch.Tensor


class SparseQpConsts(NamedTuple):
    """Scalars the kernels take as constants (plain Python floats)."""

    h: float  # th_pred: the exact p <- v sensitivity
    diag6_stage: tuple  # stage_scale * q_diag[:6]
    diag6_term: tuple  # q_diag[:6] (terminal: cost scaling 1)
    rdiag_stage: tuple  # stage_scale * r_diag


def a_dense_from_sparse(a40: torch.Tensor, h: float) -> torch.Tensor:
    """(..., 40) sparse stage A -> (..., 10, 10) dense: [[I, h I, Apq],
    [0, I, Avq], [0, 0, Aqq]]."""
    batch, dt, dev = a40.shape[:-1], a40.dtype, a40.device
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(batch + (3, 3))
    z33 = a40.new_zeros(batch + (3, 3))
    z43 = a40.new_zeros(batch + (4, 3))
    top = torch.cat([eye3, h * eye3, a40[..., 0:12].reshape(batch + (3, 4))], dim=-1)
    mid = torch.cat([z33, eye3, a40[..., 12:24].reshape(batch + (3, 4))], dim=-1)
    bot = torch.cat([z43, z43, a40[..., 24:40].reshape(batch + (4, 4))], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def b_dense_from_sparse(b30: torch.Tensor, bc6: torch.Tensor) -> torch.Tensor:
    """(..., 30) omega columns + (..., 6) collective columns -> (..., 10, 4)
    dense, in bc6's dtype."""
    batch = b30.shape[:-1]
    b30 = b30.to(bc6.dtype)
    bp = torch.cat([b30[..., 0:9].reshape(batch + (3, 3)), bc6[..., 0:3, None]], dim=-1)
    bv = torch.cat([b30[..., 9:18].reshape(batch + (3, 3)), bc6[..., 3:6, None]], dim=-1)
    bq = torch.cat([b30[..., 18:30].reshape(batch + (4, 3)), bc6.new_zeros(batch + (4, 1))],
                   dim=-1)
    return torch.cat([bp, bv, bq], dim=-2)


def _floats(v):
    return tuple(float(t) for t in np.asarray(v))


def sparse_consts(ocp: OcpParams) -> SparseQpConsts:
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    q_diag = np.asarray(ocp.q_diag())
    return SparseQpConsts(
        h=float(ocp.th_pred),
        diag6_stage=tuple(float(v) * stage_scale for v in q_diag[:6]),
        diag6_term=_floats(q_diag[:6]),
        rdiag_stage=tuple(float(v) * stage_scale for v in np.asarray(ocp.r_diag())),
    )


def lin_consts(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False,
) -> dict:
    """Keyword constants of `linearize_stage_data`."""
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    return dict(
        h=float(ocp.th_pred), substeps=int(ocp.erk_substeps),
        mass=float(vehicle.mass), gravity=float(vehicle.gravity),
        stage_scale=float(stage_scale),
        q_diag=_floats(ocp.q_diag()), r_diag=_floats(ocp.r_diag()),
        u_lo=_floats(ocp.u_lower()), u_hi=_floats(ocp.u_upper()),
        v_lo=_floats(ocp.v_lower()), v_hi=_floats(ocp.v_upper()),
        with_dist=bool(with_disturbance), big=float(BIG), jac_bf16=bool(jac_bf16),
    )


def ipm_consts(
    ocp: OcpParams, *, num_iters: int = 4,
    tau: float = 0.95, sigma: float = 0.1, mu_init: float = 1.0,
    s_min: float = 1e-3, mu_min: float = 1e-12,
) -> dict:
    """Keyword constants of `riccati_ipm_whole` (IPM knob defaults as the
    JAX package's `qp_ipm_sparse.ipm_sparse`); `riccati_iter_fused` takes
    the SparseQpConsts fields and `tau` of it."""
    return dict(
        sparse_consts(ocp)._asdict(),
        tau=tau, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
        num_iters=int(num_iters),
    )


def whole_step_consts(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4, **ipm_knobs,
) -> dict:
    """Keyword constants of `control_step_whole`: those of the
    linearization and of the whole IPM."""
    return dict(
        lin_consts(ocp, vehicle, with_disturbance, jac_bf16=jac_bf16),
        **ipm_consts(ocp, num_iters=num_iters, **ipm_knobs),
    )


def make_linearizer(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False,
):
    """The stage linearization on the K3 kernel: the counterpart of the JAX
    package's `make_linearizer_pallas`.

    Returns (linearize_sparse, consts). linearize_sparse(x_bar, u_bar, xr,
    ur, f_dist, x0, packed_xu=False) -> (SparseQp, dx0_p (1, 10, B)) takes
    batch-first inputs x_bar (B, N+1, 10), u_bar (B, N, 4), xr, ur,
    f_dist (B, N+1, 3) or None, x0 (B, 10); with `packed_xu=True` x_bar and
    u_bar arrive already in kernel layout ((N+1, 10, B), (N, 4, B)).
    `jac_bf16` stores hq/a/b in bfloat16; bc, gx, gu and r stay full
    precision (the JAX module docstring says why)."""
    kconsts = lin_consts(ocp, vehicle, with_disturbance, jac_bf16=jac_bf16)
    N = ocp.N_node

    def linearize_sparse(x_bar, u_bar, xr, ur, f_dist, x0, packed_xu=False):
        dt = x_bar.dtype
        if not packed_xu:
            x_bar, u_bar = pack(x_bar), pack(u_bar.to(dt))
        fd = None
        if with_disturbance:
            B = x0.shape[0]
            fd = (torch.zeros((N + 1, 3, B), dtype=dt, device=x_bar.device)
                  if f_dist is None else pack(f_dist.to(dt)))
        *fields, dx0_p = linearize_stage_data(
            x_bar, u_bar, pack(xr.to(dt)), pack(ur.to(dt)), fd,
            pack(x0.to(dt)[:, None]), **kconsts,
        )
        return SparseQp(*fields), dx0_p

    return linearize_sparse, sparse_consts(ocp)


def _hq_gxq(q_ref, qe, wq):
    """Closed-form Hq = Gq^T diag(wq) Gq (..., 16) and Gq^T (wq * qe) (..., 4)
    as 3-term sums of elementwise products (the JAX `_hq_gxq`); q_ref (...,
    4), qe (..., 3), wq three floats. Gq's columns: `_gq`
    (`nmpc_body_rate_ctl.py:164-166`)."""
    qw, qx, qy, qz = q_ref.unbind(-1)
    cols = ((-qx, -qy, -qz), (qw, qz, -qy), (-qz, qw, qx), (qy, -qx, qw))
    w1, w2, w3 = wq
    hq = torch.stack([
        w1 * cols[i][0] * cols[j][0] + w2 * cols[i][1] * cols[j][1]
        + w3 * cols[i][2] * cols[j][2]
        for i in range(4) for j in range(4)
    ], dim=-1)
    v0, v1, v2 = w1 * qe[..., 0], w2 * qe[..., 1], w3 * qe[..., 2]
    gxq = torch.stack([cols[i][0] * v0 + cols[i][1] * v1 + cols[i][2] * v2 for i in range(4)],
                      dim=-1)
    return hq, gxq


def make_ocp_functions_sparse(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False,
):
    """The stage linearization in tensor ops, the JAX package's independent
    formulation of what K3 computes (`fused_lin=False`).

    Returns (linearize_sparse, consts, phi) with `make_linearizer`'s
    contract: linearize_sparse(x_bar, u_bar, xr, ur, f_dist, x0) ->
    (SparseQp, dx0_p (1, 10, B)) takes batch-first inputs (any B) and
    returns the payload in kernel layout. Every stage of every scenario is
    one batch element of the same ops: the RK4 step carries the 4 + 4
    tangent columns of the quaternion and the controls
    (`ocp.rk4_with_tangents`), and the quaternion Hessian block and gradient
    are the closed-form 3-term sums (`_hq_gxq`). `jac_bf16` stores hq, a and
    b in bfloat16; bc, gx, gu and r stay full precision (the JAX docstring
    says why)."""
    N = ocp.N_node
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    phi_jac = make_discrete_jacobians(ocp, vehicle, with_disturbance, x_cols=slice(6, 10))
    phi = make_ocp_functions(ocp, vehicle, with_disturbance)[1]
    q_diag = _floats(ocp.q_diag())
    r_diag = _floats(ocp.r_diag())
    wq = q_diag[7:10]
    boxes = tuple(_floats(v) for v in (ocp.u_lower(), ocp.u_upper(), ocp.v_lower(),
                                       ocp.v_upper()))

    def linearize_sparse(x_bar, u_bar, xr, ur, f_dist, x0):
        dt, dev = x_bar.dtype, x_bar.device
        B = x_bar.shape[0]
        u_bar, xr, ur, x0 = (t.to(dt) for t in (u_bar, xr, ur, x0))
        if f_dist is None:
            f_dist = torch.zeros((B, N + 1, 3), dtype=dt, device=dev)
        c = lambda v: const(v, dt, dev)

        # cost terms at every node; the terminal's is unscaled
        q_ref = xr[..., 6:10]
        hq, gxq = _hq_gxq(q_ref, quat.error_vector(x_bar[..., 6:10], q_ref), wq)
        q6, e6 = c(q_diag[:6]), x_bar[..., 0:6] - xr[..., 0:6]
        hq = torch.cat([stage_scale * hq[:, :N], hq[:, N:]], dim=1)
        gx = torch.cat([
            torch.cat([stage_scale * q6 * e6[:, :N], stage_scale * gxq[:, :N]], dim=-1),
            torch.cat([q6 * e6[:, N:], gxq[:, N:]], dim=-1),
        ], dim=1)
        gu = stage_scale * c(r_diag) * (u_bar - ur)

        # the quaternion columns of dPhi/dx (the others are constants) and dPhi/du
        x_next, Aq, Bm = phi_jac(x_bar[:, :N], u_bar, f_dist[:, :N])
        a40 = Aq.reshape(B, N, 40)  # [Apq, Avq, Aqq] row-major
        b30 = Bm[..., 0:3].reshape(B, N, 30)  # [Bp, Bv, Bq] omega columns
        bc6 = Bm[..., 0:6, 3]

        u_lo, u_hi, v_lo, v_hi = (c(v) for v in boxes)
        inner = torch.zeros((N + 1, 1), dtype=torch.bool, device=dev)
        inner[1:N] = True
        big = torch.full((), BIG, dtype=dt, device=dev)
        vbar = x_bar[..., 3:6]
        jd = torch.bfloat16 if jac_bf16 else dt
        qp = SparseQp(
            hq=pack(hq).to(jd), gx=pack(gx), gu=pack(gu), a=pack(a40).to(jd),
            b=pack(b30).to(jd), bc=pack(bc6), r=pack(x_next - x_bar[:, 1:]),
            lu=pack(u_lo - u_bar), uu=pack(u_hi - u_bar),
            lx=pack(torch.where(inner, v_lo - vbar, -big)),
            ux=pack(torch.where(inner, v_hi - vbar, big)),
        )
        return qp, pack((x0 - x_bar[:, 0])[:, None])

    return linearize_sparse, sparse_consts(ocp), phi


def make_whole_step(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4,
):
    """The one-kernel control step: linearization + whole IPM + SQP axpy.

    Returns step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm: IpmWarm) -> eq_res
    (B,), with every tensor in kernel layout. The
    iterates and `warm` update in place (the JAX version returns them)."""
    consts = whole_step_consts(
        ocp, vehicle, with_disturbance, jac_bf16=jac_bf16, num_iters=num_iters,
    )

    def step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm):
        return control_step_whole(
            xb, ub, xr_p, ur_p, fd_p, x0_p,
            warm.lu_lo, warm.lu_up, warm.lx_lo, warm.lx_up, warm.mu, **consts,
        )

    return step
