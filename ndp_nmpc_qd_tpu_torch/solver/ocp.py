"""OCP definition: residuals, Gauss-Newton cost terms, horizon linearization.

Port of `ndp_nmpc_qd_tpu/solver/ocp.py`: the acados NONLINEAR_LS optimal
control problem of `nmpc_ctl/nmpc_body_rate_ctl.py:36-80` (and its NDP
variant with a per-stage disturbance force,
`ndp_nmpc_ctl/ndp_nmpc_body_rate_ctl.py:151-162`):

  min  sum_{i=0}^{N-1} s_i/2 ||y(x_i,u_i,p_i) - yref_i||_W^2
         + 1/2 ||y_e(x_N,p_N) - yref_N||_Q^2
  s.t. x_{i+1} = Phi_ERK(x_i, u_i, f_i),   x_0 fixed,
       lbu <= u_i <= ubu                  (i = 0..N-1)
       lbv <= v_i <= ubv                  (i = 1..N-1, velocity components)

with y = [pos, vel, qwr, qe+qr_vec, u], W = blkdiag(Q, R) and the acados
cost scaling s_i = T/N for the intermediate stages, 1 for the terminal.

The JAX package vmaps the per-stage terms over the stages and the scenario
batch; here both are batch dimensions written out. The Jacobians are the
port's own forward-mode tangents: the RK4 step carries its 14 tangent
columns through the closed-form Jacobian of the dynamics
(`rk4_with_tangents`, what `jax.jacfwd`
of the step computes, in a few batched products instead of one pass per
column; `ops.kernels.linearize.rk4_jvp` on element tuples computes the
same tangents in more, smaller ops, which made the scan mission's tick
slower on the card, `PERF.md`), and the residual's Jacobian is its closed
form (the identity on position, velocity and control, the quaternion-error
block Gq, `gn_state_terms`). The stage Gauss-Newton Hessian J^T W J is a
full-f32 matmul
(`torch.backends.cuda.matmul.allow_tf32` stays False, PyTorch's default:
TF32 would keep three decimal digits through a 20-stage recursion).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import const
from ..models.quadrotor import NU, NX, body_rate_dynamics
from ..ops import quat
from ..ops.integrators import make_discrete_dynamics
from ..params import OcpParams, VehicleParams

NY = NX + NU  # stage residual dim (14)


class QpData(NamedTuple):
    """Stage-wise QP data, batch-first (B, stage, ...), or per scenario
    without the leading B."""

    Hxx: torch.Tensor  # (N+1, nx, nx)
    Hxu: torch.Tensor  # (N, nx, nu)
    Huu: torch.Tensor  # (N, nu, nu)
    gx: torch.Tensor  # (N+1, nx)
    gu: torch.Tensor  # (N, nu)
    A: torch.Tensor  # (N, nx, nx)
    B: torch.Tensor  # (N, nx, nu)
    r: torch.Tensor  # (N, nx) linearization defect Phi(xb,ub) - xb_next
    lu: torch.Tensor  # (N, nu) lower bound on du
    uu: torch.Tensor  # (N, nu) upper bound on du
    lx: torch.Tensor  # (N+1, n_bx) lower bound on bounded dx components
    ux: torch.Tensor  # (N+1, n_bx) upper bound on bounded dx components


# Indices of state components with box bounds (vx, vy, vz):
# `nmpc_body_rate_ctl.py:59-61` (idxbx = [3, 4, 5]), a contiguous slice.
BX_IDX = (3, 4, 5)
BX = slice(3, 6)
N_BX = 3
BIG = 1e9  # stands in for +-inf on masked bounds (the state box at nodes 0 and N)


def stage_output(x: torch.Tensor, u: torch.Tensor, q_ref: torch.Tensor) -> torch.Tensor:
    """acados cost_y_expr: [pos, vel, qwr, qe+qr_vec, u] (..., 14)
    (`nmpc_body_rate_ctl.py:168-181`)."""
    return torch.cat([terminal_output(x, q_ref), u], dim=-1)


def terminal_output(x: torch.Tensor, q_ref: torch.Tensor) -> torch.Tensor:
    """acados cost_y_expr_e: the state part only (..., nx). States past the
    quaternion (the motor-thrust model's body rates, `ocp_thrust.py`) are
    tracked as they are."""
    qe = quat.error_vector(x[..., 6:10], q_ref)
    return torch.cat([x[..., 0:6], q_ref[..., 0:1], qe + q_ref[..., 1:4], x[..., 10:]], dim=-1)


def _f_jacobian(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """d xdot / d (x, u) of `body_rate_dynamics` (..., 10, 14); the
    disturbance force is a constant input."""
    qw, qx, qy, qz = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz, cc = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    J = x.new_zeros(x.shape[:-1] + (NX, NX + NU))
    J[..., 0:3, 3:6] = torch.eye(3, dtype=x.dtype, device=x.device)
    two_c = 2.0 * cc
    # acceleration: c * [2(qx qz + qw qy), 2(qy qz - qw qx), 1 - 2qx^2 - 2qy^2]
    J[..., 3:6, 6:10] = torch.stack([
        torch.stack([two_c * qy, two_c * qz, two_c * qw, two_c * qx], dim=-1),
        torch.stack([-two_c * qx, -two_c * qw, two_c * qz, two_c * qy], dim=-1),
        torch.stack([torch.zeros_like(qw), -2.0 * two_c * qx, -2.0 * two_c * qy,
                     torch.zeros_like(qw)], dim=-1),
    ], dim=-2)
    J[..., 3:6, 13] = torch.stack([
        2.0 * (qx * qz + qw * qy), 2.0 * (qy * qz - qw * qx), 1.0 - 2.0 * qx * qx - 2.0 * qy * qy,
    ], dim=-1)
    # quaternion: 0.5 * Omega(w) q
    z = torch.zeros_like(wx)
    J[..., 6:10, 6:10] = 0.5 * torch.stack([
        torch.stack([z, -wx, -wy, -wz], dim=-1), torch.stack([wx, z, wz, -wy], dim=-1),
        torch.stack([wy, -wz, z, wx], dim=-1), torch.stack([wz, wy, -wx, z], dim=-1),
    ], dim=-2)
    J[..., 6:10, 10:13] = 0.5 * torch.stack([
        torch.stack([-qx, -qy, -qz], dim=-1), torch.stack([qw, -qz, qy], dim=-1),
        torch.stack([qz, qw, -qx], dim=-1), torch.stack([-qy, qx, qw], dim=-1),
    ], dim=-2)
    return J


def rk4_with_tangents(f, f_jac, x, u, fd, dt: float, substeps: int, x_cols=slice(None)):
    """The RK4 step of `ops.integrators.rk4_step` (the same arithmetic for
    Phi) with forward-mode tangents carried along, as `jax.jacfwd` of the
    step computes them: returns (Phi(x, u, fd), dPhi/dx[..., x_cols]
    (..., nx, ncols), dPhi/du (..., nx, nu)). f(x, u, fd) is the continuous
    dynamics and f_jac(x, u) its Jacobian d xdot / d (x, u) (..., nx,
    nx + nu); fd is a constant input. `x_cols` (a slice) picks the state
    columns whose tangents are carried: the structure-sparse linearizer
    carries only the 4 quaternion columns."""
    nx, nu = x.shape[-1], u.shape[-1]
    nc = len(range(nx)[x_cols])
    h = dt / substeps

    def f_tan(x, T):
        """(xdot, d xdot along the tangents T (..., nx, nc + nu))."""
        J = f_jac(x, u)
        dT = J[..., :nx] @ T
        dT[..., nc:] += J[..., nx:]
        return f(x, u, fd), dT

    T = x.new_zeros(x.shape + (nc + nu,))
    T[..., x_cols, :nc] = torch.eye(nc, dtype=x.dtype, device=x.device)
    for _ in range(substeps):
        k1, t1 = f_tan(x, T)
        k2, t2 = f_tan(x + 0.5 * h * k1, T + 0.5 * h * t1)
        k3, t3 = f_tan(x + 0.5 * h * k2, T + 0.5 * h * t2)
        k4, t4 = f_tan(x + h * k3, T + h * t3)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        T = T + (h / 6.0) * (t1 + 2.0 * t2 + 2.0 * t3 + t4)
    return x, T[..., :nc], T[..., nc:]


def make_discrete_jacobians(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool, x_cols=slice(None),
):
    """phi_jac(x, u, fd) -> (Phi(x, u, fd), A (..., 10, ncols), B (..., 10,
    4)) of the body-rate model (`rk4_with_tangents`): A holds the columns
    `x_cols` of dPhi/dx, all 10 by default. x (..., 10), u (..., 4), fd
    (..., 3)."""

    def f(x, u, fd):
        return body_rate_dynamics(
            x, u, fd if with_disturbance else None, mass=vehicle.mass, gravity=vehicle.gravity,
        )

    def phi_jac(x, u, fd):
        return rk4_with_tangents(f, _f_jacobian, x, u, fd, ocp.th_pred, ocp.erk_substeps,
                                 x_cols)

    return phi_jac


def gn_state_terms(x: torch.Tensor, xr: torch.Tensor, q_diag: torch.Tensor, stage_scale: float):
    """Gauss-Newton Hessian s J^T Q J (..., N+1, nx, nx) and gradient
    s J^T Q e (..., N+1, nx) of the state residual e = y_e(x) - xr at every
    node of the horizon x (..., N+1, nx), with the acados cost scaling s:
    stage_scale for the stages, 1 for the terminal. J is the residual's
    closed-form Jacobian: the identity on position, velocity and any state
    past the quaternion, a zero row for qwr and the 3x4 quaternion-error
    block Gq (`nmpc_body_rate_ctl.py:164-166`; qe is linear in q), i.e. the
    JAX package's `jax.jacfwd` of the residual and `ocp_packed._gq`."""
    nx = x.shape[-1]
    qwr, qxr, qyr, qzr = xr[..., 6:10].unbind(-1)
    J = xr.new_zeros(xr.shape[:-1] + (nx, nx))
    J[..., 0:6, 0:6] = torch.eye(6, dtype=xr.dtype, device=xr.device)
    J[..., 10:, 10:] = torch.eye(nx - 10, dtype=xr.dtype, device=xr.device)
    J[..., 7:10, 6:10] = torch.stack([
        torch.stack([-qxr, qwr, -qzr, qyr], dim=-1),
        torch.stack([-qyr, qzr, qwr, -qxr], dim=-1),
        torch.stack([-qzr, -qyr, qxr, qwr], dim=-1),
    ], dim=-2)
    Jt = J.transpose(-1, -2)
    e = terminal_output(x, xr[..., 6:10]) - xr
    scale = torch.full((x.shape[-2], 1), stage_scale, dtype=x.dtype, device=x.device)
    scale[-1] = 1.0
    return (scale[..., None] * (Jt @ (q_diag[:, None] * J)),
            scale * (Jt @ (q_diag * e)[..., None])[..., 0])


def make_ocp_functions(ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool):
    """Build the horizon linearization of this OCP.

    Returns (linearize_horizon, phi): linearize_horizon(x_bar, u_bar, xr, ur,
    f_dist=None) -> QpData takes x_bar (B, N+1, 10), u_bar (B, N, 4), xr,
    ur and f_dist (B, N+1, 3) or None, batch-first, or the same without the
    leading B (one scenario, as the JAX function). Every output takes
    x_bar's dtype."""
    dt = ocp.th_pred

    def f(x, u, fd):
        return body_rate_dynamics(
            x, u, fd if with_disturbance else None, mass=vehicle.mass, gravity=vehicle.gravity,
        )

    phi = make_discrete_dynamics(f, dt, ocp.erk_substeps)
    phi_jac = make_discrete_jacobians(ocp, vehicle, with_disturbance)
    stage_scale = dt if ocp.scale_stage_cost_by_dt else 1.0
    floats = lambda v: tuple(float(t) for t in v)
    q_diag_v, r_diag_v = floats(ocp.q_diag()), floats(ocp.r_diag())

    def linearize_horizon(x_bar, u_bar, xr, ur, f_dist=None) -> QpData:
        if x_bar.dim() == 2:  # one scenario
            one = lambda t: None if t is None else t[None]
            qp = linearize_horizon(one(x_bar), one(u_bar), one(xr), one(ur), one(f_dist))
            return QpData(*(t[0] for t in qp))
        N = ocp.N_node
        dtype, dev = x_bar.dtype, x_bar.device
        Bsz = x_bar.shape[0]
        if f_dist is None:
            f_dist = torch.zeros((Bsz, N + 1, 3), dtype=dtype, device=dev)
        u_bar, xr, ur, f_dist = (t.to(dtype) for t in (u_bar, xr, ur, f_dist))
        c = lambda v: const(v, dtype, dev)
        q_diag, r_diag = c(q_diag_v), c(r_diag_v)

        # the control block of W is diagonal and its Jacobian the identity,
        # and no residual couples x and u
        Hxx, gx = gn_state_terms(x_bar, xr, q_diag, stage_scale)
        Huu = torch.diag_embed(stage_scale * r_diag).expand(Bsz, N, NU, NU)
        gu = stage_scale * (r_diag * (u_bar - ur))
        Hxu = torch.zeros((Bsz, N, NX, NU), dtype=dtype, device=dev)

        x_next, A, Bm = phi_jac(x_bar[:, :N], u_bar, f_dist[:, :N])
        r = x_next - x_bar[:, 1:]  # multiple-shooting defect

        # bounds on the deltas; the state box applies to nodes 1..N-1 only
        lu = c(floats(ocp.u_lower())) - u_bar
        uu = c(floats(ocp.u_upper())) - u_bar
        vbar = x_bar[..., BX]
        inner = torch.zeros((N + 1, 1), dtype=torch.bool, device=dev)
        inner[1:N] = True
        big = torch.full((), BIG, dtype=dtype, device=dev)
        lx = torch.where(inner, c(floats(ocp.v_lower())) - vbar, -big)
        ux = torch.where(inner, c(floats(ocp.v_upper())) - vbar, big)
        return QpData(Hxx, Hxu, Huu, gx, gu, A, Bm, r, lu, uu, lx, ux)

    return linearize_horizon, phi
