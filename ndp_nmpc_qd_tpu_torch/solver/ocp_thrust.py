"""Motor-thrust OCP: the controller the reference stubs but never built.

Port of `ndp_nmpc_qd_tpu/solver/ocp_thrust.py` (`nmpc_ctl/
nmpc_motor_thrust_ctl.py:11-13` in the reference is an empty placeholder): a
13-state full-attitude OCP whose inputs are the four rotor thrusts, with
per-rotor box bounds from the propeller model and the body-rate OCP's
nonlinear quaternion-error cost extended by body-rate tracking,

  min sum s/2 ||[p-pr, v-vr, qe, w-wr, u-ur]||^2_W + terminal
  s.t. x+ = ERK4(x, u),  f_min <= u_i <= f_max,  |v| <= v_max,

solved by the dense IPM of the scan controller (`qp_ipm.solve_qp`, which is
generic in nx), cold, as the JAX package solves it. No kernel runs here.

The JAX version takes its Jacobians with `jax.jacfwd`; here they are closed
form: A and B from the tangents carried through RK4
(`ocp.rk4_with_tangents` over `thrust_jacobian`), the Gauss-Newton
residual's J from `ocp.gn_state_terms` (the identity on p, v and omega, a
zero row for the qw slot, the quaternion-error block), the controls' from
the identity, and Hxu exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import const, resolve_device
from ..models.quadrotor_thrust import (
    NUT, NXT, rotor_thrust_bounds, thrust_dynamics, thrust_jacobian,
)
from ..ops.integrators import make_discrete_dynamics
from ..params import OcpParams, VehicleParams
from .ocp import BIG, BX, QpData, gn_state_terms, rk4_with_tangents
from .qp_ipm import solve_qp
from .rti import RtiController, RtiInfo, RtiState


class ThrustOcpWeights(NamedTuple):
    """Extra weights beyond OcpParams: body-rate tracking and rotor effort."""

    Qw: float = 5.0  # body-rate tracking
    Ru: float = 2.0  # per-rotor thrust deviation


def make_thrust_ocp_functions(
    ocp: OcpParams, veh: VehicleParams, tw: ThrustOcpWeights = ThrustOcpWeights()
):
    """Returns (linearize_horizon, phi): linearize_horizon(x_bar, u_bar, xr,
    ur, f_dist=None) -> QpData takes x_bar (B, N+1, 13), u_bar (B, N, 4),
    xr (B, N+1, 13), ur (B, N, 4) and f_dist (B, N+1, 3) or None,
    batch-first, or one scenario without the leading B, as the JAX
    function. Every output takes x_bar's dtype."""
    dt_h = ocp.th_pred
    stage_scale = dt_h if ocp.scale_stage_cost_by_dt else 1.0

    def f(x, u, fd):
        return thrust_dynamics(x, u, fd, veh=veh)

    def f_jac(x, u):
        return thrust_jacobian(x, u, veh)

    phi = make_discrete_dynamics(f, dt_h, ocp.erk_substeps)
    floats = lambda v: tuple(float(t) for t in v)
    # state residual weights: [p(3), v(3), qw slot, qe(3), w(3)]
    q_diag_v = floats(np.concatenate([np.asarray(ocp.q_diag()), np.full(3, tw.Qw)]))
    r_diag_v = (float(tw.Ru),) * NUT
    f_min, f_max = rotor_thrust_bounds(veh)
    v_lo_v, v_hi_v = floats(ocp.v_lower()), floats(ocp.v_upper())

    def linearize_horizon(x_bar, u_bar, xr, ur, f_dist=None) -> QpData:
        if x_bar.dim() == 2:  # one scenario
            one = lambda t: None if t is None else t[None]
            qp = linearize_horizon(one(x_bar), one(u_bar), one(xr), one(ur), one(f_dist))
            return QpData(*(t[0] for t in qp))
        N = ocp.N_node
        dtype, dev = x_bar.dtype, x_bar.device
        Bsz = x_bar.shape[0]
        u_bar, xr, ur = (t.to(dtype) for t in (u_bar, xr, ur))
        fd = None if f_dist is None else f_dist.to(dtype)[:, :N]
        c = lambda v: const(v, dtype, dev)
        r_diag = c(r_diag_v)

        Hxx, gx = gn_state_terms(x_bar, xr, c(q_diag_v), stage_scale)
        Huu = torch.diag_embed(stage_scale * r_diag).expand(Bsz, N, NUT, NUT)
        gu = stage_scale * (r_diag * (u_bar - ur))
        Hxu = torch.zeros((Bsz, N, NXT, NUT), dtype=dtype, device=dev)

        x_next, A, Bm = rk4_with_tangents(f, f_jac, x_bar[:, :N], u_bar, fd, dt_h,
                                          ocp.erk_substeps)
        r = x_next - x_bar[:, 1:]

        lu = f_min - u_bar
        uu = f_max - u_bar
        vbar = x_bar[..., BX]
        inner = torch.zeros((N + 1, 1), dtype=torch.bool, device=dev)
        inner[1:N] = True
        big = torch.full((), BIG, dtype=dtype, device=dev)
        lx = torch.where(inner, c(v_lo_v) - vbar, -big)
        ux = torch.where(inner, c(v_hi_v) - vbar, big)
        return QpData(Hxx, Hxu, Huu, gx, gu, A, Bm, r, lu, uu, lx, ux)

    return linearize_horizon, phi


def make_thrust_rti_controller(
    ocp: OcpParams,
    veh: VehicleParams,
    tw: ThrustOcpWeights = ThrustOcpWeights(),
    *,
    qp_iters: int = 12,
    eq_tol: float = 1e-3,
    device=None,
) -> RtiController:
    """SQP-RTI for the motor-thrust model: `reset(xr, ur)` and `update(state,
    x0, xr, ur, f_dist=None)` as `make_rti_controller` (nx=13, nu=4 rotor
    thrusts), on one scenario (x_bar (N+1, 13), x0 (13,)) or batch-first
    (B, ...). u0 is the first planned thrust, unclipped, as in JAX; `ok` is
    the controller's own test: finite, eq_res under `eq_tol`, every planned
    rotor thrust inside [f_min, f_max] widened by 1e-4 of the range. Runs on
    `device`, by default the card."""
    dev = resolve_device(device)
    linearize_horizon, _ = make_thrust_ocp_functions(ocp, veh, tw)
    f_min, f_max = rotor_thrust_bounds(veh)
    tol = 1e-4 * (f_max - f_min)

    def reset(xr, ur) -> RtiState:
        return RtiState(torch.as_tensor(xr, device=dev), torch.as_tensor(ur, device=dev))

    def update(state: RtiState, x0, xr, ur, f_dist=None):
        dt = state.x_bar.dtype
        as_in = lambda a: None if a is None else torch.as_tensor(a, dtype=dt, device=dev)
        x0, xr, ur, f_dist = (as_in(a) for a in (x0, xr, ur, f_dist))
        qp = linearize_horizon(state.x_bar, state.u_bar, xr, ur, f_dist)
        sol = solve_qp(qp, x0 - state.x_bar[..., 0, :], num_iters=qp_iters)
        new_state = RtiState(state.x_bar + sol.dx, state.u_bar + sol.du)
        u = new_state.u_bar
        in_box = ((u >= f_min - tol) & (u <= f_max + tol)).flatten(-2).all(dim=-1)
        ok = torch.isfinite(sol.eq_res) & (sol.eq_res < eq_tol) & in_box
        return u[..., 0, :], new_state, RtiInfo(mu=sol.mu, eq_res=sol.eq_res, ok=ok)

    return RtiController(reset, update, ocp, veh, False, device=dev)


def thrust_refs_from_bodyrate(xr10: torch.Tensor, ur4: torch.Tensor, veh: VehicleParams):
    """Lift body-rate references (`traj.refgen`) to the 13-state model: the
    state gains the flatness body rates (the last control's rates extended
    to node N), the control becomes the commanded collective force split
    evenly over the rotors. xr10 (..., N+1, 10), ur4 (..., N, 4 = [wx, wy,
    wz, c]) -> (xr13 (..., N+1, 13), ur (..., N, 4) rotor thrusts)."""
    w_ref = torch.cat([ur4[..., :, 0:3], ur4[..., -1:, 0:3]], dim=-2)
    xr13 = torch.cat([xr10, w_ref], dim=-1)
    f_total = ur4[..., :, 3] * veh.mass
    return xr13, (f_total[..., None] / 4.0).expand(f_total.shape + (4,)).contiguous()
