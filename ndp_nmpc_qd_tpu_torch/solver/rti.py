"""SQP-RTI controller on the fused one-kernel control step.

Port of `ndp_nmpc_qd_tpu/solver/rti.py` (`RtiState`, `RtiInfo`,
`RtiController`, `unpack_iterates`, and the `packed_state=True,
whole_step=True` branch of `make_batched_rti_controller`). Semantics mirror
the reference controller (`nmpc_ctl/nmpc_body_rate_ctl.py`):

- `reset(xr, ur)` seeds every shooting-node iterate with the reference and
  marks every scenario's QP duals cold (`mu = -1`), killing warm starts
  across trajectories.
- `update(state, x0, xr, ur, f_dist)` performs ONE real-time iteration per
  scenario: linearize at the iterates, solve the Gauss-Newton QP with the
  initial state pinned to x0, take the full step, return the first control
  clipped to the actuator box plus solver health.

The iterates and carried duals live in kernel layout (stage, element, B) and
are updated IN PLACE by the step: `update` returns the same tensors in its
new state, and the state passed in must not be used afterwards. `reset`
clones the references for that reason, so the caller's `xr`/`ur` are never
written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.kernels.step_whole import make_workspace
from ..ops.layout import pack, unpack
from ..params import OcpParams, VehicleParams
from .ocp_sparse import make_whole_step
from .qp_ipm_sparse import IpmWarm, cold_warm


class RtiState(NamedTuple):
    """Shooting-node iterates, kernel layout: x_bar (N+1, 10, B), u_bar
    (N, 4, B). `ipm` (warm_start=True) carries the QP duals across ticks:
    (lu_lo, lu_up (N, 4, B), lx_lo, lx_up (N+1, 3, B), mu (B,)); mu < 0
    marks a scenario cold."""

    x_bar: torch.Tensor
    u_bar: torch.Tensor
    ipm: tuple | None = None


class RtiInfo(NamedTuple):
    mu: torch.Tensor  # final IPM barrier weight per scenario
    eq_res: torch.Tensor  # final QP equality residual norm
    ok: torch.Tensor  # bool health flag


class RtiController(NamedTuple):
    reset: callable
    update: callable
    ocp: OcpParams
    vehicle: VehicleParams
    with_disturbance: bool
    layout: str = "kernel"
    device: torch.device | None = None


def unpack_iterates(state: RtiState, B: int):
    """Kernel-layout RtiState -> batch-first (x_bar (B, N+1, 10), u_bar)."""
    return (
        unpack(state.x_bar, (state.x_bar.shape[1],))[:B],
        unpack(state.u_bar, (state.u_bar.shape[1],))[:B],
    )


def first_control_and_health(ocp: OcpParams, x_bar, u_bar, eq_res, eq_tol=1e-3):
    """u0 (B, 4) clipped to the actuator box, and the health flag (B,):
    finite residual below eq_tol, the planned controls inside the box
    (tolerance 1e-4 of its range) and the planned velocities of nodes
    1..N-1 inside the v box (tolerance 1e-3 of its range)."""
    dt, dev = u_bar.dtype, u_bar.device
    N = ocp.N_node
    u_lo = torch.as_tensor(ocp.u_lower(), dtype=dt, device=dev)
    u_hi = torch.as_tensor(ocp.u_upper(), dtype=dt, device=dev)
    u0 = torch.clamp(u_bar[0].T, min=u_lo, max=u_hi)
    bound_tol = 1e-4 * (u_hi - u_lo)
    lo = (u_lo - bound_tol).view(1, 4, 1)
    hi = (u_hi + bound_tol).view(1, 4, 1)
    in_box = ((u_bar >= lo) & (u_bar <= hi)).all(dim=1).all(dim=0)
    v_lo = torch.as_tensor(ocp.v_lower(), dtype=dt, device=dev)
    v_hi = torch.as_tensor(ocp.v_upper(), dtype=dt, device=dev)
    v_tol = 1e-3 * (v_hi - v_lo)
    v_plan = x_bar[1:N, 3:6]
    in_box &= (
        (v_plan >= (v_lo - v_tol).view(1, 3, 1))
        & (v_plan <= (v_hi + v_tol).view(1, 3, 1))
    ).all(dim=1).all(dim=0)
    return u0, torch.isfinite(eq_res) & (eq_res < eq_tol) & in_box


def make_batched_rti_controller(
    ocp: OcpParams,
    vehicle: VehicleParams,
    *,
    with_disturbance: bool = False,
    qp_iters: int = 12,
    eq_tol: float = 1e-3,
    backend: str = "auto",
    warm_start: bool = False,
    jac_bf16: bool = False,
    lqr_start: bool = True,
    whole_ipm: bool = False,
    packed_state: bool = False,
    whole_step: bool = False,
    device=None,
) -> RtiController:
    """Batch-first RTI controller on the fused control-step kernel.

    Only the deployed combination is ported: `packed_state=True,
    whole_step=True` (the whole step in one launch, which implies the
    zero-control start, so `lqr_start` and `whole_ipm` do not change it, as
    in the JAX package). `warm_start` carries the QP duals across ticks;
    `jac_bf16` stores the curvature payloads in bfloat16.

    Runs on `device`, by default the card; without a card and without an
    explicit device it raises.
    """
    if backend not in ("auto", "pallas"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet: the scan controller is "
            "ROADMAP Queue 1 item 8, the legacy dense kernels Queue 2 K8+K9"
        )
    if not (packed_state and whole_step):
        raise NotImplementedError(
            "only packed_state=True, whole_step=True is ported: the "
            "two-kernel whole-IPM path is ROADMAP Queue 2 K2+K3, the "
            "per-iteration kernels K4+K5"
        )
    if qp_iters < 1:
        raise ValueError(f"qp_iters must be >= 1, got {qp_iters}")
    dev = resolve_device(device)
    step = make_whole_step(
        ocp, vehicle, with_disturbance, jac_bf16=jac_bf16, num_iters=qp_iters
    )
    N = ocp.N_node
    workspaces = {}

    def as_input(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def reset(xr, ur) -> RtiState:
        xr = torch.as_tensor(xr, device=dev)
        ur = torch.as_tensor(ur, device=dev)
        # clone: the step updates the iterates in place, and `pack` may
        # return a view of the caller's tensor (B = 1)
        x_bar = pack(xr).clone()
        u_bar = pack(ur.to(xr.dtype)).clone()
        ipm0 = None
        if warm_start:
            ipm0 = tuple(cold_warm(N, xr.shape[0], xr.dtype, dev))
        return RtiState(x_bar, u_bar, ipm0)

    def update(state: RtiState, x0, xr, ur, f_dist=None):
        dt = state.x_bar.dtype
        x0 = as_input(x0, dt)
        B = x0.shape[0]
        warm = IpmWarm(*state.ipm) if warm_start else cold_warm(N, B, dt, dev)
        fd_p = None
        if with_disturbance:
            if f_dist is None:
                fd_p = torch.zeros((N + 1, 3, B), dtype=dt, device=dev)
            else:
                fd_p = pack(as_input(f_dist, dt))
        workspace = None
        if dev.type == "cuda":
            key = (B, dt)
            if key not in workspaces:
                workspaces[key] = make_workspace(B, N, jac_bf16, dev)
            workspace = workspaces[key]
        xb, ub = state.x_bar, state.u_bar
        eq = step(
            xb, ub, pack(as_input(xr, dt)), pack(as_input(ur, dt)), fd_p,
            pack(x0[:, None]), warm, workspace=workspace,
        )
        new_state = RtiState(xb, ub, tuple(warm) if warm_start else state.ipm)
        u0, ok = first_control_and_health(ocp, xb, ub, eq, eq_tol)
        return u0, new_state, RtiInfo(mu=warm.mu.clone(), eq_res=eq, ok=ok)

    return RtiController(
        reset, update, ocp, vehicle, with_disturbance, layout="kernel",
        device=dev,
    )
