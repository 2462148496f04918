"""The deployed controller's tick in plain PyTorch: the frozen K1 step
(`kernels.control_step_whole_plain`) with the port's `reset` and `update`
semantics (`solver/rti.py`: kernel-layout state, carried duals, the first
control clipped to the box and the health flag). Imports nothing of the
port; works in any floating dtype (the control runs it in bfloat16).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .kernels import control_step_whole_plain
from .params import from_config

BIG = 1e9  # stands in for +-inf on masked bounds (the state box at nodes 0 and N)


class RtiState(NamedTuple):
    """Kernel layout: x_bar (N+1, 10, B), u_bar (N, 4, B); ipm the carried
    duals (lu_lo, lu_up (N, 4, B), lx_lo, lx_up (N+1, 3, B), mu (B,))."""

    x_bar: torch.Tensor
    u_bar: torch.Tensor
    ipm: tuple | None = None


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, s, d...) -> (s, prod(d), B), a new contiguous tensor."""
    B, s = x.shape[0], x.shape[1]
    d = math.prod(x.shape[2:])
    return x.reshape(B, s, d).permute(1, 2, 0).clone(memory_format=torch.contiguous_format)


def unpack(x: torch.Tensor, trailing: tuple) -> torch.Tensor:
    s, B = x.shape[0], x.shape[2]
    return x.permute(2, 0, 1).reshape((B, s) + tuple(trailing))


def step_consts(cfg: dict) -> dict:
    """Keyword constants of the step: the linearization's and the IPM's,
    from the configuration file (`ocp_sparse.whole_step_consts`)."""
    p = from_config(cfg)
    ocp, veh, ctl, ipm = p.ocp, p.vehicle, cfg["controller"], cfg["ipm"]
    fl = lambda v: tuple(float(t) for t in np.asarray(v))
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    q_diag = np.asarray(ocp.q_diag())
    return dict(
        h=float(ocp.th_pred), substeps=int(ocp.erk_substeps),
        mass=float(veh.mass), gravity=float(veh.gravity), stage_scale=float(stage_scale),
        q_diag=fl(ocp.q_diag()), r_diag=fl(ocp.r_diag()),
        u_lo=fl(ocp.u_lower()), u_hi=fl(ocp.u_upper()),
        v_lo=fl(ocp.v_lower()), v_hi=fl(ocp.v_upper()),
        with_dist=bool(ctl["with_disturbance"]), big=float(BIG),
        jac_bf16=bool(ctl["jac_bf16"]),
        diag6_stage=tuple(float(v) * stage_scale for v in q_diag[:6]),
        diag6_term=fl(q_diag[:6]),
        rdiag_stage=tuple(float(v) * stage_scale for v in np.asarray(ocp.r_diag())),
        tau=float(ipm["tau"]), sigma=float(ipm["sigma"]), mu_init=float(ipm["mu_init"]),
        s_min=float(ipm["s_min"]), mu_min=float(ipm["mu_min"]),
        num_iters=int(ctl["qp_iters"]),
    )


def hover_refs(pos: torch.Tensor, p, dtype) -> tuple:
    """Hover references at pos (B, 3): xr (B, N+1, 10), ur (B, N, 4)."""
    N, B = p.ocp.N_node, pos.shape[0]
    q = pos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
    x = torch.cat([pos, torch.zeros_like(pos), q], dim=-1).to(dtype)
    u = torch.zeros(B, 4, dtype=dtype, device=pos.device)
    u[:, 3] = p.vehicle.gravity
    return x[:, None].repeat(1, N + 1, 1), u[:, None].repeat(1, N, 1)


def cold_duals(N: int, B: int, dtype, device) -> tuple:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return (z(N, 4, B), z(N, 4, B), z(N + 1, 3, B), z(N + 1, 3, B),
            torch.full((B,), -1.0, dtype=dtype, device=device))


def reset(xr: torch.Tensor, ur: torch.Tensor) -> RtiState:
    """Iterates from the references, every scenario's duals cold."""
    N, B = ur.shape[1], xr.shape[0]
    return RtiState(pack(xr), pack(ur.to(xr.dtype)), cold_duals(N, B, xr.dtype, xr.device))


def first_control_and_health(cfg: dict, x_bar, u_bar, eq_res):
    """u0 (B, 4) clipped to the box and the health flag (B,), kernel layout."""
    ocp = from_config(cfg).ocp
    eq_tol = float(cfg["controller"]["eq_tol"])
    dt, dev = u_bar.dtype, u_bar.device
    N = ocp.N_node
    box = lambda v: torch.tensor(tuple(float(x) for x in v), dtype=dt, device=dev)
    u_lo, u_hi = box(ocp.u_lower()), box(ocp.u_upper())
    u0 = torch.clamp(u_bar[0].T, min=u_lo, max=u_hi)
    bound_tol = 1e-4 * (u_hi - u_lo)
    lo = (u_lo - bound_tol).view(1, 4, 1)
    hi = (u_hi + bound_tol).view(1, 4, 1)
    in_box = ((u_bar >= lo) & (u_bar <= hi)).all(dim=1).all(dim=0)
    v_lo, v_hi = box(ocp.v_lower()), box(ocp.v_upper())
    v_tol = 1e-3 * (v_hi - v_lo)
    v_plan = x_bar[1:N, 3:6]
    in_box &= (
        (v_plan >= (v_lo - v_tol).view(1, 3, 1))
        & (v_plan <= (v_hi + v_tol).view(1, 3, 1))
    ).all(dim=1).all(dim=0)
    return u0, torch.isfinite(eq_res) & (eq_res < eq_tol) & in_box


def update(cfg: dict, state: RtiState, x0, xr, ur, f_dist):
    """One RTI tick in the dtype of `state`; x0 (B, 10), xr (B, N+1, 10),
    ur (B, N, 4), f_dist (B, N+1, 3) batch-first. Returns (u0, new state,
    ok, eq_res)."""
    dt = state.x_bar.dtype
    ctl = cfg["controller"]
    N, B = state.u_bar.shape[0], state.x_bar.shape[-1]
    duals = state.ipm if ctl["warm_start"] else cold_duals(N, B, dt, state.x_bar.device)
    fd = pack(f_dist.to(dt)) if ctl["with_disturbance"] else None
    outs = control_step_whole_plain(
        state.x_bar, state.u_bar, pack(xr.to(dt)), pack(ur.to(dt)), fd,
        pack(x0.to(dt)[:, None]), *duals, **step_consts(cfg),
    )
    xb, ub, eq = outs[0], outs[1], outs[7]
    new = RtiState(xb, ub, tuple(outs[2:7]) if ctl["warm_start"] else state.ipm)
    u0, ok = first_control_and_health(cfg, xb, ub, eq)
    return u0, new, ok, eq
