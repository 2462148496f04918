"""Closed-loop mission for the motor-thrust controller.

Port of `ndp_nmpc_qd_tpu/sim/thrust_loop.py`: a 13-state per-rotor plant
(first-order rotor lag, RK4 substeps, quaternion renormalization: the
dop_sim role for this actuation mode) driven by the thrust RTI controller
(`solver/ocp_thrust.py`) over the hold-then-track phasing of
`closed_loop.make_episode`, reporting the same tracking RMSE the reference
returns in its TrackTraj result (`nmpc_node.py:186-200`). The controller
commands rotor forces directly, so no hover-throttle estimator runs here.

As in `closed_loop.py`, the mission clock stays on the host: the tick, the
hold/track phase and the trajectory time are Python numbers; health and the
error sums stay on the device, and `run_fn` is a Python loop over `step_fn`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..models.quadrotor import hover_state
from ..models.quadrotor_thrust import hover_thrust, thrust_dynamics
from ..ops import quat
from ..ops.integrators import rk4_step
from ..params import NdpNmpcConfig, SimParams, VehicleParams
from ..solver.ocp_thrust import (
    ThrustOcpWeights, make_thrust_rti_controller, thrust_refs_from_bodyrate,
)
from ..solver.rti import RtiState
from ..traj.polyopt import PiecewisePoly, eval_traj
from ..traj.refgen import nmpc_refs
from .closed_loop import EpisodeMetrics


class ThrustPlantState(NamedTuple):
    x: torch.Tensor  # (..., 13)
    f_act: torch.Tensor  # (..., 4) actual rotor thrusts (first-order lag)


class ThrustEpisodeState(NamedTuple):
    plant: ThrustPlantState
    rti: RtiState  # (D, ...)
    hold_xr: torch.Tensor  # (D, N+1, 13)
    hold_ur: torch.Tensor  # (D, N, 4)
    tick: int  # host
    n_track: int  # host: ticks spent tracking (the metrics' divisor)
    pos_err2: torch.Tensor  # (D,)
    yaw_err2: torch.Tensor  # (D,)
    ok_all: torch.Tensor  # (D,) bool


def thrust_plant_step(state: ThrustPlantState, f_cmd: torch.Tensor, f_ext: torch.Tensor,
                      dt: float, veh: VehicleParams, sim: SimParams) -> ThrustPlantState:
    """Advance the per-rotor plant by one control period dt: the rotor lag,
    then RK4 of the 13-state dynamics in substeps of `sim.ts_sim`; f_ext
    (..., 3) is a world-frame force [N]."""
    if sim.thrust_tau > 0:
        a = math.exp(-dt / sim.thrust_tau)
        f = a * state.f_act + (1 - a) * f_cmd
    else:
        f = f_cmd

    def dyn(x, u):
        return thrust_dynamics(x, u, f_ext, veh=veh)

    substeps = max(1, int(round(dt / sim.ts_sim)))
    x = rk4_step(dyn, state.x, f, dt, substeps)
    x = torch.cat([x[..., 0:6], quat.normalize(x[..., 6:10]), x[..., 10:]], dim=-1)
    return ThrustPlantState(x=x, f_act=f)


def make_thrust_episode(
    cfg: NdpNmpcConfig,
    traj: PiecewisePoly,
    *,
    n_drones: int = 1,
    tw: ThrustOcpWeights = ThrustOcpWeights(),
    qp_iters: int = 12,
    hold_ticks: int = 0,
    record_traces: bool = False,
    device=None,
):
    """Build (init_fn, step_fn, run_fn) with the contract of
    `closed_loop.make_episode`: run_fn(state, n_ticks) -> (state,
    EpisodeMetrics, traces (x (T, D, 13), u0 (T, D, 4)) with
    `record_traces`, else None). form_rmse reports the tracking error: the
    drones are independent, with no formation. Runs on `device`, by default
    the card."""
    dev = resolve_device(device)
    ocp, veh = cfg.ocp, cfg.vehicle
    ctl = make_thrust_rti_controller(ocp, veh, tw, qp_iters=qp_iters, device=dev)
    D, N = n_drones, ocp.N_node
    traj = PiecewisePoly(*(t.to(dev) for t in traj))

    def init_fn(dtype=torch.float32) -> ThrustEpisodeState:
        fo0 = eval_traj(traj, 0.0)
        x0 = torch.cat([hover_state(fo0.pos.to(dtype)), torch.zeros(3, dtype=dtype, device=dev)])
        x0 = x0.expand(D, 13).clone()
        f_h = torch.full((D, 4), hover_thrust(veh), dtype=dtype, device=dev)
        xr0 = x0[:, None].expand(D, N + 1, 13).clone()
        ur0 = f_h[:, None].expand(D, N, 4).clone()
        z = lambda: torch.zeros(D, dtype=dtype, device=dev)
        return ThrustEpisodeState(
            plant=ThrustPlantState(x=x0, f_act=f_h), rti=ctl.reset(xr0, ur0),
            hold_xr=xr0, hold_ur=ur0, tick=0, n_track=0, pos_err2=z(), yaw_err2=z(),
            ok_all=torch.ones(D, dtype=torch.bool, device=dev),
        )

    def step_fn(st: ThrustEpisodeState, _=None):
        x = st.plant.x
        dtype = x.dtype
        in_hold = st.tick < hold_ticks
        # the trajectory clock, rounded as the compute dtype rounds it
        npf = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        t = max(float(npf(st.tick - hold_ticks) * npf(ocp.ts_nmpc)), 0.0)
        if in_hold:
            xr, ur = st.hold_xr, st.hold_ur
        else:
            xr10, ur4 = nmpc_refs(traj, t, ocp, veh)
            xr_T, ur_T = thrust_refs_from_bodyrate(xr10.to(dtype), ur4.to(dtype), veh)
            xr, ur = xr_T.expand(D, N + 1, 13), ur_T.expand(D, N, 4)

        u0, rti, info = ctl.update(st.rti, x, xr, ur)
        plant = thrust_plant_step(st.plant, u0, torch.zeros((D, 3), dtype=dtype, device=dev),
                                  ocp.ts_nmpc, veh, cfg.sim)

        track = not in_hold
        pos_err2, yaw_err2 = st.pos_err2, st.yaw_err2
        if track:
            fo_t = eval_traj(traj, t)
            pos_err2 = pos_err2 + torch.sum((fo_t.pos.to(dtype) - x[:, 0:3]) ** 2, dim=-1)
            yaw_err2 = yaw_err2 + torch.rad2deg(fo_t.yaw.to(dtype) - quat.yaw(x[:, 6:10])) ** 2
        new = ThrustEpisodeState(
            plant=plant, rti=rti, hold_xr=st.hold_xr, hold_ur=st.hold_ur,
            tick=st.tick + 1, n_track=st.n_track + int(track),
            pos_err2=pos_err2, yaw_err2=yaw_err2, ok_all=st.ok_all & info.ok,
        )
        return new, ((x, u0) if record_traces else None)

    def run_fn(st: ThrustEpisodeState, n_ticks: int):
        outs = []
        for _ in range(n_ticks):
            st, out = step_fn(st)
            outs.append(out)
        n = float(max(st.n_track, 1))
        pos_rmse = torch.sqrt(st.pos_err2 / n)
        metrics = EpisodeMetrics(
            pos_rmse=pos_rmse, yaw_rmse_deg=torch.sqrt(st.yaw_err2 / n), form_rmse=pos_rmse,
            ok=st.ok_all, recovered=torch.zeros((), dtype=torch.int64, device=dev),
        )
        traces = None
        if record_traces and outs:
            traces = tuple(torch.stack(v) for v in zip(*outs))
        return st, metrics, traces

    return init_fn, step_fn, run_fn
