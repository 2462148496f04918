"""Closed-loop swarm episodes: controller + estimator + plant + formation
exchange + downwash, every drone a row of one batch on the episode's device.

Port of `ndp_nmpc_qd_tpu/sim/closed_loop.py`. Per 50 Hz control tick (the
dataflow of `nmpc_node.py:211-231` and the leader/follower callbacks):

1. leader reference from the trajectory at t (or the hold point),
2. follower references = the leader's previously published horizon + the
   low-pass-filtered formation offset (the one-tick PredXU delay,
   `nmpc_node.py:160-162`),
3. the NDP leader's downwash forecast from the follower's previous horizon
   (gated by r_horiz, `ndp_nmpc_leader_node.py:60-76`),
4. one RTI solve per drone (the batched controller),
5. live recovery of unhealthy solves, throttle conversion through the
   estimated gain, the hover-throttle estimator tick,
6. the plant step with ground-truth downwash coupling,
7. RMSE accumulation (tracking: `base_pt_publisher.py:52-79`; formation:
   `nmpc_follower_node.py:79-94`).

The mission clock stays on the host: the tick, the hold/track phase, the
trajectory time and `finished` are Python numbers, so `step_fn` never waits
for the card. Health, the re-seed count and the error sums stay on the
device. `run_fn` is a Python loop over `step_fn`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..estimators.hover_throttle import (
    HoverThrottleState, hover_throttle_init, hover_throttle_update, throttle_from_collective,
)
from ..models.downwash_mlp import DownwashMlp, predict_downwash
from ..models.quadrotor import hover_state
from ..ops import quat
from ..ops.layout import pack
from ..params import NdpNmpcConfig
from ..solver.rti import RtiState, make_batched_rti_controller
from ..swarm.formation import rate_converted_alpha, reference_formation_offsets
from ..traj.polyopt import PiecewisePoly, eval_traj, stack_trajs
from ..traj.refgen import gen_fix_pt_ref, nmpc_refs
from ..utils.recovery import recover_rti, recover_rti_packed, screen_nan, screen_nan_packed
from .downwash_truth import downwash_on_locals, pairwise_downwash
from .plant import PlantState, plant_init, plant_step


class EpisodeState(NamedTuple):
    plant: PlantState  # (D, ...)
    rti: RtiState  # the controller's state, in its layout
    est: HoverThrottleState  # (D, ...)
    lpf_offset: torch.Tensor  # (D, 3)
    prev_ref_x: torch.Tensor  # (D, N+1, 10) last published horizons (PredXU)
    prev_ref_u: torch.Tensor  # (D, N, 4)
    hold_xr: torch.Tensor  # (D, N+1, 10) hold-point references
    hold_ur: torch.Tensor  # (D, N, 4)
    tick: int  # host
    n_track: int  # host: ticks spent tracking (the metrics' divisor)
    pos_err2: torch.Tensor  # (D,) accumulated squared tracking error
    yaw_err2: torch.Tensor  # (D,)
    form_err2: torch.Tensor  # (D,) accumulated squared formation error
    ok_all: torch.Tensor  # (D,) bool
    recovered: torch.Tensor  # () int64: total scenario re-seeds (recover=True)


class EpisodeMetrics(NamedTuple):
    pos_rmse: torch.Tensor  # (D,)
    yaw_rmse_deg: torch.Tensor  # (D,)
    form_rmse: torch.Tensor  # (D,)
    ok: torch.Tensor  # (D,)
    recovered: torch.Tensor  # ()


def resolve_backend(solver_backend: str, n_drones: int, device) -> str:
    """The controller that `make_episode(solver_backend=...)` runs for
    `n_drones` drones on `device`: "auto" resolves as the JAX rule
    (`ndp_nmpc_qd_tpu/sim/closed_loop.py:179-184`), to the kernels
    ("pallas") once the drone batch fills the card (512 drones or more),
    else to the scan controller ("jax"); any other name stands."""
    if solver_backend != "auto":
        return solver_backend
    return "pallas" if n_drones >= 512 and torch.device(device).type == "cuda" else "jax"


def make_episode(
    cfg: NdpNmpcConfig,
    traj: PiecewisePoly,
    *,
    n_drones: int = 1,
    use_ndp: bool = False,
    downwash_params: DownwashMlp | None = None,
    formation_fn: Callable | None = None,
    true_downwash: bool = False,
    qp_iters: int = 12,
    record_traces: bool = False,
    hold_ticks: int = 0,
    independent: bool = False,
    solver_backend: str = "auto",
    solver_warm_start: bool = False,
    solver_jac_bf16: bool = False,
    solver_lqr_start: bool = True,
    solver_whole_ipm: bool = False,
    solver_packed_state: bool = False,
    solver_whole_step: bool = False,
    swarm_axis_name: str | None = None,
    swarm_shards: int = 1,
    n_groups: int = 1,
    anchors=None,
    recover: bool = False,
    device=None,
):
    """Build (init_fn, step_fn, run_fn) for a swarm episode, as the JAX
    `make_episode` does (its docstring describes each mode):

    - drone 0 is the leader tracking `traj`, drones 1.. follow with filtered
      offsets; `use_ndp` enables the leader's downwash forecast (needs
      `downwash_params`, a `DownwashMlp`), `true_downwash` the plant-side
      coupling;
    - `n_groups` > 1 runs that many independent formations of
      n_drones / n_groups drones at `anchors` (S, 3), one flattened
      controller batch;
    - `independent` (four_qd): every drone its own leader on an offset copy
      of `traj`, or on its own trajectory when `traj` is a sequence;
    - `hold_ticks` ticks of hold-point calibration (estimator running), then
      tracking (estimator frozen, RMSE accumulating);
    - `recover` re-seeds unhealthy scenarios and flies the hold command for
      that tick; `ok` then reports last-tick health.

    The controller is `make_batched_rti_controller` with `solver_backend`
    as `resolve_backend` resolves it; the scan controller ("jax") ignores
    the kernel-path flags (warm start, bf16, whole IPM, packed state, whole
    step). A sharded episode (`swarm_axis_name` /
    `swarm_shards` > 1, ROADMAP Queue 1 item 11) raises. The solver flags
    are `make_batched_rti_controller`'s. Runs on `device`, by default the
    card.
    """
    if swarm_axis_name is not None or swarm_shards > 1:
        raise NotImplementedError(
            "the sharded episode (swarm_axis_name / swarm_shards > 1) is not ported yet: "
            "ROADMAP Queue 1 item 11"
        )
    dev = resolve_device(device)
    ocp, veh, est_p, dw = cfg.ocp, cfg.vehicle, cfg.estimator, cfg.downwash
    multi_traj = not isinstance(traj, PiecewisePoly)
    if multi_traj:
        assert independent, "per-drone trajectories require independent mode"
        trajs = list(traj)
        traj = stack_trajs([trajs[i % len(trajs)] for i in range(n_drones)])
    traj = PiecewisePoly(*(t.to(dev) for t in traj))
    solver_backend = resolve_backend(solver_backend, n_drones, dev)
    if solver_backend != "pallas":
        # kernel-layout state and the one-kernel step are pallas features
        solver_packed_state = solver_whole_step = False
    ctl = make_batched_rti_controller(
        ocp, veh, with_disturbance=True, qp_iters=qp_iters, backend=solver_backend,
        warm_start=solver_warm_start, jac_bf16=solver_jac_bf16, lqr_start=solver_lqr_start,
        whole_ipm=solver_whole_ipm, packed_state=solver_packed_state,
        whole_step=solver_whole_step, device=dev,
    )
    D, N, S = n_drones, ocp.N_node, n_groups
    assert D % S == 0, (D, S)
    G = D // S  # drones per group
    assert S == 1 or not (independent or multi_traj), (
        "groups are formations; independent/per-drone-traj modes have none"
    )
    anchors = np.zeros((S, 3)) if anchors is None else np.asarray(anchors, np.float64)
    assert anchors.shape == (S, 3), anchors.shape
    if formation_fn is None:
        formation_fn = partial(reference_formation_offsets, n_drones=G)
    alpha_tick = rate_converted_alpha(0.8, 0.05, ocp.ts_nmpc)
    gidx = torch.arange(D, device=dev)
    member = gidx % G
    grp = gidx // G
    is_leader = member == 0
    # the mission clock's end, on the host
    t_end = float(traj.t_cum[..., -1].max())
    anch_of = {}  # the anchors per compute dtype, on the device

    def anch_for(dtype):
        if dtype not in anch_of:
            anch_of[dtype] = torch.tensor(anchors, dtype=dtype, device=dev)
        return anch_of[dtype]

    def init_fn(dtype=torch.float32) -> EpisodeState:
        anch = anch_for(dtype)
        if multi_traj:
            # each drone hovers at its own trajectory's start; no offsets
            fo0 = eval_traj(traj, torch.zeros(D, dtype=dtype, device=dev))
            x0 = hover_state(fo0.pos.to(dtype))
            offsets0 = torch.zeros((D, 3), dtype=dtype, device=dev)
        else:
            fo0 = eval_traj(traj, 0.0)
            lead_x0 = hover_state(fo0.pos.to(dtype)[None] + anch)  # (S, 10)
            # the offset rule applies in each group's own frame
            own = torch.cat([lead_x0[:, 0:3] - anch, lead_x0[:, 3:]], dim=-1)
            offsets0 = formation_fn(own).reshape(D, 3).to(dtype)
            x0 = lead_x0.repeat_interleave(G, dim=0)
            x0 = torch.cat([x0[:, 0:3] + offsets0, x0[:, 3:]], dim=-1)
        xr0, ur0 = gen_fix_pt_ref(x0, ocp, veh)
        z = lambda: torch.zeros(D, dtype=dtype, device=dev)
        return EpisodeState(
            plant=plant_init(x0, veh),
            rti=ctl.reset(xr0, ur0),
            est=hover_throttle_init(est_p, batch=(D,), dtype=dtype, device=dev),
            lpf_offset=offsets0,
            prev_ref_x=xr0, prev_ref_u=ur0, hold_xr=xr0, hold_ur=ur0,
            tick=0, n_track=0,
            pos_err2=z(), yaw_err2=z(), form_err2=z(),
            ok_all=torch.ones(D, dtype=torch.bool, device=dev),
            recovered=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def step_fn(st: EpisodeState, _=None):
        x = st.plant.x
        dtype = x.dtype
        in_hold = st.tick < hold_ticks
        # the trajectory clock, rounded as the compute dtype rounds it
        npf = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        t = max(float(npf(st.tick - hold_ticks) * npf(ocp.ts_nmpc)), 0.0)
        finished = (not in_hold) and t >= float(npf(t_end))
        anch = anch_for(dtype)
        x_grp = x.reshape(S, G, 10)
        lead_x = x_grp[:, 0]

        if not multi_traj:
            # 1. leader references: the hold point while calibrating, else the
            # trajectory anchored at each group's placement
            if in_hold:
                xr_L = st.hold_xr.reshape(S, G, N + 1, 10)[:, 0]
                ur_L = st.hold_ur.reshape(S, G, N, 4)[:, 0]
            else:
                xr_T, ur_T = nmpc_refs(traj, t, ocp, veh)
                xr_T = xr_T.to(dtype)
                xr_L = torch.cat([xr_T[None, :, 0:3] + anch[:, None, :],
                                  xr_T[None, :, 3:].expand(S, N + 1, 7)], dim=-1)
                ur_L = ur_T.to(dtype)[None].expand(S, N, 4)

        if multi_traj:
            # four_qd with per-drone goals: each drone its own trajectory
            lpf = st.lpf_offset
            if in_hold:
                xr, ur = st.hold_xr, st.hold_ur
            else:
                xr_D, ur_D = nmpc_refs(traj, t, ocp, veh)
                xr, ur = xr_D.to(dtype), ur_D.to(dtype)
        elif independent:
            # four_qd: every drone on its own offset copy of the trajectory
            lpf = st.lpf_offset
            xr = torch.cat([xr_L[0][None, :, 0:3] + lpf[:, None, :],
                            xr_L[0][None, :, 3:].expand(D, N + 1, 7)], dim=-1)
            ur = ur_L[0][None].expand(D, N, 4)
        else:
            # 2. follower references from each group leader's previous
            # horizon plus the filtered offset (own-frame offset rule)
            own = torch.cat([lead_x[:, 0:3] - anch, lead_x[:, 3:]], dim=-1)
            raw_off = formation_fn(own).reshape(D, 3).to(dtype)
            lpf = alpha_tick * st.lpf_offset + (1 - alpha_tick) * raw_off
            prev_x = st.prev_ref_x.reshape(S, G, N + 1, 10)[:, 0][grp]
            prev_u = st.prev_ref_u.reshape(S, G, N, 4)[:, 0][grp]
            xr_F = torch.cat([prev_x[..., 0:3] + lpf[:, None, :], prev_x[..., 3:]], dim=-1)
            lead = is_leader[:, None, None]
            xr = torch.where(lead, xr_L[grp], xr_F)
            ur = torch.where(lead, ur_L[grp], prev_u)

        # 3. the NDP forecast of each group leader from its member 1's
        # previous horizon
        f_dist = torch.zeros((D, N + 1, 3), dtype=dtype, device=dev)
        if use_ndp and G > 1 and not independent:
            prev_m1 = st.prev_ref_x.reshape(S, G, N + 1, 10)[:, 1]
            with torch.no_grad():
                f_leader = predict_downwash(
                    downwash_params, prev_m1, xr_L, r_horiz=dw.r_horiz,
                    ego_gate_pos=lead_x[:, 0:3],
                )
            f_dist = torch.where(is_leader[:, None, None], f_leader[grp].to(dtype), f_dist)

        # 4. one RTI solve per drone
        u0, rti, info = ctl.update(st.rti, x, xr, ur, f_dist)

        # 4b. live recovery: unhealthy scenarios fly the hold command this
        # tick and restart from their reference
        ok_tick = info.ok
        n_reseeded = None
        if recover:
            ok_tick = ok_tick & torch.isfinite(u0).all(dim=-1)
            if ctl.layout == "kernel":
                ok_tick = screen_nan_packed(rti, ok_tick)
                rti = recover_rti_packed(rti, ok_tick, pack(xr), pack(ur))
            else:
                ok_tick = screen_nan(rti, ok_tick)
                rti = recover_rti(rti, ok_tick, xr, ur)
            hold_u = torch.zeros(4, dtype=dtype, device=dev)
            hold_u[3] = veh.gravity
            u0 = torch.where(ok_tick[:, None], u0, hold_u)
            n_reseeded = torch.sum(~ok_tick)

        # 5. throttle conversion and the estimator tick (frozen while
        # tracking, as the reference shuts its timer down)
        throttle = throttle_from_collective(u0[:, 3], st.est.x[..., 1], veh.mass)
        est = st.est
        if in_hold or finished:
            est, _ = hover_throttle_update(st.est, x[:, 5], throttle, est_p)

        # 6. the plant step with ground-truth coupling (within each group)
        if true_downwash and D > 1:
            if S > 1:
                f_ext = pairwise_downwash(x_grp).reshape(D, 3).to(dtype)
            else:
                f_ext = downwash_on_locals(x, x, gidx)
        else:
            f_ext = torch.zeros((D, 3), dtype=dtype, device=dev)
        plant = plant_step(st.plant, u0[:, 0:3], throttle, f_ext, ocp.ts_nmpc, veh, cfg.sim)

        # 7. metrics while tracking: leader vs trajectory, followers vs
        # their formation target
        track = not in_hold
        pos_err2, yaw_err2, form_err2 = st.pos_err2, st.yaw_err2, st.form_err2
        if track:
            fo_t = eval_traj(traj, t)
            if multi_traj:
                pos_tgt, yaw_tgt = fo_t.pos.to(dtype), fo_t.yaw.to(dtype)
            else:
                lead_tgt = fo_t.pos[None].to(dtype) + anch[grp]
                pos_tgt = torch.where(is_leader[:, None], lead_tgt, xr[:, 0, 0:3])
                yaw_tgt = torch.where(is_leader, fo_t.yaw.to(dtype), quat.yaw(xr[:, 0, 6:10]))
            pos_err2 = pos_err2 + torch.sum((pos_tgt - x[:, 0:3]) ** 2, dim=-1)
            yaw_err2 = yaw_err2 + torch.rad2deg(yaw_tgt - quat.yaw(x[:, 6:10])) ** 2
            form_err2 = form_err2 + torch.sum((xr[:, 0, 0:3] - x[:, 0:3]) ** 2, dim=-1)

        new = EpisodeState(
            plant=plant, rti=rti, est=est, lpf_offset=lpf,
            prev_ref_x=xr, prev_ref_u=ur, hold_xr=st.hold_xr, hold_ur=st.hold_ur,
            tick=st.tick + 1, n_track=st.n_track + int(track),
            pos_err2=pos_err2, yaw_err2=yaw_err2, form_err2=form_err2,
            # recover=True: health is a live property (the last tick's)
            ok_all=ok_tick if recover else (st.ok_all & info.ok),
            recovered=st.recovered if n_reseeded is None else st.recovered + n_reseeded,
        )
        return new, ((x, u0, throttle) if record_traces else None)

    def run_fn(st: EpisodeState, n_ticks: int):
        """n_ticks steps; returns (state, metrics, traces (x (T, D, 10),
        u0 (T, D, 4), throttle (T, D)) or None)."""
        outs = []
        for _ in range(n_ticks):
            st, out = step_fn(st)
            outs.append(out)
        n = float(max(st.n_track, 1))
        metrics = EpisodeMetrics(
            pos_rmse=torch.sqrt(st.pos_err2 / n), yaw_rmse_deg=torch.sqrt(st.yaw_err2 / n),
            form_rmse=torch.sqrt(st.form_err2 / n), ok=st.ok_all, recovered=st.recovered,
        )
        traces = None
        if record_traces and outs:
            traces = tuple(torch.stack(v) for v in zip(*outs))
        return st, metrics, traces

    return init_fn, step_fn, run_fn

