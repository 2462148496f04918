"""One tick of the formation episode in plain PyTorch, for a sample of its
formations: a copy of the grouped, unsharded branch of the port's
`sim/closed_loop.make_episode` step (leader references from the trajectory
anchored at each formation's place, follower references from the leader's
previously published horizon plus the filtered offset, the leader's NDP
forecast from member 1's previous horizon, one RTI update per drone
(`controller.update`), live recovery, the throttle and the hover-throttle
estimator, the plant with the true downwash inside each formation, and the
tracking sums). Formations 12 m apart share nothing, so a sample of them is
a mission of its own. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import controller, forecast
from .downwash_truth import pairwise_downwash
from .formation import rate_converted_alpha, reference_formation_offsets
from .hover_throttle import hover_throttle_update, throttle_from_collective
from .params import from_config
from .plant import PlantState, plant_step
from .polyopt import eval_traj, fit_waypoints
from .quat import yaw as quat_yaw
from .refgen import nmpc_refs


def grid_placement(n_swarms: int, spacing: float) -> np.ndarray:
    """(S, 3) anchors on a square grid (`swarm_scale.grid_placement`)."""
    k = int(np.ceil(np.sqrt(n_swarms)))
    s = np.arange(n_swarms)
    return np.stack([spacing * (s % k), spacing * (s // k), np.zeros(n_swarms)], axis=-1)


def eight_waypoints(eight: dict, laps: int):
    """The eight of `cli.build_eight` repeated `laps` times: waypoints,
    segment times and yaw waypoints."""
    n = int(eight["segments_per_lap"]) * laps
    t = np.linspace(0, 2 * np.pi * laps, n + 1)
    s = float(eight["scale"])
    wpts = np.stack([s * np.sin(t), 0.5 * s * np.sin(2 * t),
                     float(eight["z0"]) + float(eight["z_amp"]) * np.sin(t)], axis=-1)
    return wpts, np.full(n, float(eight["t_seg"])), float(eight["yaw_amp"]) * np.sin(t)


def fit_eight(eight: dict, laps: int, dtype, device):
    wpts, t_seg, yaw = eight_waypoints(eight, laps)
    return fit_waypoints(wpts, t_seg, yaw, dtype=dtype, device=device)


def tick(cfg: dict, traj, layers, st: dict, *, k: int, anchors: torch.Tensor,
         forecast_tf32: bool = False):
    """Tick `k` of the sampled formations. `st` holds their rows (drones
    of one formation together, leader first): plant x, w_act, c_act
    (D, ...); rti x_bar, u_bar and its duals in kernel layout (..., D);
    est x, P, diff_prev, diff_deriv; lpf_offset, prev_ref_x, prev_ref_u,
    hold_xr, hold_ur, pos_err2, yaw_err2, form_err2. `anchors` (S, 3).
    Returns the new state (same keys) with u0, throttle and ok_tick."""
    p = from_config(cfg)
    ocp, veh, est_p, dw, mission = p.ocp, p.vehicle, p.estimator, p.downwash, cfg["mission"]
    hold_ticks, G = int(mission["hold_ticks"]), int(mission["drones_per_formation"])
    x = st["x"]
    dtype, dev = x.dtype, x.device
    D, N = x.shape[0], ocp.N_node
    S = D // G
    gidx = torch.arange(D, device=dev)
    member, grp = gidx % G, gidx // G
    is_leader = member == 0
    anch = anchors.to(dtype)
    alpha_tick = rate_converted_alpha(0.8, 0.05, ocp.ts_nmpc)
    in_hold = k < hold_ticks
    npf = {torch.float32: np.float32, torch.float64: np.float64, torch.bfloat16: np.float32}[dtype]
    t = max(float(npf(k - hold_ticks) * npf(ocp.ts_nmpc)), 0.0)
    t_end = float(traj.t_cum[..., -1].max())
    finished = (not in_hold) and t >= float(npf(t_end))
    x_grp = x.reshape(S, G, 10)
    lead_x = x_grp[:, 0]
    prev_x_all = st["prev_ref_x"]

    # 1. leader references
    if in_hold:
        xr_L = st["hold_xr"].reshape(S, G, N + 1, 10)[:, 0]
        ur_L = st["hold_ur"].reshape(S, G, N, 4)[:, 0]
    else:
        xr_T, ur_T = nmpc_refs(traj, t, ocp, veh)
        xr_T = xr_T.to(dtype)
        xr_L = torch.cat([xr_T[None, :, 0:3] + anch[:, None, :],
                          xr_T[None, :, 3:].expand(S, N + 1, 7)], dim=-1)
        ur_L = ur_T.to(dtype)[None].expand(S, N, 4)
    # 2. follower references
    own = torch.cat([lead_x[:, 0:3] - anch, lead_x[:, 3:]], dim=-1)
    raw_off = reference_formation_offsets(own, n_drones=G).reshape(D, 3).to(dtype)
    lpf = alpha_tick * st["lpf_offset"] + (1 - alpha_tick) * raw_off
    prev_x = prev_x_all.reshape(S, G, N + 1, 10)[:, 0][grp]
    prev_u = st["prev_ref_u"].reshape(S, G, N, 4)[:, 0][grp]
    xr_F = torch.cat([prev_x[..., 0:3] + lpf[:, None, :], prev_x[..., 3:]], dim=-1)
    lead = is_leader[:, None, None]
    xr = torch.where(lead, xr_L[grp], xr_F)
    ur = torch.where(lead, ur_L[grp], prev_u)
    # 3. the leader's forecast from member 1's previous horizon
    f_dist = torch.zeros((D, N + 1, 3), dtype=dtype, device=dev)
    if mission["use_ndp"] and G > 1:
        prev_m1 = prev_x_all.reshape(S, G, N + 1, 10)[:, 1]
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = forecast_tf32
        try:
            # the net's own precision, whatever the state's
            f_leader = forecast.predict_downwash(layers, prev_m1.float(), xr_L.float(),
                                                 r_horiz=dw.r_horiz,
                                                 ego_gate_pos=lead_x[:, 0:3].float())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        f_dist = torch.where(is_leader[:, None, None], f_leader[grp].to(dtype), f_dist)
    # 4. one RTI update per drone
    rti = controller.RtiState(st["x_bar"], st["u_bar"], tuple(st["ipm"]))
    u0, rti, ok, _ = controller.update(cfg, rti, x, xr, ur, f_dist)
    # 4b. live recovery
    ok_tick = ok
    if mission["recover"]:
        ok_tick = ok_tick & torch.isfinite(u0).all(dim=-1)
        for leaf in (rti.x_bar, rti.u_bar, *rti.ipm):
            ok_tick = ok_tick & torch.isfinite(leaf).reshape(-1, leaf.shape[-1]).all(dim=0)
        keep = ok_tick
        *duals, mu = rti.ipm
        zero = torch.zeros((), dtype=mu.dtype, device=dev)
        ipm = tuple(torch.where(keep, d, zero) for d in duals) + (
            torch.where(ok_tick, mu, -torch.ones_like(mu)),)
        rti = controller.RtiState(torch.where(keep, rti.x_bar, controller.pack(xr)),
                                  torch.where(keep, rti.u_bar, controller.pack(ur)), ipm)
        hold_u = torch.zeros(4, dtype=dtype, device=dev)
        hold_u[3] = veh.gravity
        u0 = torch.where(ok_tick[:, None], u0, hold_u)
    # 5. throttle and the estimator
    est = st["est"]
    throttle = throttle_from_collective(u0[:, 3], est.x[..., 1], veh.mass)
    if in_hold or finished:
        est, _ = hover_throttle_update(est, x[:, 5], throttle, est_p)
    # 6. the plant with the true downwash inside each formation
    f_ext = pairwise_downwash(x_grp).reshape(D, 3).to(dtype) if mission["true_downwash"] \
        else torch.zeros((D, 3), dtype=dtype, device=dev)
    plant = plant_step(PlantState(x, st["w_act"], st["c_act"]), u0[:, 0:3], throttle, f_ext,
                       ocp.ts_nmpc, veh, p.sim)
    # 7. tracking sums
    pos_err2, yaw_err2, form_err2 = st["pos_err2"], st["yaw_err2"], st["form_err2"]
    if not in_hold:
        fo_t = eval_traj(traj, t)
        lead_tgt = fo_t.pos[None].to(dtype) + anch[grp]
        pos_tgt = torch.where(is_leader[:, None], lead_tgt, xr[:, 0, 0:3])
        yaw_tgt = torch.where(is_leader, fo_t.yaw.to(dtype), quat_yaw(xr[:, 0, 6:10]))
        pos_err2 = pos_err2 + torch.sum((pos_tgt - x[:, 0:3]) ** 2, dim=-1)
        yaw_err2 = yaw_err2 + torch.rad2deg(yaw_tgt - quat_yaw(x[:, 6:10])) ** 2
        form_err2 = form_err2 + torch.sum((xr[:, 0, 0:3] - x[:, 0:3]) ** 2, dim=-1)
    return dict(x=plant.x, w_act=plant.w_act, c_act=plant.c_act, x_bar=rti.x_bar,
                u_bar=rti.u_bar, ipm=rti.ipm, est=est, lpf_offset=lpf, prev_ref_x=xr,
                prev_ref_u=ur, hold_xr=st["hold_xr"], hold_ur=st["hold_ur"],
                pos_err2=pos_err2, yaw_err2=yaw_err2, form_err2=form_err2,
                u0=u0, throttle=throttle, ok_tick=ok_tick)


def init_state(cfg: dict, traj, anchors: torch.Tensor, jitter: torch.Tensor) -> dict:
    """The sampled formations' state before the first tick, as the port's
    `init_fn` builds it (leader at the trajectory's start at its anchor,
    followers at the reference's offsets, hold references at the current
    state, the controller reset to them with cold duals), each drone then
    moved by the benchmark's seeded `jitter` (D, 3)."""
    from .hover_throttle import hover_throttle_init
    from .plant import plant_init
    from .quadrotor import hover_state
    from .refgen import gen_fix_pt_ref

    p = from_config(cfg)
    G = int(cfg["mission"]["drones_per_formation"])
    dtype, dev = torch.float32, anchors.device
    anch = anchors.to(dtype)
    S = anch.shape[0]
    D = S * G
    fo0 = eval_traj(traj, 0.0)
    lead_x0 = hover_state(fo0.pos.to(dtype)[None] + anch)
    own = torch.cat([lead_x0[:, 0:3] - anch, lead_x0[:, 3:]], dim=-1)
    offsets0 = reference_formation_offsets(own, n_drones=G).reshape(D, 3).to(dtype)
    x0 = lead_x0.repeat_interleave(G, dim=0)
    x0 = torch.cat([x0[:, 0:3] + offsets0, x0[:, 3:]], dim=-1)
    xr0, ur0 = gen_fix_pt_ref(x0, p.ocp, p.vehicle)
    plant = plant_init(x0, p.vehicle)
    rti = controller.reset(xr0, ur0)
    z = lambda: torch.zeros(D, dtype=dtype, device=dev)
    return dict(
        x=torch.cat([plant.x[:, 0:3] + jitter, plant.x[:, 3:]], dim=-1), w_act=plant.w_act,
        c_act=plant.c_act, x_bar=rti.x_bar, u_bar=rti.u_bar, ipm=rti.ipm,
        est=hover_throttle_init(p.estimator, batch=(D,), dtype=dtype, device=dev),
        lpf_offset=offsets0, prev_ref_x=xr0, prev_ref_u=ur0, hold_xr=xr0, hold_ur=ur0,
        pos_err2=z(), yaw_err2=z(), form_err2=z(),
        ok_all=torch.ones(D, dtype=torch.bool, device=dev))
