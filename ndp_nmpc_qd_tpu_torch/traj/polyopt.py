"""Closed-form minimum-snap/jerk/accel/vel piecewise-polynomial fitting.

Port of `ndp_nmpc_qd_tpu/traj/polyopt.py` (the reference's
`pt_pub/polym_optimizer.py`): per-segment normalized time in [0, 1];
waypoint interpolation at both segment ends, zero boundary derivatives
1..Nd-1 at the trajectory ends, derivative continuity 1..n-1 at interior
waypoints, one `np.linalg.solve`. Fitting runs in numpy float64 at mission
set-up (this module keeps its own copy of the fit); the `PiecewisePoly`
holds torch tensors, and `eval_traj` evaluates it in torch on the tensors'
device at any query times.
"""

from __future__ import annotations

from enum import Enum
from typing import NamedTuple

import numpy as np
import torch


class MinMethod(Enum):
    SNAP = "snap"  # ord_deriv 4 -> degree-7 polynomials
    JERK = "jerk"
    ACCEL = "acceleration"
    VEL = "velocity"


_ORD_DERIV = {MinMethod.SNAP: 4, MinMethod.JERK: 3, MinMethod.ACCEL: 2, MinMethod.VEL: 1}


def basis_row(order: int, deriv: int, t) -> np.ndarray:
    """Row of the k-th-derivative monomial basis [d^k/dt^k t^j]_{j=0..order}
    (`polym_optimizer.py:104-139`)."""
    j = np.arange(order + 1)
    coef = np.ones(order + 1)
    for d in range(deriv):
        coef *= np.maximum(j - d, 0)
    expo = np.maximum(j - deriv, 0)
    return coef * np.power(float(t), expo) * (coef > 0)


def fit_1d(wpts: np.ndarray, method: MinMethod) -> np.ndarray:
    """Fit one channel through waypoints; returns (M, order+1) coefficients
    of the square constraint system (`polym_optimizer.py:39-102`)."""
    wpts = np.asarray(wpts, dtype=np.float64)
    nd = _ORD_DERIV[method]
    n = 2 * nd - 1  # polynomial order
    m = len(wpts) - 1  # segments
    if m < 1:
        raise ValueError("need at least two waypoints")
    size = m * (n + 1)
    a = np.zeros((size, size))
    b = np.zeros(size)
    row = 0
    for i in range(m):  # p_i(0) = w_i
        a[row, i * (n + 1): (i + 1) * (n + 1)] = basis_row(n, 0, 0.0)
        b[row] = wpts[i]
        row += 1
    for i in range(m):  # p_i(1) = w_{i+1}
        a[row, i * (n + 1): (i + 1) * (n + 1)] = basis_row(n, 0, 1.0)
        b[row] = wpts[i + 1]
        row += 1
    for k in range(1, nd):  # zero boundary derivatives at the start
        a[row, 0: n + 1] = basis_row(n, k, 0.0)
        row += 1
    for k in range(1, nd):  # and at the end
        c = (n + 1) * (m - 1)
        a[row, c: c + n + 1] = basis_row(n, k, 1.0)
        row += 1
    for i in range(m - 1):  # derivative continuity at interior waypoints
        c = i * (n + 1)
        for k in range(1, n):
            a[row, c: c + n + 1] = basis_row(n, k, 1.0)
            a[row, c + n + 1: c + 2 * (n + 1)] = -basis_row(n, k, 0.0)
            row += 1
    assert row == size, (row, size)
    return np.linalg.solve(a, b).reshape(m, n + 1)


class PiecewisePoly(NamedTuple):
    """Piecewise polynomial trajectory (per-segment normalized time), the
    reference's `TrajCoefficients` message. Stacked trajectories
    (`stack_trajs`) carry one more leading axis on every field."""

    coeff_xyz: torch.Tensor  # (M, 8, 3) degree 7 per axis
    coeff_yaw: torch.Tensor  # (M, 4) degree 3
    t_seg: torch.Tensor  # (M,)
    t_cum: torch.Tensor  # (M+1,) cumulative times, t_cum[0] = 0
    final_pt: torch.Tensor  # (3,) hover point after the trajectory ends


def fit_waypoints(
    wpts_xyz, t_seg, wpts_yaw=None, *, xyz_method: MinMethod = MinMethod.SNAP,
    yaw_method: MinMethod = MinMethod.ACCEL, dtype=torch.float64, device="cpu",
) -> PiecewisePoly:
    """Fit xyz (min-snap) + yaw (min-accel) through waypoints, as
    `BasePtPublisher.__init__` does (`base_pt_publisher.py:22-26`); the
    coefficients are cast to `dtype` on `device`."""
    wpts_xyz = np.asarray(wpts_xyz, dtype=np.float64)
    t_seg = np.asarray(t_seg, dtype=np.float64)
    m = len(t_seg)
    assert wpts_xyz.shape == (m + 1, 3)
    if wpts_yaw is None:
        wpts_yaw = np.zeros(m + 1)
    cx = np.stack([fit_1d(wpts_xyz[:, k], xyz_method) for k in range(3)], axis=-1)
    cyaw = fit_1d(wpts_yaw, yaw_method)
    t_cum = np.concatenate([[0.0], np.cumsum(t_seg)])
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return PiecewisePoly(t(cx), t(cyaw), t(t_seg), t(t_cum), t(wpts_xyz[-1]))


def pad_traj(traj: PiecewisePoly, n_seg: int) -> PiecewisePoly:
    """Pad to `n_seg` segments with zero-length tail segments; a query there
    is already past the end (hover at the final point)."""
    m = traj.t_seg.shape[0]
    assert n_seg >= m, (n_seg, m)
    if n_seg == m:
        return traj
    pad = n_seg - m
    zeros = lambda a: torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return PiecewisePoly(
        torch.cat([traj.coeff_xyz, zeros(traj.coeff_xyz)]),
        torch.cat([traj.coeff_yaw, zeros(traj.coeff_yaw)]),
        torch.cat([traj.t_seg, zeros(traj.t_seg)]),
        torch.cat([traj.t_cum, traj.t_cum[-1:].expand(pad)]),
        traj.final_pt,
    )


def stack_trajs(trajs) -> PiecewisePoly:
    """Stack trajectories along a leading axis, padded to the longest
    segment count: one per drone (`launch/four_qd_nmpc.launch:1-25`)."""
    n_seg = max(int(t.t_seg.shape[0]) for t in trajs)
    padded = [pad_traj(t, n_seg) for t in trajs]
    return PiecewisePoly(*(torch.stack(f) for f in zip(*padded)))


class FlatOutputs(NamedTuple):
    """Flat outputs at query times (the reference's `TrajPt`), batched."""

    pos: torch.Tensor  # (..., 3)
    vel: torch.Tensor
    acc: torch.Tensor
    jerk: torch.Tensor
    yaw: torch.Tensor  # (...,)
    yaw_dot: torch.Tensor


def _segments(traj: PiecewisePoly, t_q):
    """Segment index of each query time, and the per-query (t_seg, t_cum,
    coeff_xyz, coeff_yaw) of its segment; a stacked trajectory pairs its
    leading axis with the queries' leading axis."""
    M = traj.t_seg.shape[-1]
    if traj.t_cum.dim() == 1:
        idx = torch.searchsorted(traj.t_cum, t_q.contiguous(), right=True) - 1
        idx = idx.clamp(0, M - 1)
        return (traj.t_seg[idx], traj.t_cum[idx], traj.coeff_xyz[idx], traj.coeff_yaw[idx])
    D = traj.t_cum.shape[0]
    q = t_q.reshape(D, -1)
    idx = (torch.searchsorted(traj.t_cum, q.contiguous(), right=True) - 1).clamp(0, M - 1)
    rows = torch.arange(D, device=idx.device)[:, None]
    shape = t_q.shape
    take = lambda a: a[rows, idx].reshape(shape + tuple(a.shape[2:]))
    return (take(traj.t_seg), take(traj.t_cum), take(traj.coeff_xyz), take(traj.coeff_yaw))


def _poly_derivs(c, tau, n_deriv):
    """c (..., n+1) coefficients; [d0, d1, ..., d_{n_deriv}] at normalized
    tau (before the 1/ts^k rescale)."""
    order = c.shape[-1] - 1
    j = torch.arange(order + 1, dtype=c.dtype, device=c.device)
    outs = []
    fall = torch.ones(order + 1, dtype=c.dtype, device=c.device)
    for k in range(n_deriv + 1):
        expo = torch.clamp(j - k, min=0)
        outs.append(torch.sum(c * fall * torch.pow(tau[..., None], expo), dim=-1))
        fall = fall * torch.clamp(j - k, min=0)
    return outs


def eval_traj(traj: PiecewisePoly, t) -> FlatOutputs:
    """Flat outputs at times t (any batch shape; for stacked trajectories a
    scalar or (D, ...) with the trajectories' axis leading), in the
    trajectory's dtype. Past
    the end: position = final_pt, vel/acc/jerk = 0, yaw = 0
    (`base_pt_publisher.py:93-96`)."""
    dt, dev = traj.t_seg.dtype, traj.t_seg.device
    # a Python time is filled on the device (as_tensor would copy it there)
    t = torch.full((), t, dtype=dt, device=dev) if isinstance(t, (int, float)) else t.to(dt)
    stacked = traj.t_cum.dim() == 2
    t_all = traj.t_cum[..., -1]
    if stacked:  # t: a scalar, or (D, ...) with the trajectories' D leading
        if t.dim() == 0:
            t = t.expand(traj.t_cum.shape[0])
        t_all = t_all.reshape((-1,) + (1,) * (t.dim() - 1))
    finished = t >= t_all
    t_q = torch.minimum(torch.clamp(t, min=0.0), t_all)
    t_seg, t_cum, cxyz, cyaw = _segments(traj, t_q)
    ts = torch.where(t_seg > 0, t_seg, torch.ones_like(t_seg))
    tau = (t_q - t_cum) / ts

    d_xyz = _poly_derivs(torch.movedim(cxyz, -1, 0), tau, 3)  # each (3, ...)
    d_yaw = _poly_derivs(cyaw, tau, 1)
    inv_ts = 1.0 / ts
    pos = torch.movedim(d_xyz[0], 0, -1)
    vel = torch.movedim(d_xyz[1], 0, -1) * inv_ts[..., None]
    acc = torch.movedim(d_xyz[2], 0, -1) * (inv_ts ** 2)[..., None]
    jerk = torch.movedim(d_xyz[3], 0, -1) * (inv_ts ** 3)[..., None]
    yaw = d_yaw[0]
    yaw_dot = d_yaw[1] * inv_ts

    fin = finished[..., None]
    final = traj.final_pt if not stacked else traj.final_pt.reshape(
        (-1,) + (1,) * (t.dim() - 1) + (3,))
    zero = torch.zeros((), dtype=dt, device=dev)
    return FlatOutputs(
        torch.where(fin, final, pos), torch.where(fin, zero, vel),
        torch.where(fin, zero, acc), torch.where(fin, zero, jerk),
        torch.where(finished, zero, yaw), torch.where(finished, zero, yaw_dot),
    )
