"""Frozen copy of `ndp_nmpc_qd_tpu_torch/traj/refgen.py` (the benchmark's plain
reference; it imports nothing of the port). Its original docstring:

NMPC reference generation: port of `ndp_nmpc_qd_tpu/traj/refgen.py`.

Each control step evaluates the trajectory at t + j th_pred for j = 0..N in
one call: the ideal-timing limit of the reference's 101-point long list
(`pt_pub/pt_publisher.py:62-103`).
"""

from __future__ import annotations

import torch

from .params import OcpParams, VehicleParams
from .flatness import diff_flatness
from .polyopt import PiecewisePoly, eval_traj


def gen_fix_pt_ref(x_now: torch.Tensor, ocp: OcpParams, vehicle: VehicleParams):
    """Hold-position reference from the current state
    (`NMPCRefPublisher.gen_fix_pt_ref`, `pt_publisher.py:40-55`), quirk
    included: every node's state reference is the current state, and the
    collective reference is mass * gravity (a force where the model takes an
    acceleration). Returns new tensors (xr (..., N+1, 10), ur (..., N, 4))."""
    batch = tuple(x_now.shape[:-1])
    xr = x_now[..., None, :].expand(batch + (ocp.N_node + 1, 10)).clone()
    ur = torch.zeros(batch + (ocp.N_node, 4), dtype=x_now.dtype, device=x_now.device)
    ur[..., 3] = vehicle.mass * vehicle.gravity
    return xr, ur


def nmpc_refs(traj: PiecewisePoly, t, ocp: OcpParams, vehicle: VehicleParams):
    """References of all shooting nodes at controller time t (a Python float
    or a tensor, in the trajectory's dtype): flat outputs at t + j th_pred,
    j = 0..N, through differential flatness. Returns (xr (..., N+1, 10),
    ur (..., N, 4)); a stacked trajectory adds its leading axis."""
    dt, dev = traj.t_seg.dtype, traj.t_seg.device
    offsets = torch.arange(ocp.N_node + 1, dtype=dt, device=dev) * ocp.th_pred
    t_nodes = (offsets + t) if isinstance(t, (int, float)) else t.to(dt)[..., None] + offsets
    if traj.t_cum.dim() == 2 and t_nodes.dim() == 1:
        t_nodes = t_nodes.expand(traj.t_cum.shape[0], -1)
    fs = diff_flatness(eval_traj(traj, t_nodes), mass=vehicle.mass, gravity=vehicle.gravity)
    return fs.x, fs.u[..., : ocp.N_node, :]


def traj_progress(traj: PiecewisePoly, t):
    """(percent complete, finished): the action-feedback quantities
    (`nmpc_node.py:174-181`, `base_pt_publisher.py:93-96`)."""
    t_all = traj.t_cum[-1]
    t = torch.as_tensor(t, dtype=t_all.dtype, device=t_all.device)
    return torch.clamp(t / t_all, 0.0, 1.0), t >= t_all
