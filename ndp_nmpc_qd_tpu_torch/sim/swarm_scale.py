"""Swarm-scale formation episodes: S independent leader/follower formations
(each a `three_qd_ndp_nmpc.launch` instance) in one flattened controller
batch of S * G drones.

Port of `ndp_nmpc_qd_tpu/sim/swarm_scale.py`, a configuration wrapper over
`closed_loop.make_episode(n_groups=..., anchors=...)`, which holds the
grouped semantics (per-group PredXU exchange, own-frame offsets, per-group
NDP forecast, block-diagonal wake coupling, anchored references and
metrics).
"""

from __future__ import annotations

import numpy as np

from ..params import NdpNmpcConfig
from ..traj.polyopt import PiecewisePoly
from .closed_loop import make_episode


def grid_placement(n_swarms: int, spacing: float = 12.0) -> np.ndarray:
    """(S, 3) anchors on a square grid, far enough apart that the wake
    coupling (which decays by ~3 m) and the r_horiz = 1 m NDP gate never
    couple two groups."""
    k = int(np.ceil(np.sqrt(n_swarms)))
    s = np.arange(n_swarms)
    return np.stack([spacing * (s % k), spacing * (s // k), np.zeros(n_swarms)], axis=-1)


def make_formation_swarm(
    cfg: NdpNmpcConfig,
    traj: PiecewisePoly,
    *,
    n_swarms: int,
    drones_per_swarm: int = 3,
    use_ndp: bool = True,
    downwash_params=None,
    true_downwash: bool = True,
    qp_iters: int = 12,
    hold_ticks: int = 0,
    placement: np.ndarray | None = None,
    solver_backend: str = "auto",
    solver_warm_start: bool = False,
    **episode_kwargs,
):
    """(init_fn, step_fn, run_fn) over the flat B = n_swarms *
    drones_per_swarm drone axis."""
    if placement is None:
        placement = grid_placement(n_swarms)
    return make_episode(
        cfg, traj, n_drones=n_swarms * drones_per_swarm, n_groups=n_swarms,
        anchors=placement, use_ndp=use_ndp, downwash_params=downwash_params,
        true_downwash=true_downwash, qp_iters=qp_iters, hold_ticks=hold_ticks,
        solver_backend=solver_backend, solver_warm_start=solver_warm_start,
        **episode_kwargs,
    )
