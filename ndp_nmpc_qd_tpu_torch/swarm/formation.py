"""Formation semantics: leader/follower offsets and their low-pass filter.

Port of `ndp_nmpc_qd_tpu/swarm/formation.py`: the leader's switching offset
rule (`nmpc_leader_node.py:37-46` / `ndp_nmpc_leader_node.py:49-58`), the
followers' alpha filter rate-converted to the control period
(`nmpc_follower_node.py:33,44-56`) and the PredXU horizon offsetting
(`nmpc_follower_node.py:58-75`), as tensor ops along the drone axis.
"""

from __future__ import annotations

import math

import torch

from .. import const


def reference_formation_offsets(leader_x: torch.Tensor, n_drones: int) -> torch.Tensor:
    """The reference's switching offsets, generalized to D drones.

    Drone 0 is the leader (offset 0). Drones 1 ("xiao_feng") and 2
    ("smile_boy") follow `pub_formation_ref_callback`: when
    |leader_x - 1| > 2, xf = (0, 0, 0.5), sb = (0, -1, 0); else xf =
    (0, 1, 0), sb = (0, -1, 0). More drones stack in -y. Returns
    (..., D, 3)."""
    dt, dev = leader_x.dtype, leader_x.device
    far = torch.abs(leader_x[..., 0] - 1.0) > 2.0
    xf = torch.where(far[..., None], const((0.0, 0.0, 0.5), dt, dev),
                     const((0.0, 1.0, 0.0), dt, dev))
    rows = [torch.zeros_like(xf), xf]
    for k in range(2, n_drones):
        rows.append(const((0.0, -(k - 1.0), 0.0), dt, dev).expand(xf.shape))
    return torch.stack(rows[:n_drones], dim=-2)


def rate_converted_alpha(alpha_src: float, ts_src: float, ts_dst: float) -> float:
    """Map a first-order filter coefficient between update rates by matching
    the continuous time constant tau = -ts / ln(alpha)."""
    return float(math.exp(math.log(alpha_src) * ts_dst / ts_src))


def offset_references(leader_xr: torch.Tensor, leader_ur: torch.Tensor, offsets: torch.Tensor):
    """Follower references: the leader's published horizon (N+1, 10) plus
    each filtered offset (D, 3) in position (`nmpc_follower_node.py:63-71`);
    controls copied. Returns (xr (D, N+1, 10), ur (D, N, 4))."""
    D = offsets.shape[0]
    xr = leader_xr.expand((D,) + tuple(leader_xr.shape)).clone()
    xr[..., 0:3] += offsets[:, None, :]
    return xr, leader_ur.expand((D,) + tuple(leader_ur.shape)).clone()
