"""Shard the REAL closed-loop episode over a (data, swarm) mesh of ranks.

Port of `ndp_nmpc_qd_tpu/parallel/episode.py` on torch.distributed.
`sim/closed_loop.py` is the product: controller + estimator + plant +
one-tick-delayed PredXU exchange + r_horiz-gated NDP forecast per 50 Hz
tick. This module runs THAT program over many ranks:

- mesh axis "data": independent scenarios (episode instances), each rank
  its own block of them;
- mesh axis "swarm": the drone axis WITHIN one episode. `make_episode` is
  built with `swarm_axis_name="swarm"`, so every cross-drone dependency
  (the leader's state and previous horizon, the PredXU hop,
  `nmpc_node.py:116-133`; the NDP companion horizon,
  `ndp_nmpc_leader_node.py:60-76`; the plant-side wake coupling) becomes
  an all_gather over the rank's swarm group.

The port's episode has no scenario axis (its state is (D, ...), the mission
clock on the host), so each rank runs its S / n_data scenarios one after
another, each a whole `run_fn`. Every rank of a swarm group runs as many
scenarios as the others, so their collectives line up.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sim.closed_loop import make_episode
from .mesh import Mesh, make_mesh, register, registered, tree_map


def _local_drones(a, rows: slice):
    return a[rows] if isinstance(a, torch.Tensor) and a.dim() else a


def make_sharded_episode(
    cfg,
    traj,
    mesh: Mesh | None = None,
    *,
    n_drones: int,
    scenario_batch: int,
    record_traces: bool = False,
    **episode_kwargs,
):
    """Build (init_fn, run_fn) for the full episode sharded over `mesh`
    (default: the (data, swarm) mesh last built, else a new `make_mesh()`),
    on this rank's block: scenarios `i0:i1` of its data coordinate and
    drones `j0:j1` of its swarm coordinate.

    init_fn(dtype=torch.float32, perturb=None) -> EpisodeState whose
      per-drone leaves are (S_l, D_l, ...) and whose 0-d leaves are (S_l,)
      (the tick counters stay host ints). `perturb`: optional GLOBAL
      (S, D, 3) position offsets, this rank's block added to the initial
      plant positions so that scenarios differ.
    run_fn(state, n_ticks) -> (state, metrics, traces): each local scenario
      a whole `run_fn` of the episode, the results stacked: per-drone
      metrics (S_l, D_l), `recovered` (S_l,) (replicated over swarm), traces
      (S_l, T, D_l, ...) or None.
    """
    mesh = (registered(("data", "swarm")) or make_mesh()) if mesh is None else register(mesh)
    n_sw, n_data = mesh.shape["swarm"], mesh.shape["data"]
    if n_drones % n_sw or scenario_batch % n_data:
        raise ValueError(f"{scenario_batch} scenarios of {n_drones} drones do not split over a "
                         f"(data {n_data}, swarm {n_sw}) mesh")
    scen = mesh.block("data", scenario_batch)
    drones = mesh.block("swarm", n_drones)
    S_l = scen.stop - scen.start

    init_fn, _, run_fn = make_episode(
        cfg, traj, n_drones=n_drones, record_traces=record_traces, swarm_axis_name="swarm",
        swarm_shards=n_sw, device=mesh.device, **episode_kwargs,
    )

    def init_sharded(dtype=torch.float32, perturb=None):
        st = tree_map(lambda a: _local_drones(a, drones), init_fn(dtype=dtype))
        st = tree_map(lambda a: a[None].expand((S_l,) + a.shape).clone()
                      if isinstance(a, torch.Tensor) else a, st)
        if perturb is not None:
            p = torch.as_tensor(np.asarray(perturb)[scen, drones], dtype=dtype,
                                device=mesh.device)
            x = st.plant.x
            st = st._replace(plant=st.plant._replace(
                x=torch.cat([x[..., 0:3] + p, x[..., 3:]], dim=-1)))
        return st

    def run_sharded(state, n_ticks: int):
        outs = [run_fn(tree_map(lambda a: a[s] if isinstance(a, torch.Tensor) else a, state),
                       n_ticks) for s in range(S_l)]
        stack = lambda *xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0]
        return tuple(tree_map(stack, *parts) for parts in zip(*outs))

    return init_sharded, run_sharded
