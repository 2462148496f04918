"""Multi-device scale-out: scenario and swarm sharding over a grid of ranks.

Port of `ndp_nmpc_qd_tpu/parallel/mesh.py` on torch.distributed. The JAX
package shards over a device mesh with `shard_map`; here every rank is one
process with one device, and holds only its own block (the SPMD idiom):

- axis "data": independent NMPC scenarios (swarm instance x disturbance
  sample), the scale-out dimension;
- axis "swarm": the drones of one swarm instance. The cross-drone state
  exchange (the PredXU topic) becomes an all_gather along this axis, over
  the process group of the rank's row of the grid.

A `Mesh` is the (data, swarm) grid of ranks, this rank's coordinates in
it, and one process group for each axis (`dist.new_group`, made on every
rank in the same order). The mesh last built is kept here by its axis
names, so that `sim.closed_loop.make_episode(swarm_axis_name=...)` finds
its group by the name alone, as `jax.lax.all_gather` finds a mesh axis.
With one process and no process group, each group is None and every
collective is the identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..sim.downwash_truth import analytic_downwash
from .distributed import local_device, process_count, process_index


class Mesh:
    """A grid of ranks with named axes, this rank's coordinates, the device
    it drives and a process group per axis (None with one process and no
    process group). `shape` maps each axis name to its size, as the JAX
    mesh's does."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple, device: torch.device, groups: dict):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = device
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                                                 np.argwhere(ranks == process_index())[0])))
        self.groups = groups

    def block(self, axis: str, n: int) -> slice:
        """This rank's block of `n` rows split evenly along `axis`."""
        k = self.shape[axis]
        if n % k:
            raise ValueError(f"{n} rows do not split over the {k} ranks of axis {axis!r}")
        i0 = self.coords[axis] * (n // k)
        return slice(i0, i0 + n // k)


_meshes: dict = {}  # axis name -> the mesh last built or registered with that axis


def register(mesh: Mesh) -> Mesh:
    """Make `mesh` the one its axis names resolve to."""
    for name in mesh.axis_names:
        _meshes[name] = mesh
    return mesh


def mesh_of_axis(name: str) -> Mesh:
    """The mesh an axis name resolves to; a ValueError naming the axis when
    none has it (a sharded program must never run unsharded in silence)."""
    if name not in _meshes:
        raise ValueError(f"no mesh has an axis named {name!r}: build one with make_mesh or "
                         "make_global_mesh (parallel.mesh) first")
    return _meshes[name]


def registered(axis_names: tuple) -> Mesh | None:
    """The mesh kept for exactly these axis names, if one was built or
    registered: the default of the sharded programs, so that a rank which
    builds many of them makes its process groups once."""
    mesh = _meshes.get(axis_names[-1])
    return mesh if mesh is not None and mesh.axis_names == tuple(axis_names) else None


def release_meshes() -> None:
    _meshes.clear()


def build_mesh(ranks, axis_names, device: torch.device) -> Mesh:
    """A mesh over the grid `ranks` (every rank of the world, each once):
    with a process group, one subgroup per line of each axis, made by every
    rank in the same order; with one process and none, no group."""
    ranks = np.asarray(ranks)
    world = process_count()
    if sorted(ranks.reshape(-1).tolist()) != list(range(world)):
        raise ValueError(f"a mesh spans every rank once: {ranks.tolist()} over a world of {world}")
    groups = {name: None for name in axis_names}
    if dist.is_initialized():
        me = process_index()
        for k, name in enumerate(axis_names):
            lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[name] = group
    return register(Mesh(ranks, axis_names, device, groups))


def make_mesh(n_devices: int | None = None, swarm_axis: int = 1, device=None) -> Mesh:
    """Mesh over (data, swarm): `swarm_axis` ranks cooperate on one swarm
    instance, the rest scale out scenarios. It spans every rank
    (`n_devices`, default the world size, must be it): rank r sits at
    (r // swarm_axis, r % swarm_axis). Each rank drives `device`, by default
    its card (`distributed.local_device`)."""
    n = n_devices or process_count()
    if n != process_count():
        raise ValueError(f"a mesh spans every rank: n_devices={n}, world {process_count()}")
    if n % swarm_axis:
        raise ValueError(f"{n} ranks do not split into swarm groups of {swarm_axis}")
    return build_mesh(np.arange(n).reshape(n // swarm_axis, swarm_axis), ("data", "swarm"),
                      local_device(device))


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The blocks of `t` of every rank along `axis`, concatenated along
    `dim` in rank order (the identity without a process group)."""
    group = mesh.groups[axis]
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.shape[axis] * src.shape[0],) + src.shape[1:], dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced by `op` over the ranks along `axis`, in place (the
    identity without a process group)."""
    group = mesh.groups[axis]
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def barrier(mesh: Mesh, axis: str) -> None:
    group = mesh.groups[axis]
    if group is None:
        return
    if mesh.device.type == "cuda":
        dist.barrier(group=group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=group)


def tree_map(fn, *trees):
    """`fn` over the leaves of equally shaped trees of (named) tuples and
    lists; None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *kids) for kids in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *kids) for kids in zip(*trees))
    return fn(*trees)


def shard_scenarios(mesh: Mesh, tree):
    """This rank's block of a tree of global tensors with a leading scenario
    axis: its rows along 'data' (the same on every rank of a swarm group),
    on the mesh's device; 0-d tensors and other leaves as they are."""

    def cut(a):
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            return a
        return a[mesh.block("data", a.shape[0])].to(mesh.device).clone()

    return tree_map(cut, tree)


def make_sharded_swarm_step(cfg, ctl, mesh: Mesh, downwash_params=None):
    """One swarm control tick with drones sharded over 'swarm' and scenarios
    over 'data'.

    Each rank owns a (scenario block, drone block). Per tick:
    1. all_gather every drone's current state along the swarm axis: the
       collective form of the PredXU pub/sub hop (`nmpc_node.py:116-133`),
    2. the downwash forces its LOCAL drones receive from ALL drones (the
       gathered states; the MLP `downwash_params` if given, else the
       analytic model), each drone's force on itself masked,
    3. follower references = leader horizon (replicated input) + offsets,
    4. one batched RTI solve of the S_local * D_local drones (`ctl`, a
       batch-first controller of `make_batched_rti_controller`: the JAX
       package's vmap over both axes, flattened),
    5. all_reduce SUM of the health flags over the swarm axis: a
       per-scenario count.

    Returns step(rti_state, x0, leader_xr, leader_ur, offsets) -> (u0,
    new_state, n_ok) on this rank's blocks: rti_state leaves (S_l, D_l,
    ...), x0 (S_l, D_l, 10), leader_xr (S_l, N+1, 10), leader_ur (S_l, N,
    4), offsets (S_l, D_l, 3); u0 (S_l, D_l, 4), n_ok (S_l,) over the whole
    swarm.
    """
    if ctl.layout != "batch":
        raise ValueError("kernel-layout state folds the drone axis into the batch lanes; "
                         "the sharded swarm step needs a batch-first controller")
    N = cfg.ocp.N_node

    def step(rti, x0, xr_lead, ur_lead, offsets):
        S, Dl = x0.shape[:2]
        # 1. the PredXU hop as a collective: every drone's state
        x_all = all_gather(mesh, "swarm", x0, dim=1)  # (S, D, 10)
        # 2. the downwash on the local drones from every gathered drone
        rel = x_all[:, None, :, 0:6] - x0[:, :, None, 0:6]  # (S, Dl, D, 6)
        if downwash_params is not None:
            with torch.no_grad():
                f_pair = downwash_params(rel)
        else:
            f_pair = analytic_downwash(rel)
        self_mask = (rel == 0.0).all(dim=-1, keepdim=True)
        f_pair = torch.where(self_mask, torch.zeros((), dtype=f_pair.dtype,
                                                    device=f_pair.device), f_pair)
        f_now = f_pair.sum(dim=2)  # (S, Dl, 3)
        f_dist = f_now[:, :, None, :].expand(S, Dl, N + 1, 3)
        # 3. follower references from the (replicated) leader horizon
        lead = xr_lead[:, None].expand((S, Dl) + xr_lead.shape[1:])
        xr = torch.cat([lead[..., 0:3] + offsets[:, :, None, :], lead[..., 3:]], dim=-1)
        ur = ur_lead[:, None].expand((S, Dl) + ur_lead.shape[1:])
        # 4. one batched solve of the local drones
        flat = lambda a: a.reshape((S * Dl,) + a.shape[2:])
        u0, new, info = ctl.update(tree_map(flat, rti), flat(x0), flat(xr), flat(ur),
                                   flat(f_dist))
        unflat = lambda a: a.reshape((S, Dl) + a.shape[1:])
        # 5. swarm-wide health
        n_ok = all_reduce(mesh, "swarm", info.ok.reshape(S, Dl).sum(dim=1))
        return unflat(u0), tree_map(unflat, new), n_ok

    return step
