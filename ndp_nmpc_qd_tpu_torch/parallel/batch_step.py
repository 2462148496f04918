"""Shard the flagship scenario-batch control step over the ranks of a
1-D "data" mesh.

Port of `ndp_nmpc_qd_tpu/parallel/batch_step.py` on torch.distributed. The
controller is embarrassingly parallel along the scenario axis (the
reference's scale-out analog is one ROS node process per drone,
`launch/three_qd_nmpc_formation.launch:3-14`): each rank runs ANY
control-step closure on its own block of the scenarios, so `bench_torch.py`
measures solves/s, solves/s per device and the scaling efficiency on
however many ranks there are. One rank runs the same code on the whole
batch.

The batch axis of a leaf comes from the state's type, never from its size:
the leaves of an `RtiState` lie on the controller's layout, batch-first
(B, ...) on dim 0 or the kernel layout (stage, element, B) on the last dim
(`layout="kernel"`, `packed_state=True`; mu (B,) too); every other leaf is
batch-first; 0-d leaves are replicated. The port packs no lane block, so a
batch shards wherever it divides over the ranks.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..solver.rti import RtiState
from .distributed import local_device, process_count
from .mesh import Mesh, all_gather, all_reduce, barrier, build_mesh, registered, tree_map


def data_mesh(devices=None, device=None) -> Mesh:
    """The 1-D "data" mesh over the ranks `devices` (default all of them, in
    order), each rank driving `device` (by default its card)."""
    ranks = list(range(process_count())) if devices is None else list(devices)
    return build_mesh(ranks, ("data",), local_device(device))


def _default(mesh: Mesh | None) -> Mesh:
    """`mesh`, else the "data" mesh last built, else a new `data_mesh()`."""
    return mesh or registered(("data",)) or data_mesh()


def _batch_dims(tree, layout: str):
    """The tree of each leaf's batch dim (None: replicated)."""

    def walk(t, in_state):
        if isinstance(t, RtiState):
            return RtiState(*(walk(k, True) for k in t))
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(k, in_state) for k in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(k, in_state) for k in t)
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return None
        return t.dim() - 1 if in_state and layout == "kernel" else 0

    return walk(tree, False)


def _global_batch(tree, dims) -> int:
    sizes = set()
    tree_map(lambda a, d: d is None or sizes.add(a.shape[d]), tree, dims)
    if len(sizes) != 1:
        raise ValueError(f"the batched leaves disagree on the batch size: {sorted(sizes)}")
    return sizes.pop()


def make_sharded_step(step_fn, mesh: Mesh | None, example_args, axis: str = "data",
                      layout: str = "batch"):
    """`step_fn(*args)` on this rank's block of the scenario axis.

    Returns (sharded_fn, place): `place(args)` cuts this rank's block out of
    global tensors of the example's batch (a copy on the mesh's device, so
    steps that update their state in place never write the caller's
    tensors); `sharded_fn` is `step_fn` itself, run on such local blocks
    and returning local blocks, so a state chains from tick to tick on its
    rank. `layout` is the controller's (`ctl.layout`): where the leaves of
    an `RtiState` carry their batch. `mesh` defaults to the "data" mesh
    last built, else a new `data_mesh()`.
    """
    mesh = _default(mesh)
    dims = _batch_dims(tuple(example_args), layout)
    B = _global_batch(tuple(example_args), dims)
    n = mesh.shape[axis]
    if B % n:
        raise ValueError(f"B={B} not block-divisible over {n} devices")
    rows = mesh.block(axis, B)

    def place(args):
        def cut(a, d):
            if d is None:
                return a
            return a.narrow(d, rows.start, rows.stop - rows.start).to(mesh.device).clone(
                memory_format=torch.contiguous_format)

        args = tuple(args)
        dims = _batch_dims(args, layout)
        got = _global_batch(args, dims)
        if got != B:
            raise ValueError(f"place cuts blocks of a batch of {B} scenarios, got {got}")
        return tree_map(cut, args, dims)

    return step_fn, place


def gather(mesh: Mesh, tree, axis: str = "data", layout: str = "batch"):
    """Every rank's blocks of a tree, concatenated along each leaf's batch
    dim into global tensors on every rank (for checks: the sharded step
    itself never gathers)."""
    return tree_map(lambda a, d: a if d is None else all_gather(mesh, axis, a, d),
                    tree, _batch_dims(tree, layout))


def measure_sharded_row(
    step_fn,
    args0,
    *,
    B: int,
    single_sps: float,
    iters: int = 30,
    mesh: Mesh | None = None,
    packed_state: bool = False,
):
    """Measure the sharded row of `bench_torch.py` on `mesh` (default: the
    "data" mesh last built, else one over all ranks) and return
    `(row, skip_reason)`, exactly one of them None.

    `step_fn(state, *rest) -> (u0, new_state, info)` is the control-step
    contract (`bench_torch.control_step`); `args0 = (state, *rest)` the
    global example inputs, the state in kernel layout with
    `packed_state=True`. The row has the JAX package's schema: `n_devices`,
    `B_global`, `solves_per_s`, `solves_per_s_per_device`,
    `scaling_efficiency_vs_single` (against `single_sps`, one device's
    solves/s), `ok` (summed over the ranks). A batch that does not divide
    over the ranks is skipped with its reason.

    Every rank runs one warm-up step, then `iters` chained steps between a
    synchronisation of its device plus a barrier and a synchronisation of
    its device; the slowest rank's time sets the step (all_reduce MAX).
    """
    mesh = _default(mesh)
    nd = mesh.shape["data"]
    if B % nd:
        return None, f"B={B} not block-divisible over {nd} devices (the port packs no lane block)"
    sfn, place = make_sharded_step(step_fn, mesh, args0,
                                   layout="kernel" if packed_state else "batch")
    state, *rest = place(tuple(args0))
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    u0, state, info = sfn(state, *rest)
    sync()
    barrier(mesh, "data")
    t0 = time.perf_counter()
    for _ in range(iters):
        u0, state, info = sfn(state, *rest)
    sync()
    elapsed = torch.tensor(time.perf_counter() - t0, dtype=torch.float64, device=mesh.device)
    all_reduce(mesh, "data", elapsed, op=dist.ReduceOp.MAX)
    ok = all_reduce(mesh, "data", info.ok.sum())
    sps = B / (float(elapsed) / iters)
    row = {
        "n_devices": nd,
        "B_global": B,
        "solves_per_s": round(sps, 1),
        "solves_per_s_per_device": round(sps / nd, 1),
        "scaling_efficiency_vs_single": round(sps / (nd * single_sps), 3),
        "ok": int(ok),
    }
    return row, None
