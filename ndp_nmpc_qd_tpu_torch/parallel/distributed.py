"""Multi-process bootstrap: scenario scale-out across processes and hosts.

Port of `ndp_nmpc_qd_tpu/parallel/distributed.py` on torch.distributed. One
process is one rank and drives one device: the card `cuda:{LOCAL_RANK}`
(without LOCAL_RANK, the rank modulo the host's card count) over NCCL, or
the CPU over gloo when `device="cpu"` is asked. Each rank holds only its own
block of the scenarios and drones (the SPMD idiom); the meshes
(`parallel/mesh.py`) say which block and carry the process groups of their
axes.

Typical launch, one process per card (torch.distributed learns nothing of a
cluster by itself: the coordinator, the world size and the rank are given;
on one host `parallel/launch.py` starts the processes and gives them):

    from ndp_nmpc_qd_tpu_torch.parallel.distributed import initialize, make_global_mesh
    initialize(coordinator="10.0.0.1:8476", num_processes=8, process_id=RANK)
    mesh = make_global_mesh(swarm_axis=4)   # (data, swarm) grid of the 8 ranks
"""

from __future__ import annotations

import contextlib
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import resolve_device

_bound = {}  # "device": the device `initialize` bound this process to


def process_count() -> int:
    """The number of ranks: 1 until a process group is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _card(rank: int) -> torch.device:
    """The card of `rank`: `cuda:{LOCAL_RANK}`, else the rank modulo the
    host's card count. Raises without a card (`resolve_device`)."""
    resolve_device(None)
    index = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(index) if index is not None
                        else rank % torch.cuda.device_count())


def _concrete(device) -> torch.device:
    """`device` as given, a card without an index as the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device(None)
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_device(device=None) -> torch.device:
    """This rank's device: `device` where given (a card always with its
    index), else the one `initialize` bound, else the card of this rank.
    Without a card, and without the CPU asked for, this raises."""
    if device is not None:
        return _concrete(device)
    return _bound.get("device") or _card(process_index())


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group: the port's `jax.distributed.initialize`.

    A no-op for one process with no coordinator, as in JAX. Otherwise
    `dist.init_process_group` with `init_method="tcp://{coordinator}"`
    ("host:port", rank 0 listening there; default MASTER_ADDR:MASTER_PORT
    where both are set, as `parallel/launch.py` sets them), `num_processes`
    ranks (default WORLD_SIZE, else 1), this process's rank `process_id`
    (default RANK, else 0), a timeout of `timeout_s` seconds on every
    collective, and the backend of this rank's device: NCCL on the card,
    gloo with `device="cpu"` (or, with no device given, where
    NDP_DIST_DEVICE is "cpu", as `launch.py --cpu` sets it). The device is
    resolved before the group is joined, so without a card (and without
    the CPU asked for) this raises at once.
    """
    if device is None and os.environ.get("NDP_DIST_DEVICE") == "cpu":
        device = "cpu"
    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes in (None, 1) and coordinator is None:
        return
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator 'host:port'")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    device = _card(process_id) if device is None else _concrete(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )
    _bound["device"] = device


def shutdown() -> None:
    """Leave the process group: forget every mesh, then destroy the group
    and its subgroups. A no-op where no group was joined."""
    from .mesh import release_meshes

    release_meshes()
    _bound.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now: a coordinator's on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_group(device=None):
    """A one-rank process group for the block: its coordinator on 127.0.0.1
    at a free port, over NCCL on this rank's card (gloo with
    `device="cpu"`); every mesh and the group are gone at its end."""
    initialize(coordinator=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
               device=device)
    try:
        yield
    finally:
        shutdown()


def make_global_mesh(swarm_axis: int = 1, device=None):
    """(data, swarm) mesh over ALL ranks.

    Launchers number each host's ranks contiguously (LOCAL_WORLD_SIZE of
    them), so the data axis splits across hosts first and within hosts
    second, while a swarm axis that divides the ranks of one host stays
    inside it: the horizon exchange never leaves a host.
    """
    from .mesh import make_mesh

    n = process_count()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if per_host % swarm_axis:
        raise ValueError(
            f"a swarm axis of {swarm_axis} ranks does not stay inside one host's {per_host}"
        )
    return make_mesh(n, swarm_axis, device=device)


def process_local_batch(global_batch: int) -> int:
    """Scenarios this process should generate for an even global shard."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n} processes")
    return global_batch // n
