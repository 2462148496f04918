"""One process a card: the port's counterpart of JAX driving every local
device from one process.

JAX's `parallel/mesh.py:make_mesh` spans `jax.devices()` and
`parallel/batch_step.py:measure_sharded_row` takes "all local devices" by
default. On torch.distributed one process drives one card, so a program
that should run on every card of the host is started once a card:

    from ndp_nmpc_qd_tpu_torch.parallel.launch import spawn
    rows = spawn(fn, args=(...,))          # one rank a card, results in rank order
    rows = spawn(fn, 2, device="cpu")      # two gloo ranks on the CPU

or, for a script, like `torchrun`:

    python -m ndp_nmpc_qd_tpu_torch.parallel.launch --nproc 4 script.py [args...]

`spawn` starts `nprocs` processes (by default `torch.cuda.device_count()`),
each with RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE and a coordinator
on 127.0.0.1 at a free port (MASTER_ADDR, MASTER_PORT); each joins the
process group by `distributed.initialize` on its own card (NCCL) or, with
`device="cpu"`, over gloo, calls `fn(*args)`, leaves the group and sends
its result back: the caller gets them in rank order. A rank that raises or
exits non-zero fails the whole launch with that rank's traceback; the
other ranks are killed once the launch's timeout has passed. More ranks
than cards, or no card without `device="cpu"`, raises before anything
starts: nothing falls back to one rank.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import time
import traceback

import torch

from .. import resolve_device
from . import distributed


class LaunchError(RuntimeError):
    """A rank of a launch failed; the message carries its traceback."""


def world_size(nprocs: int | None, device=None) -> int:
    """The ranks a launch starts: `nprocs`, by default one a card. Raises
    without a card unless `device="cpu"`, for more ranks than cards, and for
    CPU ranks without a count."""
    if device is None:
        resolve_device(None)
        cards = torch.cuda.device_count()
        n = cards if nprocs is None else int(nprocs)
        if n > cards:
            raise ValueError(f"{n} ranks asked for, {cards} card(s) on this host: "
                             "one process a card")
    else:
        if torch.device(device).type != "cpu":
            raise ValueError(f"device is None (one rank a card) or 'cpu', not {device!r}")
        if nprocs is None:
            raise ValueError("CPU ranks need a count (nprocs)")
        n = int(nprocs)
    if n < 1:
        raise ValueError(f"a launch needs at least one rank, got {n}")
    return n


def rank_env(rank: int, world: int, port: int, cpu: bool = False) -> dict:
    """The variables a rank of this host's launch sees (NDP_DIST_DEVICE
    "cpu" for CPU ranks: `distributed.initialize()` then joins over gloo)."""
    env = {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    return env | ({"NDP_DIST_DEVICE": "cpu"} if cpu else {})


def _rank_main(rank, world, port, device, timeout_s, fn, args, results):
    """A spawned rank: join, run, leave, send (rank, ok, result or traceback)."""
    os.environ.update(rank_env(rank, world, port, device is not None))
    try:
        distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=world,
                               process_id=rank, device=device, timeout_s=timeout_s)
        out = fn(*args)
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - the launcher reports every way a rank ends
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # the group may hang in its teardown with a peer gone
    results.put((rank, True, out))


def _stop(procs, deadline: float) -> list:
    """Wait for the processes until `deadline`, then kill what is left;
    returns the ranks killed."""
    killed = []
    for rank, p in enumerate(procs):
        p.join(max(deadline - time.monotonic(), 0.0))
        if p.is_alive():
            p.kill()
            p.join()
            killed.append(rank)
    return killed


def spawn(fn, nprocs: int | None = None, *, device=None, args=(), timeout_s: float = 600.0):
    """Run `fn(*args)` on `nprocs` ranks, one process each (default one a
    card), and return the results in rank order.

    `fn` and `args` must pickle (a function of an importable module; the
    processes are started by `multiprocessing`'s "spawn"), and so must the
    results: return host values (numbers, numpy arrays), not card tensors.
    `device="cpu"` runs gloo ranks on the CPU. `timeout_s` bounds the
    launch and each rank's collectives. A rank that raises, or exits
    without a result, raises LaunchError with its traceback; the others
    are killed when the timeout has passed.
    """
    n = world_size(nprocs, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = distributed.free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, n, port, device, timeout_s, fn, tuple(args), results))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    got, failure = {}, None
    try:
        for p in procs:
            p.start()
        while len(got) < n and failure is None and time.monotonic() < deadline:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in got]
                if not dead:
                    continue
                try:  # a result may still be in the pipe
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    failure = (dead[0], f"exited with code {procs[dead[0]].exitcode}, no result")
                    continue
            if ok:
                got[rank] = out
            else:
                failure = (rank, out)
    finally:
        killed = _stop(procs, deadline)
        results.close()
    if failure is not None:
        rank, why = failure
        others = f"killed {killed}" if killed else "the others ended"
        raise LaunchError(f"rank {rank} of {n} failed ({others}):\n{why}")
    if len(got) < n:
        raise LaunchError(f"{n - len(got)} of {n} ranks gave no result within {timeout_s} s "
                          f"(killed {killed})")
    return [got[r] for r in range(n)]


def main(argv=None) -> int:
    """`python -m ndp_nmpc_qd_tpu_torch.parallel.launch --nproc N script.py
    [args...]`: the script once a rank, with the variables of `rank_env`
    (so `distributed.initialize()` finds its coordinator, world size and
    rank). Returns the first failing rank's exit code, else 0."""
    ap = argparse.ArgumentParser(prog="python -m ndp_nmpc_qd_tpu_torch.parallel.launch",
                                 description="Run a script once a local card (one process a rank).")
    ap.add_argument("--nproc", type=int, default=None, help="ranks (default: one a card)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks: the script's initialize() joins over gloo")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before the ranks left are killed")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    n = world_size(args.nproc, "cpu" if args.cpu else None)
    port = distributed.free_port()
    procs = [subprocess.Popen([sys.executable, args.script, *args.script_args],
                              env=dict(os.environ, **rank_env(r, n, port, args.cpu)))
             for r in range(n)]
    deadline = time.monotonic() + args.timeout
    code = 0
    try:
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            if code == 0:
                code = next((p.returncode for p in procs if p.returncode), 0)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                code = code or 124
    return code or next((p.returncode for p in procs if p.returncode), 0)


if __name__ == "__main__":
    sys.exit(main())
