"""The formation campaign with its drones split over the swarm axis of
several cards (weak scaling: each rank's card flies as many formations as
one card does alone): one process a card (`parallel/launch.spawn`, NCCL),
the port's episode built with `swarm_axis_name="swarm"`, so that every
tick all-gathers the drones' states and published horizons over the ranks.
The sharded episode keeps its controller state batch-first (the
configuration's `controller_sharded`: K3 + K2 a tick).

Each rank builds its block of the episode, flies the hold and warm-up
ticks, and measures the window; rank 0 decides over a host-side gloo group,
once a tick, when the window is over, so every rank runs the same ticks.
The window of the slowest rank sets the time. Each rank keeps a seeded
sample of its own formations (a formation never straddles two ranks) and
compares them with the reference after its window; the parent process
gathers the ranks' host results, with the forbidden modules each rank
held once its window had closed.
"""

from __future__ import annotations

import time

import torch

from benchmark.drivers.formation import Formation
from benchmark.harness import compare, guard
from benchmark.harness.program import port_config, synchronize
from benchmark.reference import controller as ref_ctl


def setup(cfg, mix, seed, dev, weights, *, trace=False, chips=1, limits=None, start_wall=None,
          control=False):
    return Sharded(cfg, mix, seed, dev, weights, trace, chips, limits,
                   time.time() if start_wall is None else start_wall, control)


class Sharded:
    """The parent's side: spawns the ranks in `window` and reads their
    results."""

    def __init__(self, cfg, mix, seed, dev, weights, trace, chips, limits, start_wall, control):
        self.args = (cfg, mix, seed, weights, limits, control)
        self.start_wall = start_wall
        self.trace, self.chips, self.dev = trace, chips, dev
        self.results, self.fault = None, None

    def set_fault(self, fault):
        """A picklable `fault(cell, program) -> program` for the ranks to
        plant after their set-up (tests)."""
        self.fault = fault

    def window(self, seconds):
        from ndp_nmpc_qd_tpu_torch.parallel.launch import spawn

        cfg, mix, seed, weights, limits, control = self.args
        ticks = int(mix["trace_ticks"]) if self.trace else 0
        kw = dict(device="cpu") if self.dev.type == "cpu" else {}
        self.results = spawn(rank_run, self.chips, args=(
            cfg, mix, seed, weights, limits, control, float(seconds), ticks, self.start_wall,
            self.fault),
            timeout_s=float(mix["launch_timeout_s"]), **kw)
        r0 = self.results[0]
        slow = max(self.results, key=lambda r: r["window_s"])
        self.slowest = slow
        return dict(window_s=slow["window_s"], n_ticks=r0["n_ticks"],
                    attempted=r0["attempted"], failed=r0["failed"], solves=r0["attempted"],
                    setup_s=max(r["setup_s"] for r in self.results))

    def traced(self, n_ticks):
        return self.slowest["trace"]

    def memory_peak(self):
        return max(r["peak"] for r in self.results)

    def trace_device(self):
        """busy_s and window_s of the traced stretch, averaged over the cards."""
        trs = [r["trace"] for r in self.results]
        return (sum(t.busy_us() for t in trs) / len(trs) / 1e6,
                sum(t.window_us() for t in trs) / len(trs) / 1e6)

    def facts(self):
        return dict(batch=self.results[0]["drones"])

    def rank_modules(self):
        """The forbidden modules that any rank held once its window closed."""
        return sorted({m for r in self.results for m in r["modules"]})

    def release(self):
        pass

    def check(self, limits, control=False):
        checks = compare.Checks(limits)
        for r in self.results:
            for name, v in r["checks"].items():
                checks.add(name, v)
        return checks, dict(compared=sum(r["compared"]["compared"] for r in self.results),
                            sampled_ticks=min(r["compared"]["sampled_ticks"]
                                              for r in self.results))


def rank_run(cfg, mix, seed, weights, limits, control, seconds, trace_ticks, t0_wall,
             fault=None):
    """One rank: build, fly the set-up, measure, trace, compare. Returns
    host values."""
    import torch.distributed as dist

    from ndp_nmpc_qd_tpu_torch.parallel import distributed
    from ndp_nmpc_qd_tpu_torch.parallel.mesh import barrier, make_mesh

    world, rank = distributed.process_count(), distributed.process_index()
    mesh = make_mesh(world, swarm_axis=world)
    dev = mesh.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    stop_group = dist.new_group(backend="gloo")
    cell = RankFormation(cfg, mix, seed, dev, weights, world, rank)
    if fault is not None:
        cell.program = fault(cell, cell.program)
    barrier(mesh, "swarm")
    setup_s = time.time() - t0_wall
    flag = torch.zeros(1)

    def over(t0):
        flag[0] = float(rank == 0 and time.perf_counter() - t0 >= seconds)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=stop_group)
        return bool(flag[0] > 0)

    rec = cell.window(seconds, over=over)
    tr = cell.traced(trace_ticks) if trace_ticks else None
    synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    cell.release()
    checks, facts = cell.check(limits, control=control)
    return dict(rec, setup_s=setup_s, trace=tr, peak=peak, checks=dict(checks.values),
                compared=facts, drones=cell.D, modules=guard.forbidden_modules())


class RankFormation(Formation):
    """This rank's block of the sharded formation episode."""

    def __init__(self, cfg, mix, seed, dev, weights, world, rank):
        self.world, self.rank = world, rank
        super().__init__(cfg, mix, seed, dev, weights)

    def _build(self, traj, weights):
        from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz
        from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode

        ms, c = self.cfg["mission"], self.cfg["controller_sharded"]
        return make_episode(
            port_config(self.cfg), traj, n_drones=self.D, n_groups=self.S, anchors=self.anchors,
            use_ndp=ms["use_ndp"], downwash_params=load_npz(weights, device=self.dev),
            true_downwash=ms["true_downwash"], qp_iters=c["qp_iters"], hold_ticks=self.hold,
            solver_backend="pallas", solver_warm_start=c["warm_start"],
            solver_jac_bf16=c["jac_bf16"], solver_lqr_start=c["lqr_start"],
            solver_whole_ipm=c["whole_ipm"], solver_packed_state=c["packed_state"],
            solver_whole_step=c["whole_step"], recover=ms["recover"], record_traces=True,
            swarm_axis_name="swarm", swarm_shards=self.world, device=self.dev)

    def _local(self, st):
        """This rank's rows of the global initial state."""
        from ndp_nmpc_qd_tpu_torch.parallel.mesh import tree_map

        Dl = self.D // self.world
        d0 = self.rank * Dl
        return tree_map(lambda a: a[d0:d0 + Dl] if isinstance(a, torch.Tensor) and a.dim()
                        and a.shape[0] == self.D else a, st)

    def _pick_range(self):
        Sl = self.S // self.world
        return Sl, self.rank * Sl

    def _rti(self, rti, d):
        """Rows `d` of the batch-first controller state, in kernel layout."""
        return dict(x_bar=ref_ctl.pack(rti.x_bar[d]), u_bar=ref_ctl.pack(rti.u_bar[d]),
                    ipm=tuple(ref_ctl.pack(t[d]) if t.dim() > 1 else t[d] for t in rti.ipm))
