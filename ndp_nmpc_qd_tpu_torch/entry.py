"""The flagship step and the multi-device dry run: the port's counterparts
of the JAX package's entry points `entry` and `dryrun_multichip`.

- `entry(device=None)` -> (control_step, example_args): the batched NDP-NMPC
  control step on 8 scenarios x 3 drones, the leader's downwash forecast
  (the MLP on drone 1's horizon relative to drone 0's, gated by r_horiz)
  fused in, on the scan controller as the JAX entry runs it
  (`make_rti_controller` over both batch axes: here the batched scan
  controller over the flattened 24 rows, which is that map in one call).
- `dryrun_multichip(mesh=None)`: on this rank of a (data, swarm) mesh, the
  sharded NDP episode, the grouped formation swarm and one data-parallel
  step of the downwash MLP's trainer, with the JAX function's assertions.
  Run it on every rank of a launch (`parallel/launch.spawn`); one process
  without a process group runs it on a 1 x 1 mesh.
- `train_step_diff(dry)`: the ranks' data-parallel step against the
  one-process step on the whole batch; `multichip_rank`: the dry run and
  the deployed step's sharded row on one rank of a launch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import resolve_device
from .deployed import ASSET, sharded_row_rank
from .models.downwash_mlp import init_mlp, load_npz, make_trainer, predict_downwash
from .models.quadrotor import hover_input, hover_state
from .params import NdpNmpcConfig
from .parallel import distributed
from .parallel.mesh import Mesh, all_reduce, make_mesh, registered
from .solver.rti import RtiState, make_batched_rti_controller

SCENARIOS, DRONES = 8, 3
TRAIN_LR = 1e-3
ROWS_PER_RANK = 16


def entry(device=None, *, dtype=torch.float32):
    """The flagship forward step, 8 scenarios x 3 drones, with the downwash
    MLP (`assets/downwash_analytic_sn4.npz`) fused in, in `dtype`.

    Returns (control_step, (rti0, x0, xr, ur)): control_step(rti, x0, xr,
    ur) -> (u0 (S, D, 4), x_bar (S, D, N+1, 10), ok (S, D)), as the JAX
    entry's. The example drones hover at uniform offsets in [-1, 1] m from
    a seeded generator, the references at the origin. Runs on `device`, by
    default the card; without one it raises."""
    dev = resolve_device(device)
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    ctl = make_batched_rti_controller(cfg.ocp, cfg.vehicle, with_disturbance=True,
                                      backend="jax", device=dev)
    mlp = load_npz(ASSET, dtype=dtype, device=dev)
    S, D = SCENARIOS, DRONES
    pos = torch.rand(S, D, 3, generator=torch.Generator().manual_seed(0), dtype=dtype)
    x0 = hover_state(pos * 2.0 - 1.0).to(dev)
    xr = hover_state(torch.zeros(S, D, 3, dtype=dtype, device=dev))[:, :, None].repeat(
        1, 1, N + 1, 1)
    ur = hover_input(cfg.vehicle, (S, D), dtype=dtype, device=dev)[:, :, None].repeat(1, 1, N, 1)
    flat = lambda a: a.reshape((S * D,) + a.shape[2:])
    unflat = lambda a: a.reshape((S, D) + a.shape[1:])
    st = ctl.reset(flat(xr), flat(ur))
    rti0 = RtiState(unflat(st.x_bar), unflat(st.u_bar))

    def control_step(rti, x0, xr, ur):
        # downwash forecast: drone 0 (leader) from drone 1's horizon
        with torch.no_grad():
            f_leader = predict_downwash(mlp, xr[:, 1], xr[:, 0], r_horiz=cfg.downwash.r_horiz,
                                        ego_gate_pos=x0[:, 0, 0:3])
        f = torch.zeros(xr.shape[:-1] + (3,), dtype=xr.dtype, device=xr.device)
        f[:, 0] = f_leader
        u0, new, info = ctl.update(RtiState(flat(rti.x_bar), flat(rti.u_bar)), flat(x0),
                                   flat(xr), flat(ur), flat(f))
        return unflat(u0), unflat(new.x_bar), unflat(info.ok)

    return control_step, (rti0, x0, xr, ur)


def train_batch(n_rows: int, device=None):
    """The dry run's training batch: x (n_rows, 6) and y (n_rows, 3) standard
    normal from generators seeded 1 and 2 (the JAX dry run's keys), drawn
    on the CPU so that a seed gives the same batch on any device."""
    xb = torch.randn(n_rows, 6, generator=torch.Generator().manual_seed(1))
    yb = torch.randn(n_rows, 3, generator=torch.Generator().manual_seed(2))
    dev = resolve_device(device)
    return xb.to(dev), yb.to(dev)


def train_init(device=None):
    """The dry run's net (`init_mlp` seeded 0) and its `torch.optim.Adam` at
    lr 1e-3 (optax's `adam(1e-3)` defaults)."""
    mlp = init_mlp(torch.Generator().manual_seed(0), device=device)
    return mlp, torch.optim.Adam(mlp.parameters(), lr=TRAIN_LR)


def data_parallel_train_step(mesh: Mesh, mlp, opt, xb, yb):
    """One data-parallel step of the MSE trainer on this rank's block
    (xb, yb): the local loss and gradients, each averaged by `all_reduce`
    over "data" and then "swarm" (the JAX dry run's `pmean`s), then one Adam
    step of the replicated weights. Returns the averaged loss (before the
    step). With one rank it is `make_trainer(sn=0)`'s step on the block."""
    _, _, loss_fn = make_trainer(sn=0.0, lr=TRAIN_LR)
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(mlp, xb, yb)
    loss.backward()
    loss = loss.detach()
    for axis in ("data", "swarm"):
        n = mesh.shape[axis]
        for p in mlp.parameters():
            all_reduce(mesh, axis, p.grad).div_(n)
        all_reduce(mesh, axis, loss).div_(n)
    opt.step()
    return loss


def weights_of(mlp):
    """The net's [(weight, bias), ...] as numpy copies."""
    return [(layer.weight.detach().cpu().numpy().copy(), layer.bias.detach().cpu().numpy().copy())
            for layer in mlp.layers]


def grads_of(mlp):
    """The net's gradients [(d weight, d bias), ...] as numpy copies."""
    return [(layer.weight.grad.cpu().numpy().copy(), layer.bias.grad.cpu().numpy().copy())
            for layer in mlp.layers]


def train_step_diff(dry, device=None) -> dict:
    """The ranks' data-parallel step (`dry`: every rank's `dryrun_multichip`
    result, in rank order) against `make_trainer(sn=0)`'s step on the whole
    batch in this process: the largest weight difference, the largest
    gradient difference over the gradient tensor's largest magnitude, the
    loss's relative difference, whether all three are bitwise equal, and
    whether every rank holds rank 0's weights and gradients."""
    mlp, opt = train_init(device)
    xb, yb = train_batch(len(dry) * ROWS_PER_RANK, device)
    _, _, loss = make_trainer(sn=0.0, lr=TRAIN_LR)[1](mlp, opt, xb, yb)
    flat = lambda pairs: [a for pair in pairs for a in pair]
    got_w, want_w = flat(dry[0]["weights"]), flat(weights_of(mlp))
    got_g, want_g = flat(dry[0]["grads"]), flat(grads_of(mlp))
    same = lambda a, b: all(np.array_equal(x, y) for x, y in zip(a, b))
    return {
        "weights_max_abs_diff": max(float(np.abs(g - w).max()) for g, w in zip(got_w, want_w)),
        "grads_max_rel_diff": max(float(np.abs(g - w).max() / np.abs(w).max())
                                  for g, w in zip(got_g, want_g)),
        "loss_rel_diff": abs(dry[0]["loss"] - float(loss)) / abs(float(loss)),
        "bitwise": same(got_w, want_w) and same(got_g, want_g) and dry[0]["loss"] == float(loss),
        "replicated": all(same(flat(d["weights"]), got_w) and same(flat(d["grads"]), got_g)
                          for d in dry[1:]),
    }


def multichip_rank(B, seed, single_sps):
    """One rank of a launch over the cards (`parallel/launch.spawn`):
    `dryrun_multichip` on its default mesh, then the deployed step's sharded
    row at B (`deployed.sharded_row_rank`). Host values only."""
    t0 = time.perf_counter()
    dry = dryrun_multichip()
    t_dry = time.perf_counter() - t0
    row, skip, k1 = sharded_row_rank(B, seed, single_sps)
    return dict(dry=dry, t_dry=t_dry, row=row, skip=skip, k1=k1,
                device=str(distributed.local_device()), rank=distributed.process_index())


def dryrun_multichip(mesh: Mesh | None = None) -> dict:
    """The JAX `dryrun_multichip` on this rank: the REAL closed-loop episode
    (controller + estimator + plant + one-tick-delayed PredXU exchange +
    r_horiz-gated NDP forecast) sharded over the (data, swarm) mesh, the
    grouped formation swarm, and a data-parallel MLP training step.

    `mesh` defaults to the (data, swarm) mesh last built, else one over
    every rank with a swarm axis of 2 where the ranks are even (1 else), as
    the JAX function chooses. Every rank runs it (its collectives line up).
    1. the sharded NDP episode at S = 2 n_data scenarios, D = 2 n_swarm
       drones, 3 ticks with 1 of hold, the scan controller: this rank's
       (S / n_data, D / n_swarm) metrics finite and every drone `ok`;
    2. the grouped formation (2 groups of 2 drones, `swarm --formation`
       semantics) where its 4 drones split over the swarm axis: every
       drone `ok`;
    3. one data-parallel training step (`data_parallel_train_step`) of the
       seeded net on a batch of 16 rows a rank, this rank's block of the
       rows (rank-major over (data, swarm)): the loss finite.
    Returns host values: the mesh's shape, each part's local metrics, the
    loss, the averaged gradients of the step and the weights after it
    (`[(w, b), ...]` as numpy).
    """
    from .parallel.episode import make_sharded_episode
    from .sim.swarm_scale import grid_placement
    from .traj.polyopt import fit_waypoints

    if mesh is None:
        n = distributed.process_count()
        mesh = registered(("data", "swarm")) or make_mesh(n, swarm_axis=2 if n % 2 == 0 else 1)
    n_data, n_swarm = mesh.shape["data"], mesh.shape["swarm"]
    dev = mesh.device
    cfg = NdpNmpcConfig()
    out = {"mesh": dict(mesh.shape)}

    # 1. the flagship episode, sharded: scenarios over 'data', the drone axis
    # (with its PredXU all_gather) over 'swarm'
    S, D = 2 * n_data, 2 * n_swarm
    t = np.linspace(0, 2 * np.pi, 4)
    traj = fit_waypoints(np.stack([np.sin(t), 0.5 * np.sin(2 * t), 1.0 + 0.2 * np.sin(t)], -1),
                         np.full(3, 2.0), dtype=torch.float32, device=dev)
    dw = load_npz(ASSET, device=dev)
    kw = dict(use_ndp=True, downwash_params=dw, true_downwash=True, hold_ticks=1,
              solver_backend="jax")
    init_s, run_s = make_sharded_episode(cfg, traj, mesh, n_drones=D, scenario_batch=S, **kw)
    _, m, _ = run_s(init_s(), 3)
    local = (S // n_data, D // n_swarm)
    assert tuple(m.pos_rmse.shape) == local, (tuple(m.pos_rmse.shape), local)
    assert bool(torch.isfinite(m.pos_rmse).all()), m.pos_rmse
    assert bool(m.ok.all()), m.ok
    out["episode"] = {"pos_rmse": m.pos_rmse.cpu().numpy(), "ok": m.ok.cpu().numpy()}

    # 2. the grouped formation swarm over the same mesh
    n_groups = 2
    Dg = 2 * n_groups
    if Dg % n_swarm == 0:
        init_g, run_g = make_sharded_episode(cfg, traj, mesh, n_drones=Dg, scenario_batch=S,
                                             n_groups=n_groups, anchors=grid_placement(n_groups),
                                             **kw)
        _, m_g, _ = run_g(init_g(), 3)
        assert tuple(m_g.pos_rmse.shape) == (S // n_data, Dg // n_swarm), m_g.pos_rmse.shape
        assert bool(m_g.ok.all()), m_g.ok
        out["formation"] = {"pos_rmse": m_g.pos_rmse.cpu().numpy(), "ok": m_g.ok.cpu().numpy()}

    # 3. the data-parallel downwash-MLP training step over the whole mesh
    n_total = n_data * n_swarm
    xb, yb = train_batch(n_total * ROWS_PER_RANK, dev)
    block = mesh.coords["data"] * n_swarm + mesh.coords["swarm"]
    rows = slice(block * ROWS_PER_RANK, (block + 1) * ROWS_PER_RANK)
    mlp, opt = train_init(dev)
    loss = data_parallel_train_step(mesh, mlp, opt, xb[rows], yb[rows])
    assert bool(torch.isfinite(loss)), loss
    out["loss"] = float(loss)
    out["grads"] = grads_of(mlp)
    out["weights"] = weights_of(mlp)
    return out
