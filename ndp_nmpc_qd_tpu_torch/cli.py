"""Command-line mission runner and runtime daemons: the launch-file layer, on
the port.

Port of `ndp_nmpc_qd_tpu/cli.py`: the mission subcommand, the reference's
roslaunch topologies (`ndp_nmpc/launch/*.launch`):

  python -m ndp_nmpc_qd_tpu_torch mission one_qd         # one_qd_nmpc.launch
  python -m ndp_nmpc_qd_tpu_torch mission two_qd         # leader + one follower
  python -m ndp_nmpc_qd_tpu_torch mission three_qd       # three_qd_nmpc_formation
  python -m ndp_nmpc_qd_tpu_torch mission three_qd_ndp   # three_qd_ndp_nmpc.launch
  python -m ndp_nmpc_qd_tpu_torch mission four_qd        # four_qd_nmpc.launch
  python -m ndp_nmpc_qd_tpu_torch mission swarm --drones 65536 [--formation]
  python -m ndp_nmpc_qd_tpu_torch mission one_qd --controller thrust

Each run holds the calibration point for `--hold-ticks` ticks, then tracks
the figure-eight (the `eight_high_dyn.yaml` role) for `--track-secs`, and
prints one JSON line with the tracking / formation RMSE the reference
returns in its TrackTraj result (`nmpc_node.py:186-200`) and the solver
configuration as applied.

Runs on the card; `--cpu` runs on the CPU, and without a card and without
`--cpu` the command fails. The solver resolves as the JAX CLI resolves it
(`ndp_nmpc_qd_tpu/cli.py:92-115`): a topology of 512 or more drones on the
card runs the kernels in the deployed configuration (dual warm start, 3 QP
iterations, bf16 Jacobians, the one-kernel step with kernel-layout state;
the flags override it). Smaller topologies and `--cpu` run the scan
controller cold at 12 QP iterations (`--qp-iters` overrides them), where
the kernel flags do not apply; `--f64 --cpu` runs it in float64.
`--backend` names the controller in place of that rule (a flag the JAX CLI
does not have); the defaults then follow the controller it names. The
result records the backend and the flags as the solver applied them.

`--controller thrust` flies the motor-thrust NMPC (13 states, 4 rotor
thrusts, `sim/thrust_loop.py`) on the one_qd topology only, as the JAX CLI
(`ndp_nmpc_qd_tpu/cli.py:133-145`): its dense controller cold at 12 QP
iterations (`--qp-iters` overrides them), no kernel, so the kernel flags do
not apply; the result's backend reads "jax", the scan family.

The runtime daemons over the shared-memory bus (the rosrun analog, JAX
`run_node`), each printing one JSON line:

  python -m ndp_nmpc_qd_tpu_torch simnode --ns demo   # the plant (dop_sim role)
  python -m ndp_nmpc_qd_tpu_torch serve --ns demo     # the NMPC controller daemon
  python -m ndp_nmpc_qd_tpu_torch send --ns demo      # a goal; awaits the RMSE result

They too run on the card, and `--cpu` on the CPU; without a card and without
`--cpu` they fail (the JAX CLI pins its daemons to the CPU unless
`--device tpu`). On the card `serve` runs the deployed one-kernel step at
B=1 with dispatch-ahead ticks; on the CPU the scan controller cold@12.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

TOPOLOGIES = ("one_qd", "two_qd", "three_qd", "three_qd_ndp", "four_qd", "swarm")


def build_eight(scale: float = 2.0, t_seg: float = 2.0, dtype=torch.float32, device="cpu"):
    """The eight_high_dyn.yaml role: a figure-eight with yaw motion."""
    from .traj.polyopt import fit_waypoints

    t = np.linspace(0, 2 * np.pi, 9)
    wpts = np.stack(
        [scale * np.sin(t), 0.5 * scale * np.sin(2 * t), 1.0 + 0.3 * np.sin(t)], axis=-1,
    )
    return fit_waypoints(wpts, np.full(8, t_seg), 0.2 * np.sin(t), dtype=dtype, device=device)


def default_asset(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", name)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_mission(args, record_traces: bool = False, n_ticks: int | None = None):
    """Build and fly one mission (its first `n_ticks` ticks where given).
    Returns (result, run): the JSON-ready result, and run = dict(metrics,
    traces, state) with the episode's tensors (traces with
    `record_traces`: x, u0, throttle over the ticks; x, u0 for the thrust
    controller)."""
    from . import resolve_device
    from .models.downwash_mlp import load_npz
    from .params import NdpNmpcConfig, SimParams
    from .sim.closed_loop import make_episode, resolve_backend

    thrust = args.controller == "thrust"
    if thrust and args.topology != "one_qd":
        raise ValueError("--controller thrust supports the one_qd topology")
    if thrust and args.backend not in ("auto", "jax"):
        raise ValueError("--controller thrust runs its own dense controller; --backend "
                         f"{args.backend} does not apply")
    if args.f64 and not args.cpu:
        raise NotImplementedError(
            "--f64 runs on the CPU only (--cpu): the CUDA kernels are f32, and f64 exists "
            "only on the CPU in the JAX package too"
        )
    dev = torch.device("cpu") if args.cpu else resolve_device()
    dtype = torch.float64 if args.f64 else torch.float32
    topology = {
        "one_qd": dict(n_drones=1),
        "two_qd": dict(n_drones=2),
        "three_qd": dict(n_drones=3),
        "three_qd_ndp": dict(n_drones=3, use_ndp=True, true_downwash=True),
        "four_qd": dict(n_drones=4, independent=True),
        "swarm": dict(n_drones=args.drones, independent=True),
    }[args.topology]
    n_total = int(topology["n_drones"])
    formation = args.topology == "swarm" and args.formation
    if formation:
        n_total = max(args.drones // 3, 1) * 3
    backend = "jax" if thrust else resolve_backend(args.backend, n_total, dev)
    use_pallas = backend == "pallas"
    if args.qp_iters is None:
        args.qp_iters = 3 if use_pallas else 12
    for flag in ("warm", "whole_ipm", "bf16", "whole_step"):
        if getattr(args, flag) is None:
            setattr(args, flag, use_pallas)

    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=args.k_true))
    if args.scenario:
        from .traj.scenarios import load_scenario

        trajs = [load_scenario(s, dtype=dtype) for s in args.scenario]
        if len(trajs) > 1 and not topology.get("independent"):
            raise ValueError("multiple --scenario requires four_qd or swarm")
        traj = trajs if len(trajs) > 1 else trajs[0]
    else:
        traj = build_eight(dtype=dtype)
    nn = lambda: load_npz(args.nn or default_asset("downwash_analytic_sn4.npz"), dtype=dtype,
                          device=dev)
    solver = dict(
        qp_iters=args.qp_iters, solver_warm_start=args.warm, solver_whole_ipm=args.whole_ipm,
        solver_jac_bf16=args.bf16, solver_packed_state=args.whole_step,
        solver_whole_step=args.whole_step, solver_backend=backend, recover=args.recover,
        hold_ticks=args.hold_ticks, record_traces=record_traces, device=dev,
    )
    if thrust:
        from .sim.thrust_loop import make_thrust_episode

        init_fn, _, run_fn = make_thrust_episode(
            cfg, traj, n_drones=1, qp_iters=args.qp_iters, hold_ticks=args.hold_ticks,
            record_traces=record_traces, device=dev,
        )
    elif formation:
        from .sim.swarm_scale import make_formation_swarm

        n_swarms = max(args.drones // 3, 1)
        init_fn, _, run_fn = make_formation_swarm(
            cfg, traj, n_swarms=n_swarms, drones_per_swarm=3, use_ndp=True,
            true_downwash=True, downwash_params=nn(), **solver,
        )
    else:
        kwargs = dict(topology)
        if kwargs.get("use_ndp"):
            kwargs["downwash_params"] = nn()
        init_fn, _, run_fn = make_episode(cfg, traj, **kwargs, **solver)
    if n_ticks is None:
        n_ticks = args.hold_ticks + int(args.track_secs / cfg.ocp.ts_nmpc)

    st = init_fn(dtype=dtype)
    _sync(dev)
    t0 = time.perf_counter()
    st, metrics, traces = run_fn(st, n_ticks)
    _sync(dev)
    wall = time.perf_counter() - t0

    def summarize(a):
        a = a.detach().double().cpu().numpy()
        if a.size <= 8:
            return a.round(5).tolist()
        return {"min": round(float(a.min()), 5), "mean": round(float(a.mean()), 5),
                "max": round(float(a.max()), 5)}

    ok = metrics.ok.cpu().numpy()
    result = {
        "topology": args.topology,
        "n_drones": n_total,
        "ticks": n_ticks,
        "pos_rmse": summarize(metrics.pos_rmse),
        "yaw_rmse_deg": summarize(metrics.yaw_rmse_deg),
        "form_rmse": summarize(metrics.form_rmse),
    }
    if formation:
        # role split: member 0 of each 3-drone group is its leader
        # (`nmpc_follower_node.py:79-94` logs the followers apart)
        pr = metrics.pos_rmse.reshape(-1, 3)
        result["pos_rmse_leaders"] = summarize(pr[:, 0])
        result["pos_rmse_followers"] = summarize(pr[:, 1:])
    # the kernel flags as the solver applied them: the other controllers
    # have none of them
    kern = lambda flag: bool(getattr(args, flag)) and use_pallas
    result |= {
        "solver": {
            "backend": backend,
            "qp_iters": args.qp_iters,
            "warm": kern("warm"),
            "whole_ipm": kern("whole_ipm"),
            "bf16": kern("bf16"),
            "whole_step": kern("whole_step"),
            "lqr_start": use_pallas and not (args.whole_step or args.whole_ipm),
            "state": "kernel" if kern("whole_step") else "batch",
        },
        "ok": ok.tolist() if ok.size <= 8 else [bool(ok.all())],
        "recovered": int(metrics.recovered),
        "wall_s": round(wall, 3),
        "ms_per_tick": round(wall * 1e3 / n_ticks, 3),
        "solves_per_s": round(n_ticks * n_total / wall, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return result, dict(metrics=metrics, traces=traces, state=st)


def make_parser():
    ap = argparse.ArgumentParser(prog="ndp_nmpc_qd_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    mission = sub.add_parser("mission", help="closed-loop missions (launch-file analog)")
    mission.add_argument("topology", choices=TOPOLOGIES)
    mission.add_argument("--drones", type=int, default=4096, help="swarm size")
    mission.add_argument(
        "--formation", action="store_true",
        help="swarm: drones//3 leader/follower NDP formations (exchange + downwash + "
        "coupling) instead of independent drones",
    )
    mission.add_argument("--track-secs", type=float, default=16.0)
    mission.add_argument("--hold-ticks", type=int, default=200)
    mission.add_argument("--k-true", type=float, default=46.0)
    mission.add_argument("--nn", default=None, help="downwash net .npz")
    mission.add_argument("--cpu", action="store_true",
                         help="run on the CPU (there every topology flies the scan controller)")
    mission.add_argument("--f64", action="store_true", help="float64 (with --cpu only)")
    for name, hlp in (
        ("warm", "carry QP multipliers across ticks (deployed default: on)"),
        ("whole-ipm", "the whole IPM in one kernel (deployed default: on)"),
        ("whole-step", "the one-kernel control step + kernel-layout state (deployed "
                       "default: on)"),
        ("bf16", "bf16 curvature payload (deployed default: on)"),
    ):
        dest = name.replace("-", "_")
        mission.add_argument(f"--{name}", dest=dest, action="store_true", default=None, help=hlp)
        mission.add_argument(f"--no-{name}", dest=dest, action="store_false",
                             help=argparse.SUPPRESS)
    mission.add_argument(
        "--backend", default="auto", choices=["auto", "pallas", "jax", "pallas_packed"],
        help="controller: auto (the kernels for 512 drones or more on the card, else the "
        "scan controller), pallas (the kernels), jax (the scan controller), pallas_packed "
        "(the dense legacy path)",
    )
    mission.add_argument("--qp-iters", type=int, default=None,
                         help="IPM iterations (deployed default 3, else 12)")
    mission.add_argument(
        "--no-recover", dest="recover", action="store_false",
        help="disable live divergence recovery (on by default: diverged drones re-seed "
        "from their reference and fly the hold command for the bad tick)",
    )
    mission.add_argument(
        "--scenario", action="append", default=None,
        help="trajectory yaml (configs/ name or path; needs pyyaml); repeat for per-drone "
        "goals on independent topologies",
    )
    mission.add_argument("--controller", default="bodyrate", choices=["bodyrate", "thrust"])
    for name, hlp in (
        ("serve", "NMPC controller daemon over the qdio bus"),
        ("simnode", "plant (dop_sim role) daemon over the qdio bus"),
        ("send", "send a trajectory goal and await the RMSE result"),
    ):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("--ns", default="fhnp")
        p.add_argument("--leader-ns", default=None)
        p.add_argument("--companion-ns", default=None,
                       help="NDP: forecast downwash from this namespace's horizon")
        p.add_argument("--max-ticks", type=int, default=0, help="0 = forever")
        p.add_argument("--scale", type=float, default=1.0)
        p.add_argument("--cancel-after", type=float, default=None,
                       help="send: preempt the goal this many seconds in (status=2)")
        p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def run_node(args) -> dict:
    """One runtime daemon, or the goal client, on the card (`--cpu`: the
    CPU). Returns its JSON-ready result."""
    from . import resolve_device
    from .runtime.nodes import ControllerDaemon, PlantDaemon, send_trajectory

    dev = torch.device("cpu") if args.cpu else resolve_device()
    if args.cmd == "serve":
        daemon = ControllerDaemon(
            args.ns, leader_ns=args.leader_ns, use_ndp=bool(args.companion_ns),
            companion_ns=args.companion_ns, device=dev,
        )
        return daemon.run(max_ticks=args.max_ticks)
    if args.cmd == "simnode":
        return PlantDaemon(args.ns, device=dev).run(max_ticks=args.max_ticks)
    traj = build_eight(scale=args.scale, dtype=torch.float64, device=dev)
    res, fb = send_trajectory(args.ns, traj, goal_id=int(time.time()) % 10000,
                              cancel_after_s=args.cancel_after)
    return {
        "status": int(res["status"]),
        "pos_rmse": float(res["pos_rmse"]),
        "yaw_rmse": float(res["yaw_rmse"]),
        "feedback_msgs": len(fb),
    }


def main(argv=None):
    import sys

    raw = list(argv) if argv is not None else sys.argv[1:]
    if raw and raw[0] in TOPOLOGIES:
        raw = ["mission"] + raw
    args = make_parser().parse_args(raw)
    if args.cmd != "mission":
        print(json.dumps(run_node(args)))
        return
    result, _ = run_mission(args)
    print(json.dumps(result))
    if not all(result["ok"]):
        raise SystemExit(2)


if __name__ == "__main__":
    main()
