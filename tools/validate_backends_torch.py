"""Closed-loop cross-path validation on the PyTorch port: the BASELINE
deviation metric, `tools/validate_backends.py`.

BASELINE.md's acceptance is a max control deviation below 1e-3 against the
reference's control sequence on the flight trajectories (`BASELINE.md:24`).
acados does not run here, so the strongest equivalent is the whole
figure-eight mission flown by independent solver paths of the port, the
same episode, dtype (float32) and ticks:

- `jax`: the scan controller (dense per-scenario Riccati IPM, plain
  PyTorch), always flown, the reference of every deviation;
- `pallas`: the kernels cold@12 from the clipped-LQR start, batch-first
  state (K3, K6 + K7, then K4 + K5 each IPM iteration), always flown;
- `--warm-iters K`: `pallas_warm`, the same warm-started at K iterations;
- `--no-lqr-start`: `pallas_warm_nolqr`, warm from the zero-control start
  (K3, K4 + K5 each iteration);
- `--bf16`: `pallas_warm_bf16`, warm with the bf16 curvature payload;
- `--whole-ipm` / `--whole-ipm-bf16`: `pallas_whole[_bf16]`, K3 + K2;
- `--whole-step`: `whole_step_bf16`, the deployed one-kernel step (K1),
  kernel-layout state, bf16 payload, warm at `--warm-iters` (default 4).
`--drones 3` flies the three_qd_ndp topology (the leader's NDP forecast,
the followers, the plant's downwash coupling); deviations cover every
drone. Prints per path its RMSE and health, then one JSON line of the max
control deviation and trajectory divergence against the scan controller,
and exits 1 when any path is at or past the 1e-3 bound. Runs on the card;
`--cpu` runs on the CPU, and without a card and without `--cpu` it fails.

  python tools/validate_backends_torch.py [--ticks 500] [--warm-iters 3 --whole-step]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.cli import build_eight  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig, SimParams  # noqa: E402
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode  # noqa: E402

TOLERANCE = 1e-3


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--hold-ticks", type=int, default=100)
    ap.add_argument("--warm-iters", type=int, default=0,
                    help="also validate the warm-start kernel path at this qp_iters (0 = skip)")
    ap.add_argument("--no-lqr-start", action="store_true",
                    help="also validate the warm path from the zero-control-rollout start")
    ap.add_argument("--bf16", action="store_true",
                    help="also validate the bf16-Jacobian warm path")
    ap.add_argument("--whole-ipm", action="store_true",
                    help="also validate the whole IPM in one kernel (K3 + K2)")
    ap.add_argument("--whole-ipm-bf16", action="store_true",
                    help="the whole-IPM path with the bf16 payload")
    ap.add_argument("--whole-step", action="store_true",
                    help="also validate the one-kernel control step (K1, kernel-layout state, "
                    "bf16 payload: the deployed configuration)")
    ap.add_argument("--drones", type=int, default=1,
                    help="3 = the three_qd_ndp topology; deviations cover all drones")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def variants(args):
    """[(name, make_episode's solver flags)], the JAX tool's list."""
    warm = lambda default, **kw: {"solver_warm_start": True,
                                  "qp_iters": args.warm_iters or default, **kw}
    out = [("jax", {"solver_backend": "jax"}), ("pallas", {})]
    if args.warm_iters > 0:
        out.append(("pallas_warm", warm(0)))
    if args.no_lqr_start:
        out.append(("pallas_warm_nolqr", warm(6, solver_lqr_start=False)))
    if args.bf16:
        out.append(("pallas_warm_bf16", warm(6, solver_jac_bf16=True)))
    if args.whole_ipm:
        out.append(("pallas_whole", warm(6, solver_whole_ipm=True)))
    if args.whole_ipm_bf16:
        out.append(("pallas_whole_bf16", warm(6, solver_whole_ipm=True, solver_jac_bf16=True)))
    if args.whole_step:
        out.append(("whole_step_bf16", warm(4, solver_jac_bf16=True, solver_packed_state=True,
                                            solver_whole_step=True)))
    return out


def fly(extra, args, dev):
    """One mission on the path `extra` names. Returns (x (T, D, 10),
    u0 (T, D, 4), metrics, wall seconds)."""
    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=50.0))
    ndp_kw = {}
    if args.drones > 1:
        ndp_kw = dict(n_drones=args.drones, use_ndp=True, true_downwash=True,
                      downwash_params=load_npz(
                          os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz"), device=dev))
    init_fn, _, run_fn = make_episode(
        cfg, build_eight(), hold_ticks=args.hold_ticks, record_traces=True, device=dev,
        **{"n_drones": 1, "solver_backend": "pallas", **ndp_kw, **extra},
    )
    st = init_fn(dtype=torch.float32)
    t0 = time.perf_counter()
    _, metrics, (xs, u0s, _) = run_fn(st, args.ticks)
    xs, u0s = xs.cpu().numpy(), u0s.cpu().numpy()  # waits for the card
    return xs, u0s, metrics, time.perf_counter() - t0


def deviations(traces, ticks, drones) -> dict:
    """The JSON line: each path's deviation from the scan controller's."""
    xs_j, u_j = traces["jax"][:2]
    out = {"ticks": ticks, "drones": drones, "tolerance": TOLERANCE}
    for name, (xs_p, u_p, *_) in traces.items():
        if name == "jax":
            continue
        du = np.abs(u_j - u_p)
        dpos = np.linalg.norm(xs_j[..., 0:3] - xs_p[..., 0:3], axis=-1)
        out[name] = {
            "max_control_deviation": float(du.max()),
            "mean_control_deviation": float(du.mean()),
            "max_traj_divergence_m": float(dpos.max()),
            "final_traj_divergence_m": float(np.max(dpos[-1])),
            "pass": bool(du.max() < TOLERANCE),
        }
    out["pass"] = all(v["pass"] for v in out.values() if isinstance(v, dict))
    return out


def main(argv=None):
    args = make_parser().parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    traces = {}
    for name, extra in variants(args):
        traces[name] = fly(extra, args, dev)
        xs, u0s, metrics, wall = traces[name]
        print(f"{name:17s}: pos_rmse {float(metrics.pos_rmse[0]):.5f} "
              f"ok={bool(metrics.ok.all())} {wall * 1e3 / args.ticks:.2f} ms a tick",
              file=sys.stderr)
    out = deviations(traces, args.ticks, args.drones)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(out))
    if not out["pass"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
