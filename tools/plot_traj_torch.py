"""Offline mission analysis plots on the PyTorch port: `tools/plot_traj.py`
(the reference's `figs/draw_traj.py` / `draw_mul_traj.py` role).

Flies a mission through the port's CLI (`cli.run_mission(args,
record_traces=True)`: 200 hold ticks, then `--track-secs` of the
figure-eight, the true throttle gain 46) and renders per-axis
reference-vs-actual position / velocity / body-rate panels (one drone or a
formation), plus the throttle-estimator trace (`draw_throttle_est_fig.py`
role), headless (matplotlib's Agg backend). `--topology` and
`--track-secs` are the JAX tool's; the figures go to `--out` (default
`build/figs_out`). The mission runs as the port's CLI resolves it (the
scan controller for these topologies) on the card in float32; `--cpu`
runs it on the CPU in float64, as the JAX tool does. Without a card and
without `--cpu` the tool fails.

Usage:
  python tools/plot_traj_torch.py [--topology one_qd|three_qd|three_qd_ndp]
                                  [--out build/figs_out/] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch import cli  # noqa: E402
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig, SimParams  # noqa: E402
from ndp_nmpc_qd_tpu_torch.traj.polyopt import eval_traj  # noqa: E402

K_TRUE = 46.0
HOLD_TICKS = 200


def fly(topology, track_secs, cpu):
    """The mission through the port's CLI. Returns (result, traces of
    numpy arrays x (T, D, 10), u0 (T, D, 4), throttle (T, D))."""
    argv = ["mission", topology, "--track-secs", str(track_secs), "--hold-ticks",
            str(HOLD_TICKS), "--k-true", str(K_TRUE)] + (["--cpu", "--f64"] if cpu else [])
    result, run = cli.run_mission(cli.make_parser().parse_args(argv), record_traces=True)
    return result, [t.detach().double().cpu().numpy() for t in run["traces"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology", default="one_qd", choices=["one_qd", "three_qd", "three_qd_ndp"])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "figs_out"))
    ap.add_argument("--track-secs", type=float, default=16.0)
    ap.add_argument("--cpu", action="store_true", help="fly on the CPU, in float64")
    args = ap.parse_args(argv)

    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=K_TRUE))
    result, (xs, u0s, throttles) = fly(args.topology, args.track_secs, args.cpu)
    n_ticks = xs.shape[0]
    ts = (np.arange(n_ticks) - HOLD_TICKS) * cfg.ocp.ts_nmpc
    track = ts >= 0
    traj = cli.build_eight(dtype=torch.float64)
    fo = eval_traj(traj, torch.as_tensor(np.clip(ts, 0, None)))
    ref_pos, ref_vel = fo.pos.numpy(), fo.vel.numpy()

    os.makedirs(args.out, exist_ok=True)
    D = xs.shape[1]
    fig, axes = plt.subplots(3, 3, figsize=(13, 8), sharex=True)
    labels = ["x [m]", "y [m]", "z [m]"]
    for k in range(3):
        ax = axes[0][k]
        ax.plot(ts[track], ref_pos[track, k], "k--", label="ref")
        for d in range(D):
            ax.plot(ts[track], xs[track, d, k], label=f"qd{d}")
        ax.set_ylabel("pos " + labels[k])
        ax = axes[1][k]
        ax.plot(ts[track], ref_vel[track, k], "k--")
        for d in range(D):
            ax.plot(ts[track], xs[track, d, 3 + k])
        ax.set_ylabel("vel " + labels[k][0] + " [m/s]")
        ax = axes[2][k]
        for d in range(D):
            ax.plot(ts[track], u0s[track, d, k])
        ax.set_ylabel(f"body rate {'xyz'[k]} [rad/s]")
        ax.set_xlabel("t [s]")
    axes[0][0].legend(fontsize=7)
    rmse = result["pos_rmse"]
    fig.suptitle(f"{args.topology}: pos RMSE "
                 + ", ".join(f"{v:.4f}" for v in np.atleast_1d(rmse)) + " m")
    fig.tight_layout()
    path = os.path.join(args.out, f"traj_{args.topology}.pdf")
    fig.savefig(path)
    plt.close(fig)
    print("wrote", path)

    # hover-throttle estimator trace (draw_throttle_est_fig.py role)
    fig2, ax = plt.subplots(figsize=(6, 3))
    ax.plot(throttles[:, 0], label="throttle cmd (qd0)")
    ax.axhline(cfg.vehicle.mass * cfg.vehicle.gravity / cfg.sim.k_throttle_true,
               color="k", ls="--", label="true hover throttle")
    ax.legend()
    ax.set_xlabel("tick")
    fig2.tight_layout()
    path2 = os.path.join(args.out, "throttle_est.pdf")
    fig2.savefig(path2)
    plt.close(fig2)
    print("wrote", path2)
    return path, path2


if __name__ == "__main__":
    main()
