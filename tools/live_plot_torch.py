"""Live mission dashboard over the port's shared-memory bus:
`tools/live_plot.py` (the PlotJuggler-layout role) on the PyTorch port.

Attaches read-only to a running namespace's topics through the port's bus
(`ndp_nmpc_qd_tpu_torch/runtime/bus.py`, the same records and names as the
JAX bus): odometry, the attitude command and the reference horizon, the
signals the reference's `plotjuggler/one_qd_tracking.xml` charts from
`ref_x_u` + mavros odom. It records for `--secs` at `--rate` Hz and writes
a PNG dashboard, headless (matplotlib's Agg backend). The flags are the
JAX tool's; the default `--out` is `build/qd_dashboard.png`. The dashboard
reads host memory only; it watches the port's daemons, which run on the
card, and like them it fails without a card unless `--cpu` is given (the
daemons started with `--cpu`).

Usage (with the port's `serve` + `simnode` daemons running):
  python tools/live_plot_torch.py --ns fhnp --secs 10 --out build/dash.png
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.runtime import bus as qb  # noqa: E402


def record(ns: str, secs: float, rate_hz: float) -> np.ndarray:
    """Samples (t, pos 3, vel 3, reference position 3, body rate 3, thrust)
    of namespace `ns`, one a period while odometry is published."""
    odom = qb.Topic(f"{ns}/odom", qb.ODOMETRY)
    att = qb.Topic(f"{ns}/attitude_target", qb.ATTITUDE_TARGET)
    ref = qb.Topic(f"{ns}/ref_x_u", qb.PRED_XU)
    rows = []
    rate = qb.Rate(1.0 / rate_hz)
    t_end = qb.now() + secs
    while qb.now() < t_end:
        rate.sleep()
        so, mo = odom.read_latest()
        sa, ma = att.read_latest()
        sr, mr = ref.read_latest()
        if so <= 0:
            continue
        ref_pos = mr["x"][0, 0:3] if sr > 0 else np.full(3, np.nan)
        body_rate = ma["body_rate"] if sa > 0 else np.full(3, np.nan)
        thrust = float(ma["thrust"]) if sa > 0 else np.nan
        rows.append(np.concatenate([[qb.now()], mo["pos"], mo["vel"], ref_pos, body_rate,
                                    [thrust]]))
    for topic in (odom, att, ref):
        topic.close()
    return np.asarray(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", default="fhnp")
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "qd_dashboard.png"))
    ap.add_argument("--cpu", action="store_true", help="watch daemons started with --cpu")
    args = ap.parse_args(argv)
    if not args.cpu:
        resolve_device()

    a = record(args.ns, args.secs, args.rate)
    if not len(a):
        print(f"no odometry seen on {args.ns}: are serve/simnode running?")
        raise SystemExit(1)

    t = a[:, 0] - a[0, 0]
    fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
    for k, lbl in enumerate("xyz"):
        axes[0].plot(t, a[:, 1 + k], label=f"pos {lbl}")
        axes[0].plot(t, a[:, 7 + k], "--", label=f"ref {lbl}")
    axes[0].legend(fontsize=7, ncol=3)
    axes[0].set_ylabel("position [m]")
    for k, lbl in enumerate("xyz"):
        axes[1].plot(t, a[:, 4 + k], label=f"v{lbl}")
    axes[1].legend(fontsize=7)
    axes[1].set_ylabel("velocity [m/s]")
    for k, lbl in enumerate("xyz"):
        axes[2].plot(t, a[:, 10 + k], label=f"w{lbl}")
    axes[2].plot(t, a[:, 13], "k", label="thrust")
    axes[2].legend(fontsize=7, ncol=4)
    axes[2].set_ylabel("cmd")
    axes[2].set_xlabel("t [s]")
    fig.suptitle(f"live: /{args.ns}  ({len(a)} samples)")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print("wrote", args.out)
    return a


if __name__ == "__main__":
    main()
