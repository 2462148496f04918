"""Downwash force-field visualization on the PyTorch port:
`tools/nn_field_viz.py` (the reference's `nn_test.py` role).

Renders the predicted fz over xy-grids at several vertical offsets for one
or more trained nets (the port's `DownwashMlp`, read by `load_npz`) beside
the port's analytic plant truth (`sim/downwash_truth.analytic_downwash`),
headless (matplotlib's Agg backend). `--nets` and `--dzs` are the JAX
tool's; the figure goes to `--out` (default `build/figs_out`). The nets
run on the card; `--cpu` runs them on the CPU, and without a card and
without `--cpu` the tool fails.

Usage:
  python tools/nn_field_viz_torch.py [--nets assets/downwash_analytic_sn4.npz ...]
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

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.sim.downwash_truth import analytic_downwash  # noqa: E402


def field(model, dz, n=61, device="cpu"):
    """fz on the n x n grid over [-1.2, 1.2]^2 at height offset dz (`model`
    None: the analytic truth). Returns (gx, gy, fz)."""
    xy = np.linspace(-1.2, 1.2, n)
    gx, gy = np.meshgrid(xy, xy)
    rel = np.zeros((n * n, 6))
    rel[:, 0], rel[:, 1], rel[:, 2] = gx.ravel(), gy.ravel(), dz
    with torch.no_grad():
        if model is None:
            f = analytic_downwash(torch.as_tensor(rel, device=device))
        else:
            f = model(torch.as_tensor(rel, dtype=torch.float32, device=device))
    return gx, gy, f[:, 2].double().cpu().numpy().reshape(n, n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nets", nargs="*", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "figs_out"))
    ap.add_argument("--dzs", nargs="*", type=float, default=[0.4, 0.8, 1.5])
    ap.add_argument("--cpu", action="store_true", help="run the nets on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()

    nets = args.nets or [os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz"),
                         os.path.join(ROOT, "assets", "downwash_sn4.npz")]
    models = [("analytic truth", None)] + [
        (os.path.basename(p), load_npz(p, device=dev)) for p in nets
    ]
    fig, axes = plt.subplots(len(models), len(args.dzs),
                             figsize=(4 * len(args.dzs), 3.2 * len(models)), squeeze=False)
    for i, (name, model) in enumerate(models):
        for j, dz in enumerate(args.dzs):
            gx, gy, fz = field(model, dz, device=dev)
            ax = axes[i][j]
            im = ax.pcolormesh(gx, gy, fz, cmap="viridis", shading="auto")
            fig.colorbar(im, ax=ax, label="fz [N]")
            ax.set_title(f"{name}\ndz={dz} m", fontsize=8)
            ax.set_aspect("equal")
    fig.tight_layout()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "downwash_fields.pdf")
    fig.savefig(path)
    plt.close(fig)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
