"""Offline downwash-NN training on the PyTorch port: `tools/train_downwash.py`
(the reference's `nn_train.py` pipeline) with the port's trainer.

The reference trains 6->128->64->128->3 on CSV pairs (relative state ->
measured force) with full-batch Adam lr=1e-4, MSE, 10k-20k epochs, and a
post-step spectral-norm projection (`dnwash_nn_est/nn_train.py:84-172`).
Here, as in the JAX tool, the dataset is sampled from the plant's
ground-truth coupling (the port's `sim/downwash_truth.analytic_downwash`),
and training is `models/downwash_mlp.make_trainer`'s step in a Python loop.

Every flag of the JAX tool keeps its name, default and meaning: --sn,
--sn-sweep, --epochs, --lr, --n-train, --input-csv/--output-csv (the
flight-log CSVs, split 75/25 by the same numpy permutation, so row for row
as the JAX tool splits them), --curves (the train/test loss-curve figure)
and --out. Two differ: the default --out is
`build/downwash_{tag}_sn{SN}.npz`, never over the committed asset, and the
init is `init_mlp` from `torch.Generator().manual_seed(0)` (the JAX tool
draws from `PRNGKey(0)`, another stream). Training runs on the card;
--cpu runs it on the CPU, and without a card and without --cpu the tool
fails.

Usage: python tools/train_downwash_torch.py [--sn 4] [--epochs 4000] [--cpu]
       [--input-csv downwash_input.csv --output-csv downwash_output.csv]
       [--curves build/training.png] [--out build/downwash_analytic_sn4.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import init_mlp, make_trainer, save_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.sim.downwash_truth import analytic_downwash  # noqa: E402


def sample_dataset(n: int, seed: int = 0):
    """Relative states covering the interaction envelope (the reference's
    data comes from flight logs inside the r_horiz cylinder), the JAX
    tool's draws from the same numpy generator."""
    rng = np.random.default_rng(seed)
    rel = np.zeros((n, 6))
    rel[:, 0:2] = rng.uniform(-1.2, 1.2, (n, 2))  # horizontal offset
    rel[:, 2] = rng.uniform(-0.5, 3.0, n)  # vertical offset (other above)
    rel[:, 3:6] = rng.uniform(-1.0, 1.0, (n, 3))  # relative velocity
    y = analytic_downwash(torch.as_tensor(rel)).numpy()
    # measurement noise comparable to the reference's force-residual data
    y = y + 0.05 * rng.standard_normal(y.shape)
    return rel.astype(np.float32), y.astype(np.float32)


def load_csv_dataset(input_csv: str, output_csv: str, seed: int = 0):
    """The reference's flight-log ingestion (`nn_train.py:96-104`): CSV
    pairs -> shuffled 75/25 train/test split (sklearn train_test_split
    role, random split as in the reference)."""
    x = np.loadtxt(input_csv, delimiter=",", dtype=np.float64, ndmin=2)
    y = np.loadtxt(output_csv, delimiter=",", dtype=np.float64, ndmin=2)
    assert x.shape[1] == 6, f"input CSV must be x,y,z,vx,vy,vz; got {x.shape}"
    assert y.shape[1] == 3, f"output CSV must be fx,fy,fz; got {y.shape}"
    assert x.shape[0] == y.shape[0], (x.shape, y.shape)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    n_tr = int(0.75 * x.shape[0])
    tr, te = perm[:n_tr], perm[n_tr:]
    return (
        x[tr].astype(np.float32), y[tr].astype(np.float32),
        x[te].astype(np.float32), y[te].astype(np.float32),
    )


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sn", type=float, default=4.0)
    ap.add_argument(
        "--sn-sweep", nargs="*", type=float, default=None,
        help="train one model per SN value (train_model_multiple_times.sh role)",
    )
    ap.add_argument("--epochs", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--input-csv", default=None,
        help="flight-log relative states x,y,z,vx,vy,vz (nn_train.py:96)",
    )
    ap.add_argument(
        "--output-csv", default=None,
        help="flight-log measured forces fx,fy,fz (nn_train.py:100)",
    )
    ap.add_argument(
        "--curves", default=None,
        help="save the train/test loss-curve figure here (draw_training_fig.py role)",
    )
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    assert (args.input_csv is None) == (args.output_csv is None), (
        "--input-csv and --output-csv go together"
    )
    dev = torch.device("cpu") if args.cpu else resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.sn_sweep is not None:
        # the zsh sweep over SN in {0,2,4,8} (train_model_multiple_times.sh)
        for sn in args.sn_sweep:
            sub = argparse.Namespace(**vars(args))
            sub.sn, sub.sn_sweep, sub.out = sn, None, None
            print(f"=== SN = {sn} ===")
            train_one(sub, dev)
        return
    train_one(args, dev)


def train_one(args, dev):
    """Train one net as the flags say, save it and (with --curves) its loss
    curves. Returns (net, curve of (epoch, train MSE, test MSE))."""
    if args.input_csv is not None:
        x_tr, y_tr, x_te, y_te = load_csv_dataset(args.input_csv, args.output_csv)
        tag = "csv"
    else:
        x_tr, y_tr = sample_dataset(args.n_train, seed=0)
        x_te, y_te = sample_dataset(4096, seed=1)
        tag = "analytic"

    mlp = init_mlp(torch.Generator().manual_seed(0), device=dev)
    init_opt, train_step, loss_fn = make_trainer(sn=args.sn, lr=args.lr)
    opt = init_opt(mlp)

    xt, yt, xe, ye = (torch.as_tensor(a, device=dev) for a in (x_tr, y_tr, x_te, y_te))
    curve = []  # (epoch, train, test)
    log_every = max(1, min(500, args.epochs // 20))
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        mlp, opt, loss = train_step(mlp, opt, xt, yt)
        if epoch % log_every == 0 or epoch == args.epochs - 1:
            with torch.no_grad():
                te = float(loss_fn(mlp, xe, ye))
            curve.append((epoch, float(loss), te))
            if epoch % 500 == 0 or epoch == args.epochs - 1:
                print(f"epoch {epoch}: train {float(loss):.4f} test {te:.4f}")
    wall = time.perf_counter() - t0

    with torch.no_grad():
        test_loss = float(loss_fn(mlp, xe, ye))
    out = args.out or os.path.join(ROOT, "build", f"downwash_{tag}_sn{int(args.sn)}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_npz(mlp, out)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"saved {out} (test MSE {test_loss:.4f}; {args.epochs / wall:.1f} epochs/s on "
          f"{where}, n_train {len(x_tr)})")

    if args.curves:
        # the reference's training-curve figure (draw_training_fig.py)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        c = np.asarray(curve)
        fig, ax = plt.subplots(figsize=(5, 3.2))
        ax.plot(c[:, 0], c[:, 1], label="train MSE")
        ax.plot(c[:, 0], c[:, 2], label="test MSE")
        ax.set_xlabel("epoch")
        ax.set_ylabel("MSE")
        ax.set_title(f"downwash MLP (SN={args.sn:g}, {tag} data)")
        ax.legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(os.path.abspath(args.curves)), exist_ok=True)
        fig.savefig(args.curves, dpi=120)
        plt.close(fig)
        print(f"saved curves to {args.curves}")
    return mlp, curve


if __name__ == "__main__":
    main()
