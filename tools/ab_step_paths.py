"""Compare the one-kernel and two-kernel controller paths of two checkouts on
one CUDA card, in turns.

    python3 tools/ab_step_paths.py OTHER_CHECKOUT [--order AB BA]

Each turn starts a process in a checkout (A: the one this script lies in,
B: OTHER_CHECKOUT, for example an unpacked `git archive` of the parent
commit) that runs that checkout's `chip_smoke.phase_path` for the deployed
one-kernel step and the two-kernel path at B=65536 (bf16 forecast, warm
start, 3 QP iterations, bf16 Jacobians): health, step time over 30 queued
ticks (CUDA events), solves/s, launches and peak memory, as chip_smoke.py
prints them. The default order is A, B, B, A, so that drift on the card
shows as a difference between the two turns of one checkout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVE = (
    "import torch, chip_smoke as cs\n"
    "from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "dev = torch.device('cuda')\n"
    "mlp = load_npz(cs.ASSET, device=dev)\n"
    "for path in ('one-kernel', 'two-kernel'):\n"
    "    cs.phase_path(65536, dev, 0, mlp, path)\n"
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout (B)")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args()
    trees = {"A": HERE, "B": os.path.abspath(args.other)}
    for turn, key in enumerate(args.order):
        print(f"turn {turn}: {key} = {trees[key]}", flush=True)
        done = subprocess.run([sys.executable, "-c", DRIVE], cwd=trees[key], timeout=900)
        if done.returncode != 0:
            sys.exit(f"turn {turn} ({key}) failed: {done.returncode}")


if __name__ == "__main__":
    main()
