"""Operating-point sweep of the port's deployed control step, in one
process: `tools/bench_points.py` on the PyTorch port.

Times `bench_torch.py`'s device step (the bf16 downwash forecast + one RTI
update of the deployed controller: warm start, 3 QP iterations, bf16
Jacobians, the one-kernel step K1) at several batch sizes, with
`bench_torch.py`'s own operating point (`inputs`), tick (`control_step`)
and queued row (`row_throughput`: 30 dependent ticks between CUDA events,
then 10 blocking ticks), one JSON line a point, each with the card's name
and power limit. The same `BENCH_*` variables as `bench_torch.py` override
the flags. Runs on the card; `--cpu` runs the plain versions on the CPU (a
rehearsal: no device time), and without a card and without `--cpu` it
fails.

    python tools/bench_points_torch.py [B ...]   (default 4096 8192 16384 32768 65536)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch as bt  # noqa: E402
from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402


def run(batches, dev, iters=30, blocking=10):
    """One row a batch size in `batches`, each printed as a JSON line:
    `iters` queued ticks, then `blocking` blocking ticks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bt.card_line() if dev.type == "cuda" else "cpu"
    flags = bt.deployed_flags()
    mlp_bf16 = bt.env_flag("BENCH_MLP_BF16", "1")
    ctl = bt.make_batched_rti_controller(bt.CFG.ocp, bt.CFG.vehicle, device=dev, **flags)
    step = bt.control_step(ctl, load_npz(bt.ASSET, device=dev), mlp_bf16)
    rows = []
    for B in batches:
        ins = bt.inputs(B, dev, 0)
        state = ctl.reset(ins[1], ins[2])
        row, state = bt.row_throughput(step, state, ins, iters, blocking)
        row = {"B": B, "device_step_ms": row["device_step_ms"],
               "wall_step_ms": row["wall_step_ms"], "solves_per_s": row["solves_per_s"],
               "first_tick_s": row["first_tick_s"],
               "blocking_p50_ms": row["blocking_p50_ms"], "qp_iters": flags["qp_iters"],
               "whole_ipm": flags["whole_ipm"], "whole_step": flags["whole_step"],
               "ok": row["ok"], "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", nargs="*", type=int,
                    default=[4096, 8192, 16384, 32768, 65536])
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    return run(args.batches, torch.device("cpu") if args.cpu else resolve_device())


if __name__ == "__main__":
    main()
