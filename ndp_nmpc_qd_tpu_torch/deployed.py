"""The deployed control step (`bench.py:96-131`): its controller flags, its
operating point, its tick, and its sharded row on one rank.

`bench_torch.py` measures it (its `BENCH_*` variables override `FLAGS`);
the profilers, the multi-card tool and `chip_smoke.py` build the same
step from here.
"""

from __future__ import annotations

import os
import subprocess

import torch

from .models.downwash_mlp import load_npz, predict_downwash
from .models.quadrotor import hover_input, hover_state
from .ops.kernels import step_whole
from .params import NdpNmpcConfig
from .parallel import distributed
from .parallel.batch_step import measure_sharded_row
from .solver.rti import make_batched_rti_controller

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "downwash_analytic_sn4.npz")
CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
# warm start, 3 QP iterations, bf16 Jacobians, the state in kernel layout,
# the whole step in one launch (K1)
FLAGS = dict(with_disturbance=True, qp_iters=3, warm_start=True, jac_bf16=True,
             lqr_start=False, whole_ipm=True, packed_state=True, whole_step=True)


def inputs(B, dev, seed):
    """`bench.py:122-131`'s operating point from a seeded generator: hover at
    uniform offsets in [-1, 1] m, hover references at the origin, the other
    drone's horizon 0.9 m above (the forecast active)."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(B, 3, generator=g) * 2.0 - 1.0
    x0 = hover_state(pos).to(dev)
    xr = hover_state(torch.zeros(B, 3)).to(dev)[:, None, :].repeat(1, N + 1, 1)
    ur = hover_input(CFG.vehicle, (B,), device=dev)[:, None, :].repeat(1, N, 1)
    other = xr.clone()
    other[..., 2] += 0.9
    return x0, xr, ur, other


def control_step(ctl, mlp, mlp_bf16):
    """The deployed tick: the forecast, then one update."""

    def step(state, x0, xr, ur, other):
        with torch.no_grad():
            f = predict_downwash(mlp, other, xr, r_horiz=CFG.downwash.r_horiz,
                                 ego_gate_pos=x0[..., 0:3],
                                 compute_dtype=torch.bfloat16 if mlp_bf16 else None)
        return ctl.update(state, x0, xr, ur, f)

    return step


def sharded_row_rank(B, seed, single_sps, flags=FLAGS, mlp_bf16=True, iters=30):
    """One rank of the sharded row (run by `launch.spawn` on every rank):
    the step built from `flags`, the global inputs of `inputs(B, seed)`
    made on every rank, and this rank's block of them through
    `make_sharded_step` over the 1-D data mesh of every rank
    (`measure_sharded_row`: the slowest rank's time sets the row). Returns
    (row, skip reason, this rank's K1 launches in the row)."""
    dev = distributed.local_device()
    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, device=dev, **flags)
    step = control_step(ctl, load_npz(ASSET, device=dev), mlp_bf16)
    ins = inputs(B, dev, seed)
    step_whole.control_step_whole.launches = 0
    row, skip = measure_sharded_row(step, (ctl.reset(ins[1], ins[2]), *ins), B=B,
                                    single_sps=single_sps, iters=iters,
                                    packed_state=flags["packed_state"])
    return row, skip, step_whole.control_step_whole.launches


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
