"""Where the PyTorch port's control step and mission tick spend their
device time.

Runs each controller path of `chip_smoke.py` (bf16 downwash forecast + one
RTI update): the one-kernel step (K1), the two-kernel path (K3 + K2) and
the per-iteration paths (K3, K6 + K7 from the clipped-LQR start, then K4 +
K5 per IPM iteration), warm start, qp_iters=3, bf16 Jacobians; and the
legacy dense path (`backend="pallas_packed"`, cold@12, f32: the dense
linearization, then 13 K8 + K9 sweeps), at B=65536 on one CUDA card for 10
ticks each under `torch.profiler`; then each mission of `chip_smoke.py`
phase 9 through `cli.run_mission` for 30 ticks (10 hold, 20 tracking; one
unprofiled run first): `three_qd_ndp` on the scan controller and on the
kernels (cold@12, the clipped-LQR start), the swarms on the kernels. Prints per path and mission the device time per kernel
name, the wall time per tick and the device's busy share of it.

    python3 tools/profile_torch_step.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import ASSET, CFG, MISSIONS, PATHS, controller, forecast, inputs  # noqa: E402
from ndp_nmpc_qd_tpu_torch import cli  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402

B = 65536
TICKS = 10


def profile_path(path, mlp, dev, smi):
    ctl = controller(dev, **PATHS[path][0])
    x0, xr, ur, other = inputs(B, dev, seed=0)
    state = ctl.reset(xr, ur)

    def tick(state):
        f = forecast(mlp, other, xr, x0, torch.bfloat16)
        return ctl.update(state, x0, xr, ur, f)[1]

    for _ in range(3):
        state = tick(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            state = tick(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / TICKS
    report(f"{path} path; card: {smi}; B={B}, N={CFG.ocp.N_node}, {TICKS} ticks", prof, TICKS,
           wall_ms)


def profile_mission(name, smi, ticks=30):
    """The mission's first `ticks` ticks (a third holding, the rest
    tracking); the wall time per tick is `run_mission`'s, which leaves out
    the episode's set-up, the device time includes it."""
    argv = MISSIONS[name][0]
    hold = ticks // 3
    args = lambda: cli.make_parser().parse_args(
        ["mission", *argv, "--hold-ticks", str(hold),
         "--track-secs", str((ticks - hold) * CFG.ocp.ts_nmpc)])
    cli.run_mission(args())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result, _ = cli.run_mission(args())
    T = result["ticks"]
    report(f"mission {name}; card: {smi}; {result['n_drones']} drones, {T} ticks", prof, T,
           result["ms_per_tick"])


def report(title, prof, ticks, wall_ms):
    rows = []  # kernels only: the aten rows repeat their kernels' time
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total / ticks / 1e3, ev.count // ticks, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(title)
    print(f"wall {wall_ms:.3f} ms/tick (host clock, synchronized, profiler on); "
          f"device busy {busy:.3f} ms/tick ({100 * busy / wall_ms:.1f}%); "
          f"{launches} device kernels a tick")
    print(f"{'device ms/tick':>15} {'calls/tick':>10}  kernel")
    for ms, calls, name in rows[:20]:
        print(f"{ms:15.4f} {calls:10d}  {name[:100]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mlp = load_npz(ASSET, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for path in PATHS:
        profile_path(path, mlp, dev, smi)
    for name in MISSIONS:
        profile_mission(name, smi)


if __name__ == "__main__":
    main()
