"""Far-regime QP envelope sweep on the PyTorch port: `tools/qp_envelope.py`.

One RTI update from a hover state offset by d meters along x (d = --step
... --max-d) toward a hover reference at the origin; prints one JSON line
with `n_ok`, `first_not_ok_m` and `max_eq_res` as the JAX tool does, then
the scenarios around the first d that is not ok.

The flags map to `make_batched_rti_controller` as the JAX tool passes them
(`tools/qp_envelope.py:64-69`):
- `--backend jax` (the default): the scan controller, plain PyTorch;
  `--mehrotra` selects its predictor-corrector IPM. The kernel flags do not
  apply to it, as in JAX.
- `--backend pallas`: the port's kernels, batch-first state:
  - `--whole-ipm`: K3 + K2 (the two-kernel path), from the zero start;
  - `--no-lqr-start`: K3, then K4 + K5 each IPM iteration, from the zero
    start;
  - neither: K3, then K6 + K7 (the clipped-LQR start), then K4 + K5;
  - `--warm` sets `warm_start`, `--bf16` sets `jac_bf16`.
The sweep runs on the card in float32 (the JAX tool's `--tpu`); `--cpu`
runs it on the CPU, in float64 unless `--f32` (the JAX tool's default is
the CPU). Without a card and without `--cpu` the tool fails. `sweep` takes
any built controller, so other paths (the deployed one-kernel step) run
the same sweep.

Usage: python tools/qp_envelope_torch.py [--iters 12] [--max-d 100]
       [--backend jax|pallas] [--whole-ipm] [--no-lqr-start] [--warm] [--bf16] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state  # noqa: E402
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller  # noqa: E402


def offsets(max_d: float = 100.0, step: float = 1.0) -> np.ndarray:
    return np.arange(step, max_d + 1e-9, step)


def sweep(ctl, ds, dtype, device):
    """One update of `ctl` from hover at (d, 0, 0) for each d of `ds`, the
    reference hover at the origin, no disturbance force. Returns numpy
    arrays u0 (B, 4), ok, eq_res and mu (B,)."""
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, len(ds)
    pos = np.zeros((B, 3))
    pos[:, 0] = ds
    x0 = hover_state(torch.as_tensor(pos, dtype=dtype, device=device))
    xr = hover_state(torch.zeros(B, 3, dtype=dtype, device=device))[:, None, :].repeat(
        1, N + 1, 1)
    ur = hover_input(cfg.vehicle, (B,), dtype, device)[:, None, :].repeat(1, N, 1)
    f = torch.zeros(B, N + 1, 3, dtype=dtype, device=device)
    st = ctl.reset(xr, ur)
    u0, _, info = ctl.update(st, x0, xr, ur, f)
    return {k: t.detach().cpu().numpy() for k, t in
            dict(u0=u0, ok=info.ok, eq_res=info.eq_res, mu=info.mu).items()}


def summary(ds, res) -> dict:
    """The JAX tool's counts: scenarios ok, the first d not ok (None if
    every one is), the largest equality residual."""
    bad = np.flatnonzero(~res["ok"])
    return {"n_ok": int(res["ok"].sum()), "n": len(ds),
            "first_not_ok_m": float(ds[bad[0]]) if bad.size else None,
            "max_eq_res": float(res["eq_res"].max())}


def boundary_lines(ds, res, step):
    """The JAX tool's detail: the scenarios around the first d not ok."""
    s = summary(ds, res)
    if s["first_not_ok_m"] is None:
        return []
    i = int(s["first_not_ok_m"] / step) - 1
    return [f"  d={ds[k]:6.1f} ok={bool(res['ok'][k])} eq_res={res['eq_res'][k]:.3e} "
            f"mu={float(res['mu'][k]):.3e}" for k in range(max(0, i - 3), min(len(ds), i + 4))]


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--max-d", type=float, default=100.0)
    ap.add_argument("--step", type=float, default=1.0)
    ap.add_argument("--backend", default="jax", choices=["jax", "pallas"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64 unless --f32)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--mehrotra", action="store_true")
    ap.add_argument("--no-lqr-start", action="store_true",
                    help="zero-control-rollout start only (pallas backend)")
    ap.add_argument("--whole-ipm", action="store_true",
                    help="the whole IPM in one kernel, K2 (pallas backend; implies the "
                    "zero-control start)")
    ap.add_argument("--bf16", action="store_true",
                    help="split-precision bf16 stage payload (pallas backend)")
    return ap


def run(args) -> dict:
    """Build the controller the flags name and sweep it. Returns the JSON
    line's fields and, under "lines", the boundary detail."""
    dev = torch.device("cpu") if args.cpu else resolve_device()
    dtype = torch.float64 if args.cpu and not args.f32 else torch.float32
    cfg = NdpNmpcConfig()
    lqr_start = not (args.no_lqr_start or args.whole_ipm)
    ctl = make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=args.iters,
        backend=args.backend, warm_start=args.warm, mehrotra=args.mehrotra,
        lqr_start=lqr_start, whole_ipm=args.whole_ipm, jac_bf16=args.bf16, device=dev,
    )
    ds = offsets(args.max_d, args.step)
    res = sweep(ctl, ds, dtype, dev)
    return {
        "iters": args.iters, "backend": args.backend, "warm": args.warm,
        "lqr_start": lqr_start, "whole_ipm": args.whole_ipm, "bf16": args.bf16,
        "mehrotra": args.mehrotra, "dtype": str(dtype).removeprefix("torch."),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **summary(ds, res), "lines": boundary_lines(ds, res, args.step),
    }


def main(argv=None):
    out = run(make_parser().parse_args(argv))
    lines = out.pop("lines")
    print(json.dumps(out))
    for line in lines:
        print(line)
    return out


if __name__ == "__main__":
    main()
