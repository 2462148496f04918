"""The whole-IPM kernel against the per-iteration kernels on the PyTorch
port: `tools/bench_ipm_whole.py`.

Builds one linearized QP batch (K3, f32 payload; hover at uniform offsets
in [-3, 3] m, the linearization point's attitude jittered, a random
disturbance force, seeded) and solves it with `ipm_sparse` both ways from
the zero-control start with the carried duals: `whole_kernel=True` (K2,
one launch a solve) and `whole_kernel=False` (K4 + K5 each iteration, the
glue-fused sweep). The first, cold solves are held against each other
element by element (`testing.compare`: zx, zu at the primal tolerance, the
duals and mu at the dual one, eq_res at the residual one; exit 1 on a
miss). Then each is timed over 20 solves that carry the duals from one
solve to the next (CUDA events around the queue), and both times print
with the card's name and power limit. Runs on the card; `--cpu` runs the
plain versions on the CPU (no time is a device time there), and without a
card and without `--cpu` it fails.

    python tools/bench_ipm_whole_torch.py [B] [iters] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from ndp_nmpc_qd_tpu_torch import resolve_device, testing  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state  # noqa: E402
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import make_linearizer  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm, cold_warm, ipm_sparse  # noqa: E402


def qp_batch(B, dev, seed=0):
    """The JAX tool's QP batch, from a seeded torch generator."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(B, 3, generator=g) * 6.0 - 3.0
    x0 = hover_state(pos).to(dev)
    xr = hover_state(torch.zeros(B, 3))[:, None, :].repeat(1, N + 1, 1).to(dev)
    xb = xr.clone()
    xb[:, :, 6:10] += 0.1 * torch.randn(B, N + 1, 4, generator=g).to(dev)
    ur = hover_input(cfg.vehicle, (B,), device=dev)[:, None, :].repeat(1, N, 1)
    f = (0.3 * torch.randn(B, N + 1, 3, generator=g)).to(dev)
    lin, consts = make_linearizer(cfg.ocp, cfg.vehicle, True)
    with torch.no_grad():
        qp, dx0_p = lin(xb, ur, xr, ur, f, x0)
    return qp, consts, dx0_p


def solve(qp, consts, dx0_p, warm, iters, whole):
    """One solve; `warm` is copied first (K2 updates it in place)."""
    warm = IpmWarm(*(t.clone() for t in warm))
    return ipm_sparse(qp, consts, dx0_p, num_iters=iters, warm=warm, lqr_start=False,
                      whole_kernel=whole)


def timed(qp, consts, dx0_p, warm, iters, whole, reps):
    """Mean ms a solve over `reps` solves, each from the duals the previous
    one left (CUDA events on the card, the host clock on the CPU)."""
    warm = IpmWarm(*(t.clone() for t in warm))
    dev = dx0_p.device
    run = lambda w: ipm_sparse(qp, consts, dx0_p, num_iters=iters, warm=w, lqr_start=False,
                               whole_kernel=whole)[4]
    warm = run(warm)  # warm-up
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
        ev[0].record()
        for _ in range(reps):
            warm = run(warm)
        ev[1].record()
        torch.cuda.synchronize(dev)
        return ev[0].elapsed_time(ev[1]) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        warm = run(warm)
    return (time.perf_counter() - t0) * 1e3 / reps


def run(B=4096, iters=6, reps=20, dev=None, seed=0):
    """Check and time both solvers at B. Returns the JSON-ready result,
    with "bad" listing the outputs out of tolerance."""
    qp, consts, dx0_p = qp_batch(B, dev, seed)
    N = qp.gx.shape[0] - 1
    cold = cold_warm(N, B, qp.gx.dtype, dev)
    out = {}
    with torch.no_grad():
        for name, whole in (("per-iter", False), ("whole", True)):
            out[name] = solve(qp, consts, dx0_p, cold, iters, whole)
        (zx_a, zu_a, mu_a, eq_a, w_a), (zx_b, zu_b, mu_b, eq_b, w_b) = out.values()
        named = {"zx": ("primal", zx_b, zx_a), "zu": ("primal", zu_b, zu_a),
                 "mu": ("dual", mu_b, mu_a), "eq": ("resid", eq_b, eq_a)}
        named |= {n: ("dual", b, a) for n, a, b in zip(testing.DUAL_NAMES[:4], w_a, w_b)}
        errs, bad = testing.compare(named)
        ms = {name: timed(qp, consts, dx0_p, cold, iters, name == "whole", reps)
              for name in ("per-iter", "whole")}
    return {
        "B": B, "iters": iters, "reps": reps,
        "card": bench_torch.card_line() if dev.type == "cuda" else "cpu",
        "per_iter_ms": ms["per-iter"], "whole_ms": ms["whole"],
        "speedup": ms["per-iter"] / ms["whole"],
        "whole_solves_per_s": B / ms["whole"] * 1e3, "errors": errs, "bad": bad,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("iters", nargs="?", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()
    res = run(args.B, args.iters, dev=dev)
    for name in ("per-iter", "whole"):
        key = "per_iter_ms" if name == "per-iter" else "whole_ms"
        print(f"{name:9s} B={args.B} iters={args.iters} steady={res[key]:.3f} ms "
              f"({args.B / res[key] / 1e3:.2f}M solves/s IPM-only) on {res['card']}",
              file=sys.stderr)
    print(f"whole vs per-iter, cold solve: {testing.describe(res['errors'])}; speedup (IPM "
          f"only) {res['speedup']:.2f}x", file=sys.stderr)
    print(json.dumps(res))
    if res["bad"]:
        raise SystemExit(f"whole vs per-iter out of tolerance: {res['bad']}")
    return res


if __name__ == "__main__":
    main()
