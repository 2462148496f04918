"""Marginal cost of one IPM iteration in the PyTorch port's batched control
step: `tools/profile_step.py`.

Times the default batched controller (`make_batched_rti_controller` with
the disturbance and the warm start: the per-iteration path from the
clipped-LQR start, which launches K3, then K6 + K7, then K4 + K5 each IPM
iteration) at qp_iters 0, 6 and 12, then at (6, no LQR start), (4, LQR
start) and (4, no LQR start). Each time is 8 chained ticks (u0 fed back into
x0, as the JAX tool does), repeated, after one warm-up chain; CUDA events
around the queue. The marginal of one iteration is (t(12) - t(6)) / 6 and
the extrapolated 0-iteration base t(6) - 6 x marginal (`profile_step.py:96-103`).
Then the kernels alone at the same batch, chained the same way: K6 + K7
(the raw Newton sweep), K3 (the linearization) and K4 + K5 (one glue-fused
iteration); the glue of an iteration is the marginal less K4 + K5.

    python tools/profile_step_torch.py [B]

Runs on the card only: without one it fails. Prints the lines to stderr,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ndp_nmpc_qd_tpu_torch import resolve_device, testing  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state  # noqa: E402
from ndp_nmpc_qd_tpu_torch.ops.kernels.riccati_sparse import (  # noqa: E402
    riccati_iter_fused, riccati_sweep_sparse,
)
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, make_linearizer  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller  # noqa: E402

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
SWEEP = (0, 6, 12)
VARIANTS = ((6, False), (4, True), (4, False))
TICKS = 8  # chained ticks a timed call
REPS = 10  # timed calls after the warm-up


def marginal(t):
    """`profile_step.py:96-103`: the per-IPM-iteration marginal (t(12) -
    t(6)) / 6 and the extrapolated 0-iteration base t(6) - 6 x marginal,
    from {qp_iters: seconds a tick}."""
    per_iter = (t[12] - t[6]) / 6.0
    return per_iter, t[6] - 6 * per_iter


def inputs(B, dev):
    """The JAX tool's point: hover at uniform offsets in [-1, 1] m (seed 0),
    hover references at the origin, no disturbance force."""
    pos = torch.rand(B, 3, generator=torch.Generator().manual_seed(0)) * 2.0 - 1.0
    x0 = hover_state(pos).to(dev)
    xr = hover_state(torch.zeros(B, 3)).to(dev)[:, None, :].repeat(1, N + 1, 1)
    ur = hover_input(CFG.vehicle, (B,), device=dev)[:, None, :].repeat(1, N, 1)
    return x0, xr, ur, torch.zeros(B, N + 1, 3, device=dev)


def timed(fn, carry, dev):
    """Seconds of one `carry = fn(carry)` (after one warm-up call): CUDA
    events around REPS queued calls."""
    carry = fn(carry)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(dev)
    ev[0].record()
    for _ in range(REPS):
        carry = fn(carry)
    ev[1].record()
    torch.cuda.synchronize(dev)
    return ev[0].elapsed_time(ev[1]) / 1e3 / REPS


def chained_time(ctl, ins):
    """Seconds a tick over TICKS chained ticks, u0 fed back into x0 so no
    tick repeats another (`profile_step.py:62-67`)."""
    x0, xr, ur, f = ins

    def chain(carry):
        rti, x = carry
        for _ in range(TICKS):
            u0, rti, _ = ctl.update(rti, x, xr, ur, f)
            x = torch.cat([x[:, 0:3], x[:, 3:6] + 1e-9 * u0[:, 0:3], x[:, 6:]], dim=-1)
        return rti, x

    with torch.no_grad():
        return timed(chain, (ctl.reset(xr, ur), x0), x0.device) / TICKS


def kernel_times(ins):
    """The kernels alone at the same batch, chained: K6 + K7 (the raw sweep
    at zero sig/corr, no clip, `profile_step.py:105-141`), K3
    (`:143-152`) and K4 + K5 (one glue-fused iteration at the
    per-iteration path's start). Seconds a call."""
    x0, xr, ur, f = ins
    lin, consts = make_linearizer(CFG.ocp, CFG.vehicle, True)
    kern = consts._asdict()
    ic = ipm_consts(CFG.ocp, num_iters=1)
    xb0 = x0[:, None].repeat(1, N + 1, 1)
    out = {}
    with torch.no_grad():
        qp, dx0_p = lin(xb0, ur, xr, ur, f, x0)
        B = x0.shape[0]
        z = lambda *s: torch.zeros(s, dtype=qp.gx.dtype, device=qp.gx.device)
        zsu, zs3 = z(N, 4, B), z(N + 1, 3, B)

        def sweeps(c):
            zx, zu = c
            for _ in range(TICKS):
                dx, du, _ = riccati_sweep_sparse(*qp[:7], zx, zu, zsu, zs3, zsu, zs3, dx0_p,
                                                 **kern)
                zx, zu = zx + 1e-9 * dx, zu + 1e-9 * du
            return zx, zu

        out["K6+K7"] = timed(sweeps, (z(N + 1, 10, B), zsu.clone()), x0.device) / TICKS

        def lins(c):
            xb, _ = c
            for _ in range(TICKS):
                q, _ = lin(xb, ur, xr, ur, f, x0)
                xb = xb + 1e-9 * q.r.sum()
            return xb, None

        out["K3"] = timed(lins, (xb0, None), x0.device) / TICKS

        args = list(testing.iter_args((*qp, dx0_p), ic))
        fused_kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage", "tau")}

        def iters(c):
            zx, zu = c
            for _ in range(TICKS):
                args[7], args[8] = zx, zu
                outs = riccati_iter_fused(*args, **fused_kw)
                zx, zu = zx + 1e-9 * outs[0], zu + 1e-9 * outs[1]
            return zx, zu

        out["K4+K5"] = timed(iters, (args[7], args[8]), x0.device) / TICKS
    return out


def run(B=4096):
    """The sweep, the variants and the kernels alone at B on the card.
    Returns the JSON-ready result, times in ms a tick (or a call)."""
    dev = resolve_device(None)
    ins = inputs(B, dev)
    make = lambda iters, lqr: make_batched_rti_controller(
        CFG.ocp, CFG.vehicle, with_disturbance=True, qp_iters=iters, warm_start=True,
        lqr_start=lqr, device=dev)
    t = {it: chained_time(make(it, True), ins) for it in SWEEP}
    for it in SWEEP:
        print(f"qp_iters={it:2d}: {t[it] * 1e3:.3f} ms/step", file=sys.stderr)
    var = {}
    for it, lqr in VARIANTS:
        var[f"{it}_lqr_start_{lqr}"] = chained_time(make(it, lqr), ins) * 1e3
        print(f"qp_iters={it:2d} lqr_start={lqr}: {var[f'{it}_lqr_start_{lqr}']:.3f} ms/step",
              file=sys.stderr)
    res = {"B": B, "device": str(dev), "ticks_chained": TICKS, "reps": REPS,
           "qp_iters_ms": {str(it): v * 1e3 for it, v in t.items()}, "variants_ms": var}
    per_iter, base = marginal(t)
    res |= {"per_iter_marginal_us": per_iter * 1e6, "base_extrapolated_ms": base * 1e3}
    print(f"per-IPM-iteration marginal: {per_iter * 1e6:.1f} us  (extrapolated 0-iter base "
          f"{base * 1e3:.3f} ms, measured 0-iter {t[0] * 1e3:.3f} ms)", file=sys.stderr)
    k = kernel_times(ins)
    res["kernels_us"] = {name: v * 1e6 for name, v in k.items()}
    print(f"raw sweep (K6 + K7) marginal: {k['K6+K7'] * 1e6:.1f} us", file=sys.stderr)
    print(f"linearization kernel (K3) marginal: {k['K3'] * 1e6:.1f} us", file=sys.stderr)
    print(f"fused iteration (K4 + K5) marginal: {k['K4+K5'] * 1e6:.1f} us", file=sys.stderr)
    glue = res["per_iter_marginal_us"] - res["kernels_us"]["K4+K5"]
    res |= {"glue_us": glue, "glue_share": glue / res["per_iter_marginal_us"]}
    print(f"glue an iteration (marginal - K4 - K5): {glue:.1f} us "
          f"({100 * res['glue_share']:.1f}% of the marginal)", file=sys.stderr)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=4096)
    args = ap.parse_args(argv)
    res = run(args.B)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
