"""Where the PyTorch port's deployed control step spends its device time,
by component: `tools/profile_trace.py`.

Runs the deployed step (the bf16 downwash forecast + one RTI update of
`make_batched_rti_controller` with `deployed.FLAGS`, `bench_torch.py`'s: warm start,
bf16 Jacobians, the whole IPM, kernel-layout state, the one-kernel step
K1) at B (default 32768) for 5 ticks under `torch.profiler` after a
warm-up tick, puts every CUDA kernel of the trace in exactly one bucket
(`bucket_of`: K1 `step_whole_kernel`; `ipm_kernel` K2 and the Riccati
sweeps K4-K9; `linearize_kernel` K3; `mlp_matmuls` cuBLAS GEMMs;
`layout_copies` copies, cat and transposes; `torch_glue` elementwise,
reduce and index kernels; `other`), adds `idle` (the traced window on the
device's clock, first kernel start to last kernel end, less the time a
kernel ran), and prints each bucket's device us a tick.

Then the device-only interactive tick: at B=1 the scan controller
(`make_rti_controller`, cold@12) and the deployed kernel, at B=64 the
batched scan controller and the deployed kernel, 5 traced ticks each:
the kernels' device time a tick, which leaves out the host (the 20 ms
real-time contract, `nmpc_node.py:216-220`, is judged against it).

    python tools/profile_trace_torch.py [B] [--skip-interactive]
        [--qp-iters 3] [--no-whole-step] [--no-mlp-bf16] [--out PATH]

The JAX tool's `BENCH_QP_ITERS`, `BENCH_WHOLE_STEP` and `BENCH_MLP_BF16`
are the flags here (`--no-whole-step`: K3 + K2 a tick). Writes the JAX
tool's keys (`step_attribution`, `interactive_device_only`) to `--out`
(default build/profile_trace_torch.json). Runs on the card only: without
one it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ndp_nmpc_qd_tpu_torch import resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.deployed import (  # noqa: E402
    ASSET, CFG, FLAGS, card_line, control_step, inputs,
)
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.rti import (  # noqa: E402
    make_batched_rti_controller, make_rti_controller,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 5  # traced ticks
INTERACTIVE_BS = (1, 64)
DEADLINE_MS = 20.0
BUCKETS = ("ipm_kernel", "linearize_kernel", "step_whole_kernel", "mlp_matmuls",
           "layout_copies", "torch_glue", "idle", "other")
IPM_KERNELS = ("ipm_whole_kernel", "riccati_")  # K2; K4/K5, K6/K7, K8/K9
GEMM_MARKS = ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet", "splitkreduce")
COPY_MARKS = ("copy", "memcpy", "transpose", "catarray")
GLUE_MARKS = ("elementwise", "reduce", "index", "scatter", "gather", "fill", "memset",
              "at::native", "at_cuda_detail", "cub::", "sort", "scan")


def bucket_of(name: str) -> str:
    """The bucket of one CUDA kernel (or device memcpy/memset) by its name:
    exactly one of BUCKETS other than "idle"."""
    n = name.lower()
    if "step_whole_kernel" in n:
        return "step_whole_kernel"
    if any(k in n for k in IPM_KERNELS):
        return "ipm_kernel"
    if "linearize_kernel" in n:
        return "linearize_kernel"
    if any(k in n for k in GEMM_MARKS):
        return "mlp_matmuls"
    if any(k in n for k in COPY_MARKS):
        return "layout_copies"
    if any(k in n for k in GLUE_MARKS):
        return "torch_glue"
    return "other"


def attribute(kernels, n_steps):
    """Per-tick attribution of a trace's kernels.

    `kernels`: (name, start_us, end_us) of every device kernel in the
    traced window. Returns (per_component_us, device_total_us, busy_us),
    each a tick: every kernel's time in its bucket, `idle` the window
    (first start to last end) less the union of the kernels' intervals,
    the total the window. With no overlap the buckets sum to the total."""
    buckets = dict.fromkeys(BUCKETS, 0.0)
    spans = sorted((s, e) for _, s, e in kernels)
    for name, s, e in kernels:
        buckets[bucket_of(name)] += e - s
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    buckets["idle"] = window - busy
    return ({k: v / n_steps for k, v in buckets.items()}, window / n_steps, busy / n_steps)


def device_kernels(prof):
    """(name, start_us, end_us) of every device event of a profile."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start]


def capture(step, carry, n_steps=N_STEPS):
    """`n_steps` ticks of `carry = step(carry)` under the profiler after one
    warm-up tick. Returns (kernels, host wall ms a tick)."""
    from torch.profiler import ProfilerActivity, profile

    carry = step(carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            carry = step(carry)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    return device_kernels(prof), wall


def deployed(qp_iters, whole_step, dev):
    return make_batched_rti_controller(CFG.ocp, CFG.vehicle, device=dev,
                                       **dict(FLAGS, qp_iters=qp_iters, whole_step=whole_step))


def step_attribution(B, qp_iters=3, whole_step=True, mlp_bf16=True, dev=None):
    """The deployed step's attribution at B (JAX's `step_attribution`)."""
    dev = resolve_device(dev)
    ctl = deployed(qp_iters, whole_step, dev)
    step = control_step(ctl, load_npz(ASSET, device=dev), mlp_bf16)
    ins = inputs(B, dev, 0)
    with torch.no_grad():
        kernels, wall = capture(lambda st: step(st, *ins)[1], ctl.reset(ins[1], ins[2]))
    per, total, busy = attribute(kernels, N_STEPS)
    return {
        "B": B, "n_steps_traced": N_STEPS,
        "device_total_us_per_step": total, "device_busy_us_per_step": busy,
        "wall_ms_per_step": wall, "kernels_per_step": len(kernels) / N_STEPS,
        "per_component_us": per,
        "config": {"qp_iters": qp_iters, "whole_ipm": True, "jac_bf16": True,
                   "packed_state": True, "whole_step": whole_step, "mlp_bf16": mlp_bf16},
    }


def interactive(qp_iters=3, whole_step=True, dev=None):
    """The device-only interactive tick (JAX's `interactive_device_only`):
    at B=1 and 64 the scan controller (B=1 the per-scenario one) and the
    deployed kernel, 5 traced ticks each."""
    dev = resolve_device(dev)
    x0, xr, ur, _ = inputs(max(INTERACTIVE_BS), dev, 0)
    N = CFG.ocp.N_node
    out = {}
    for Bi in INTERACTIVE_BS:
        f = torch.zeros(Bi, N + 1, 3, device=dev)
        if Bi == 1:
            scan = (make_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True, device=dev),
                    (x0[0], xr[0], ur[0], f[0]))
        else:
            scan = (make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                                backend="jax", device=dev),
                    (x0[:Bi], xr[:Bi], ur[:Bi], f))
        cases = [("jax_scan", *scan), ("pallas_whole_step", deployed(qp_iters, whole_step, dev),
                                       (x0[:Bi], xr[:Bi], ur[:Bi], f))]
        for label, ctl, args in cases:
            with torch.no_grad():
                kernels, wall = capture(lambda st, c=ctl, a=args: c.update(st, *a)[1],
                                        ctl.reset(args[1], args[2]))
            _, _, busy = attribute(kernels, N_STEPS)
            key = f"B{Bi}" if label == "jax_scan" else f"B{Bi}_{label}"
            out[key] = {
                "device_us_per_tick": busy, "deadline_ms": DEADLINE_MS,
                "meets_deadline_device": busy / 1e3 < DEADLINE_MS, "backend": label,
                "config": ("cold@12 scan solver" if label == "jax_scan" else
                           f"deployed kernel (warm@{qp_iters}, bf16, "
                           f"{'K1' if whole_step else 'K3 + K2'})"),
                "wall_ms_per_tick": wall, "kernels_per_tick": len(kernels) / N_STEPS,
            }
            print(f"interactive device-only B={Bi} [{label}]: {busy / 1e3:.3f} ms/tick "
                  f"(wall {wall:.3f} ms, profiler on; {len(kernels) / N_STEPS:.0f} kernels a "
                  f"tick; 20 ms budget)", file=sys.stderr)
    return out


def report(att, file=sys.stderr):
    total = att["device_total_us_per_step"]
    print(f"per-step device time {total:.1f} us (busy {att['device_busy_us_per_step']:.1f}, "
          f"wall {att['wall_ms_per_step']:.3f} ms with the profiler on), attribution (us):",
          file=file)
    for k, v in sorted(att["per_component_us"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:>18}: {v:9.1f}  ({100 * v / max(total, 1e-9):.1f}%)", file=file)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=32768)
    ap.add_argument("--skip-interactive", action="store_true")
    ap.add_argument("--qp-iters", type=int, default=3, help="BENCH_QP_ITERS of the JAX tool")
    ap.add_argument("--no-whole-step", dest="whole_step", action="store_false",
                    help="BENCH_WHOLE_STEP=0: K3 + K2 a tick")
    ap.add_argument("--no-mlp-bf16", dest="mlp_bf16", action="store_false",
                    help="BENCH_MLP_BF16=0: the forecast in f32")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_trace_torch.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    att = step_attribution(args.B, args.qp_iters, args.whole_step, args.mlp_bf16, dev)
    details = {"card": card_line(), "step_attribution": att}
    report(att)
    if not args.skip_interactive:
        details["interactive_device_only"] = interactive(args.qp_iters, args.whole_step, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(details, fh, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return details


if __name__ == "__main__":
    main()
