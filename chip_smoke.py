"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --small    # CPU rehearsal of the control flow

Phases, one line each; any failure exits non-zero before the last line:
1. device: the card's name and count, then the line
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives.
2. build: nvcc of every kernel source, with ptxas' registers and spills.
3. kernel vs plain: the fused control-step kernel against its plain
   PyTorch version on the card, B=4096, 3 chained ticks (cold, then warm),
   every tick checked, f32 and bf16 payloads, at the tolerances stated in
   `check_pair` (duals and mu at their own scale, so the warm ticks' duals
   near mu are held as well as the cold tick's).
4. main path: bf16 downwash forecast + `reset` + `update` of the deployed
   controller (warm start, 3 QP iterations, bf16 Jacobians) at B=65536:
   health, mean step time over 30 queued ticks (CUDA events), solves/s, the
   kernel's launch count, peak memory.
5. closed loop: 150-tick hover recovery at B=65536 through an RK4 plant that
   feels the same node-0 forecast force the controller was given.
6. kernels: the kernel against its plain version once more, at B=65536 on
   the main path's state with the deployed bf16 payload, then one JSON
   line, each hand-written kernel with its launches on the main path, time,
   bound, plain-version time and error against it.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz, predict_downwash
from ndp_nmpc_qd_tpu_torch.models.quadrotor import (
    body_rate_dynamics, hover_input, hover_state,
)
from ndp_nmpc_qd_tpu_torch.ops.integrators import make_discrete_dynamics
from ndp_nmpc_qd_tpu_torch.ops.kernels import _build, step_whole
from ndp_nmpc_qd_tpu_torch.ops.layout import pack
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import whole_step_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm
from ndp_nmpc_qd_tpu_torch.solver.rti import (
    first_control_and_health, make_batched_rti_controller,
)

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "downwash_analytic_sn4.npz")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores
CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
STATE = ("xb", "ub", "lu_lo", "lu_up", "lx_lo", "lx_up", "mu", "eq")
BF16_ULP = 2.0 ** -8


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def inputs(B, dev, seed):
    """The bench's operating point: hover at random offsets in [-1, 1] m,
    hover references at the origin, the other drone 0.9 m above."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(B, 3, generator=g) * 2.0 - 1.0
    x0 = hover_state(pos).to(dev)
    xr = hover_state(torch.zeros(B, 3, device=dev))[:, None, :].repeat(1, N + 1, 1)
    ur = hover_input(CFG.vehicle, (B,), device=dev)[:, None, :].repeat(1, N, 1)
    other = xr.clone()
    other[..., 2] += 0.9
    return x0, xr, ur, other


def forecast(mlp, other, xr, x0, compute_dtype):
    with torch.no_grad():
        return predict_downwash(
            mlp, other, xr, r_horiz=CFG.downwash.r_horiz, ego_gate_pos=x0[:, 0:3],
            compute_dtype=compute_dtype,
        )


def cuda_ms(fn, reps):
    """Mean ms of `reps` queued calls, CUDA events around the queue."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class OpCount(TorchDispatchMode):
    """Counts the elementwise arithmetic the plain version does."""

    ARITH = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "reciprocal", "abs",
        "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    }

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.ARITH:
            self.ops += out.numel()
        return out


def phase_device(small):
    if small:
        print("device: cpu (--small rehearsal: plain versions, no kernel)")
        return None
    if not torch.cuda.is_available():
        print("device: no CUDA card", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi)
    return dict(platform="gpu", kind=name, count=torch.cuda.device_count())


def phase_build():
    t0 = time.perf_counter()
    _build.build()
    wall = time.perf_counter() - t0
    for name, info in _build.build_info.items():
        ptxas = [
            ln.split(":", 1)[1].strip() for ln in info["log"].splitlines()
            if "ptxas info" in ln and ("Used" in ln or "spill" in ln)
        ]
        print(f"build: {name}.cu in {info['seconds']:.1f} s (wall {wall:.1f} s, "
              f"cached={info['cached']}); ptxas: {' | '.join(ptxas)}")


def scaled_err(a, b):
    """max |a - b| / (max|b| + |b|): the least rtol for which
    |a - b| <= rtol |b| + rtol max|b| holds. The absolute floor is set by the
    tensor's own scale, so duals near mu ~ 1e-11 are held as tightly as
    duals near 1."""
    return float(((a - b).abs() / (b.abs().max() + b.abs()).clamp_min(1e-30)).max())


def pair_errors(k, eq_k, p, eq_p):
    """Kernel state k = [xb, ub, *duals] against plain state p after a step."""
    u0_k, ok_k = first_control_and_health(CFG.ocp, k[0], k[1], eq_k)
    u0_p, ok_p = first_control_and_health(CFG.ocp, p[0], p[1], eq_p)
    e = {n: float((a - b).abs().max()) for n, a, b in zip(STATE, (*k, eq_k), (*p, eq_p))}
    e["iterates_of_max"] = max(
        float((a - b).abs().max() / b.abs().max()) for a, b in zip(k[:2], p[:2]))
    e["duals_scaled"] = max(scaled_err(a, b) for a, b in zip(k[2:], p[2:]))
    e["eq_excess"] = float(((eq_k - eq_p).abs() - 1e-3 * eq_p.abs()).max())
    e["u0"] = float((u0_k - u0_p).abs().max())
    e["ok_mismatch"] = int((ok_k != ok_p).sum())
    e["n_ok"] = int(ok_k.sum())
    e["dual_scale"] = {n: float(b.abs().max()) for n, b in zip(STATE[2:7], p[2:])}
    return e


def check_pair(tag, jac_bf16, e, B):
    """f32 payload: iterates atol 1e-4, duals and mu rtol 1e-3 at their own
    scale, eq_res atol 1e-6 + rtol 1e-3 (nvcc's FMA contraction against
    torch's separately rounded ops, over 3 IPM iterations). bf16 payload:
    u0 atol 1e-3; iterates within one bf16 ulp (2^-8) of each tensor's
    largest entry, duals and mu rtol 2^-8 at their own scale: the f32 values
    before the bf16 rounding differ by an ulp, so one bf16 ulp of a Jacobian
    entry may flip and move the QP's solution by up to that share. Both: the
    `ok` flags identical and every scenario healthy."""
    bad = [what for what, good in (
        ("ok flags differ", e["ok_mismatch"] == 0),
        ("unhealthy scenarios", e["n_ok"] == B),
    ) + ((
        ("u0", e["u0"] <= 1e-3),
        ("iterates", e["iterates_of_max"] <= BF16_ULP),
        ("duals", e["duals_scaled"] <= BF16_ULP),
    ) if jac_bf16 else (
        ("iterates", max(e["xb"], e["ub"]) <= 1e-4),
        ("duals", e["duals_scaled"] <= 1e-3),
        ("eq_res", e["eq_excess"] <= 1e-6),
    )) if not good]
    check(not bad, f"kernel vs plain ({tag}): {', '.join(bad)} out of tolerance: "
          + describe_pair(e))


def describe_pair(e):
    return (", ".join(f"{n} {e[n]:.3g}" for n in STATE)
            + f" (abs); iterates {e['iterates_of_max']:.3g} of their largest entry; "
            f"duals scaled {e['duals_scaled']:.3g} (max|ref| "
            + ", ".join(f"{n} {v:.3g}" for n, v in e["dual_scale"].items())
            + f"); u0 {e['u0']:.3g}; ok mismatches {e['ok_mismatch']}, ok {e['n_ok']}")


def run_pair(B, dev, jac_bf16, seed, mlp, ticks=3):
    """Kernel and plain version side by side on the same inputs, each on its
    own chained state; every tick is checked. Returns the worst of each
    error over the ticks (the dual scales of the last tick)."""
    consts = whole_step_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16, num_iters=3)
    x0, xr, ur, other = inputs(B, dev, seed)
    fd = forecast(mlp, other, xr, x0, None)
    ins = (pack(xr), pack(ur), pack(fd), pack(x0[:, None]))
    k = [pack(xr).clone(), pack(ur).clone(), *cold_warm(N, B, torch.float32, dev)]
    p = [t.clone() for t in k]
    ws = step_whole.make_workspace(B, N, jac_bf16, dev) if dev.type == "cuda" else None
    tag = "bf16" if jac_bf16 else "f32"
    worst = {}
    for tick in range(ticks):
        eq_k = step_whole.control_step_whole(k[0], k[1], *ins, *k[2:], workspace=ws, **consts)
        outs = step_whole.control_step_whole_plain(p[0], p[1], *ins, *p[2:], **consts)
        for dst, src in zip(p, outs[:7]):
            dst.copy_(src)
        e = pair_errors(k, eq_k, p, outs[7])
        for n, v in e.items():
            worst[n] = v if n == "dual_scale" else (
                min(worst.get(n, v), v) if n == "n_ok" else max(worst.get(n, v), v))
        check_pair(f"{tag} payload, B={B}, tick {tick}", jac_bf16, e, B)
    return worst


def phase_compare(B, dev, seed, mlp):
    res = {}
    for jac_bf16 in (False, True):
        tag = "bf16" if jac_bf16 else "f32"
        res[tag] = run_pair(B, dev, jac_bf16, seed, mlp)
        print(f"kernel vs plain ({tag} payload, B={B}, 3 chained ticks, worst over ticks): "
              + describe_pair(res[tag]))
    return res


def deployed_controller(dev):
    return make_batched_rti_controller(
        CFG.ocp, CFG.vehicle, with_disturbance=True, qp_iters=3, warm_start=True,
        jac_bf16=True, whole_ipm=True, packed_state=True, whole_step=True, device=dev,
    )


def phase_main(B, dev, seed, mlp, warm_ticks=3, timed_ticks=30):
    ctl = deployed_controller(dev)
    x0, xr, ur, other = inputs(B, dev, seed)
    step_whole.control_step_whole.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = ctl.reset(xr, ur)
    box = {}

    def tick():
        f = forecast(mlp, other, xr, x0, torch.bfloat16)
        box["u0"], box["state"], box["info"] = ctl.update(box.get("state", state), x0, xr, ur, f)

    for _ in range(warm_ticks):
        tick()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        step_ms = cuda_ms(tick, timed_ticks)
    else:
        t0 = time.perf_counter()
        for _ in range(timed_ticks):
            tick()
        step_ms = (time.perf_counter() - t0) * 1e3 / timed_ticks
    launches = step_whole.control_step_whole.launches
    ticks = warm_ticks + timed_ticks
    info, u0 = box["info"], box["u0"]
    n_ok = int(info.ok.sum())
    finite = bool(torch.isfinite(u0).all())
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    where = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"main path (B={B}, N={N}, qp_iters=3, bf16 Jacobians, warm start): ok {n_ok}/{B}; "
          f"step {step_ms:.3f} ms mean over {timed_ticks} queued ticks ({where}); "
          f"{B / step_ms * 1e3:.0f} solves/s; step_whole launches {launches} for {ticks} ticks; "
          f"max eq_res {float(info.eq_res.max()):.3g}; peak memory {peak:.2f} GiB")
    check(finite and u0.shape == (B, 4), "u0 not finite or of the wrong shape")
    check(n_ok == B, f"main path: {B - n_ok} unhealthy scenarios")
    if dev.type == "cuda":
        check(launches == ticks, f"step_whole launched {launches} times for {ticks} ticks")
    return dict(ctl=ctl, state=box["state"], x0=x0, xr=xr, ur=ur, other=other,
                launches=launches, ticks=ticks, step_ms=step_ms)


def phase_closed_loop(B, dev, seed, mlp, ticks=150):
    ctl = deployed_controller(dev)
    x, xr, ur, other = inputs(B, dev, seed + 1)
    plant = make_discrete_dynamics(
        lambda xx, uu, fd: body_rate_dynamics(
            xx, uu, fd, mass=CFG.vehicle.mass, gravity=CFG.vehicle.gravity),
        CFG.ocp.ts_nmpc,
    )
    state = ctl.reset(xr, ur)
    before = step_whole.control_step_whole.launches
    err0 = float((x[:, 0:3] - xr[:, 0, 0:3]).norm(dim=-1).max())
    for _ in range(ticks):
        f = forecast(mlp, other, xr, x, torch.bfloat16)
        u0, state, info = ctl.update(state, x, xr, ur, f)
        x = plant(x, u0, f[:, 0])
    err = float((x[:, 0:3] - xr[:, 0, 0:3]).norm(dim=-1).max())
    n_ok = int(info.ok.sum())
    launches = step_whole.control_step_whole.launches - before
    print(f"closed loop (B={B}, {ticks} ticks of {CFG.ocp.ts_nmpc} s): max |pos - ref| "
          f"{err0:.3f} -> {err:.3g} m; healthy {n_ok}/{B} at the last tick; "
          f"step_whole launches {launches}")
    check(err < 0.02, f"hover recovery left {err} m")
    check(n_ok == B, f"closed loop: {B - n_ok} unhealthy scenarios")
    if dev.type == "cuda":
        check(launches == ticks, f"closed loop launched {launches} times for {ticks} ticks")


def phase_kernels(main, compare, mlp):
    """Hold K1 against its plain version at the main path's size, on the
    main path's state and inputs with the deployed bf16 payload, then time
    both."""
    dev = main["x0"].device
    B = main["x0"].shape[0]
    consts = whole_step_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=True, num_iters=3)
    st = main["state"]
    f = forecast(mlp, main["other"], main["xr"], main["x0"], torch.bfloat16)
    ins = (pack(main["xr"]), pack(main["ur"]), pack(f), pack(main["x0"][:, None]))
    k_state = [st.x_bar.clone(), st.u_bar.clone(), *[t.clone() for t in st.ipm]]
    p_state = [t.clone() for t in k_state]
    ws = step_whole.make_workspace(B, N, True, dev)

    def run_kernel():
        return step_whole.control_step_whole(k_state[0], k_state[1], *ins, *k_state[2:],
                                             workspace=ws, **consts)

    def run_plain():
        return step_whole.control_step_whole_plain(p_state[0], p_state[1], *ins,
                                                   *p_state[2:], **consts)

    saved = step_whole.control_step_whole.launches
    eq_k = run_kernel()
    outs = run_plain()
    for dst, src in zip(p_state, outs[:7]):
        dst.copy_(src)
    e = pair_errors(k_state, eq_k, p_state, outs[7])
    print(f"kernel vs plain (bf16 payload, B={B}, one tick from the main path's state): "
          + describe_pair(e))
    check_pair(f"bf16 payload, B={B}", True, e, B)
    ms = cuda_ms(run_kernel, 10)
    step_whole.control_step_whole.launches = saved  # checks and timing are not the main path's
    plain_ms = cuda_ms(run_plain, 1)

    # bound: each input read once and each output written once, and the
    # arithmetic the plain version does on a slice of these inputs
    read = sum(t.numel() for t in (*k_state, *ins)) * 4
    written = (k_state[0].numel() + k_state[1].numel()
               + sum(t.numel() for t in k_state[2:]) + B) * 4
    cpu = lambda t: t[..., :64].to("cpu")
    counter = OpCount()
    with counter, torch.no_grad():
        step_whole.control_step_whole_plain(*(cpu(t) for t in k_state[:2]),
                                            *(cpu(t) for t in ins),
                                            *(cpu(t) for t in k_state[2:]), **consts)
    flops = counter.ops / 64 * B
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    entry = dict(
        name="control_step_whole", route="cuda",
        source="ndp_nmpc_qd_tpu_torch/csrc/step_whole.cu",
        replaces="ndp_nmpc_qd_tpu/ops/pallas/step_whole.py:184",
        launches=main["launches"], launches_per_tick=main["launches"] / main["ticks"],
        # bf16 payload at B=65536, every output; then the f32 payload at B=4096
        max_abs_err=max(e[n] for n in STATE), u0_abs_err=e["u0"],
        max_abs_err_f32_payload=max(compare["f32"][n] for n in STATE),
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, B=B, bytes=read + written, flops=flops,
    )
    print(json.dumps({"kernels": [entry]}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="CPU rehearsal at B=8 with the plain versions; prints no result")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.small and torch.cuda.is_available():
        sys.exit("--small is the CPU rehearsal; a card is present, run without it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = phase_device(args.small)
    dev = torch.device("cpu" if args.small else "cuda")
    mlp = load_npz(ASSET, device=dev)
    try:
        if args.small:
            main_ = phase_main(8, dev, args.seed, mlp, warm_ticks=1, timed_ticks=2)
            phase_closed_loop(8, dev, args.seed, mlp)
            print("rehearsal done: no kernel ran, so no result is printed")
            sys.exit(2)
        phase_build()
        compare = phase_compare(4096, dev, args.seed, mlp)
        main_ = phase_main(65536, dev, args.seed, mlp)
        phase_closed_loop(65536, dev, args.seed, mlp)
        phase_kernels(main_, compare, mlp)
    except Fail as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
