"""Benchmark of the PyTorch port: batched NDP-NMPC solves/s on one CUDA card.

    python3 bench_torch.py [--details PATH] [--seed N]

The port's counterpart of `bench.py` (which runs the JAX package on a TPU).
It measures the deployed fused control step — bf16 downwash-MLP forecast +
one RTI update of `make_batched_rti_controller` (warm start, 3 QP
iterations, bf16 Jacobians, the one-kernel step K1) — and the per-drone
daemon's tick, on the card:

1. `throughput`: the step at B=65536, mean over 30 queued ticks (CUDA
   events, and wall time), the blocking tick's p50/p90 over 10, ok/B.
2. `throughput_multitick`: K=64 ticks captured once in a CUDA graph and
   replayed 4 times (the analog of `bench.py`'s `lax.scan` row); each tick's
   inputs drift with its index, read from static tensors, so the forecast
   and the linearization stay live; the replay held against the same ticks
   run eagerly from a copy of the state.
3. Interactive rows, the `ControllerDaemon` tick: the scan controller
   cold@12 (`interactive_B1`, `_B64`) and the deployed kernel
   (`interactive_B1_packed`, `_B64_packed`) at B=1 and 64, each 10 warm
   ticks, then 200 blocking ticks and 200 dispatch-ahead ticks (`_pipelined`:
   a tick queues its solve and waits for the previous tick's command, by the
   daemon's own `HostLink`), p50/p99 against the 20 ms deadline, the cyclic
   GC off.
4. `cpu_daemon_tick`: the scan controller at B=1 on the CPU in float64 (the
   program of `serve --cpu`), 50 warm ticks, then 1000.
5. The headline: the better of rows 1 and 2.
6. `roofline`: the deployed step's memory traffic and operations a solve,
   counted from its layouts (`utils/roofline.py`, `bench.py:304-332`'s
   line), at row 1's solves/s against the H100's peaks (HBM 3.35 TB/s, f32
   67 TFLOP/s): a lower bound on the share the step reaches.

Prints ONE JSON line on stdout in `bench.py`'s schema (`metric`
ndp_nmpc_solves_per_s_chip, `value`, `unit`, `vs_baseline` = solves/s / 50:
the reference runs one solve per 20 ms period per device; `roofline`);
diagnostics go to
stderr, every row to `--details` (default build/bench_torch_details.json).
Without a card it fails: there is no CPU fallback. `BENCH_*` environment
variables mirror `bench.py`'s for the rows that exist.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz, predict_downwash
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state
from ndp_nmpc_qd_tpu_torch.ops.kernels import step_whole
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.runtime.nodes import HostLink
from ndp_nmpc_qd_tpu_torch.solver.rti import (
    RtiState, make_batched_rti_controller, make_rti_controller,
)
from ndp_nmpc_qd_tpu_torch.utils.roofline import roofline_report, step_cost

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz")
CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
DEADLINE_MS = 20.0  # the reference's control period (`nmpc_node.py:216-220`)


def env_flag(name, default):
    return os.environ.get(name, default) == "1"


def deployed_flags():
    """The deployed controller's flags, `bench.py:96-118`'s, each overridden
    by its `BENCH_*` variable."""
    whole_ipm = env_flag("BENCH_WHOLE_IPM", "1")
    packed_state = env_flag("BENCH_PACKED_STATE", "1")
    return dict(
        with_disturbance=True, qp_iters=int(os.environ.get("BENCH_QP_ITERS", "3")),
        warm_start=True, jac_bf16=env_flag("BENCH_JAC_BF16", "1"),
        lqr_start=env_flag("BENCH_LQR_START", "0" if whole_ipm else "1"),
        whole_ipm=whole_ipm, packed_state=packed_state,
        whole_step=env_flag("BENCH_WHOLE_STEP", "1") and packed_state,
    )


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


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def percentiles(samples):
    """p50 and p99 (bench.py's index rule) of samples in seconds, in ms."""
    a = sorted(samples)
    return a[len(a) // 2] * 1e3, a[int(len(a) * 0.99)] * 1e3


def row_throughput(step, state, ins, iters=30, lat_ticks=10):
    """The queued step: `iters` dependent ticks queued, then one wait (CUDA
    events around the queue on the card, and the host clock); then
    `lat_ticks` blocking ticks. Returns (row, state)."""
    x0 = ins[0]
    dev, B = x0.device, x0.shape[0]
    t0 = time.perf_counter()
    u0, state, info = step(state, *ins)
    sync(dev)
    first_s = time.perf_counter() - t0
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        u0, state, info = step(state, *ins)
    if dev.type == "cuda":
        ev[1].record()
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    device_ms = ev[0].elapsed_time(ev[1]) / iters if dev.type == "cuda" else None
    lat = []
    for _ in range(lat_ticks):
        t0 = time.perf_counter()
        u0, state, info = step(state, *ins)
        sync(dev)
        lat.append(time.perf_counter() - t0)
    lat.sort()
    step_ms = device_ms if device_ms is not None else wall_ms
    row = {
        "B": B, "device_step_ms": device_ms, "wall_step_ms": wall_ms,
        "solves_per_s": B / step_ms * 1e3, "first_tick_s": first_s,
        "blocking_p50_ms": lat[len(lat) // 2] * 1e3, "blocking_p90_ms": lat[-1] * 1e3,
        "ok": int(info.ok.sum()), "u0_finite": bool(torch.isfinite(u0).all()),
        "timed_ticks": iters, "blocking_ticks": lat_ticks,
    }
    return row, state


def row_multitick(step, state, ins, K=64, reps=4):
    """K ticks captured in one CUDA graph, replayed `reps` times. Tick k
    reads the static x0 and other horizon, drifted by +0.002 k and +0.001 k
    in z (`bench.py:216-234`). The Python launch counters count the
    capture, not the replays: the row gives K1's launches a replay from the
    capture. The replay is held against the same K ticks run eagerly from
    a copy of the state (max |diff| over the state and the last tick's u0;
    0 when bitwise equal). Returns (row, state)."""
    x0, xr, ur, other = ins
    dev, B = x0.device, x0.shape[0]
    ez_x = torch.zeros(1, 10, dtype=x0.dtype, device=dev)
    ez_x[0, 2] = 1.0
    ez_o = torch.zeros(1, 1, 10, dtype=x0.dtype, device=dev)
    ez_o[0, 0, 2] = 1.0

    def ticks(st):
        for k in range(K):
            u0, st, info = step(st, x0 + (0.002 * k) * ez_x, xr, ur, other + (0.001 * k) * ez_o)
        return u0, st, info

    # warm-up on a side stream, as graph capture asks
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            _, state, _ = step(state, *ins)
    torch.cuda.current_stream(dev).wait_stream(side)
    sync(dev)
    graph = torch.cuda.CUDAGraph()
    before = step_whole.control_step_whole.launches
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        u_g, state, info_g = ticks(state)
    sync(dev)
    capture_s = time.perf_counter() - t0
    k1_per_replay = step_whole.control_step_whole.launches - before

    copy = clone_state(state)
    graph.replay()
    u_eager, copy, _ = ticks(copy)
    sync(dev)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        (u_g, state.x_bar, state.u_bar, *(state.ipm or ())),
        (u_eager, copy.x_bar, copy.u_bar, *(copy.ipm or ()))))
    del copy

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        graph.replay()
    ev[1].record()
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * K)
    device_ms = ev[0].elapsed_time(ev[1]) / (reps * K)
    row = {
        "B": B, "K_ticks_per_replay": K, "replays": reps,
        "device_step_ms": device_ms, "wall_step_ms": wall_ms,
        "solves_per_s": B / device_ms * 1e3, "capture_s": capture_s,
        "ok_last_tick": int(info_g.ok.sum()), "k1_launches_per_replay": k1_per_replay,
        "replay_vs_eager_max_abs_diff": diff,
        "note": "the throughput row's step, K ticks in one CUDA graph: no per-tick launch cost",
    }
    del graph
    return row, state


def clone_state(st):
    return RtiState(st.x_bar.clone(), st.u_bar.clone(),
                    None if st.ipm is None else tuple(t.clone() for t in st.ipm))


def rows_interactive(tag, ctl, x0, xr, ur, f, backend, config, warm=10, ticks=200):
    """Blocking and dispatch-ahead tick rows of one controller, as the
    daemon ticks: the command comes back through the daemon's `HostLink`
    (pinned buffers, an event); blocking waits for its own tick's, the
    pipelined tick for the previous tick's. Returns {tag: row,
    tag_pipelined: row}."""
    dev = x0.device
    link = HostLink(dev, x0.dtype)
    state = ctl.reset(xr, ur)
    for _ in range(warm):
        u0, state, _ = ctl.update(state, x0, xr, ur, f)
        link.fetch("u", u0=u0).wait()
    label = {"backend": backend, "config": config, "B": x0.shape[0] if x0.dim() == 2 else 1,
             "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
             "samples": ticks, "gc_disabled": not gc.isenabled(), "deadline_ms": DEADLINE_MS}
    out = {}
    for mode in ("blocking", "pipelined"):
        prev = None
        lat = []
        for _ in range(ticks):
            t0 = time.perf_counter()
            u0, state, _ = ctl.update(state, x0, xr, ur, f)
            pending = link.fetch("u", u0=u0)
            if mode == "pipelined" and prev is not None:
                prev.wait()
            else:
                pending.wait()
            prev = pending
            lat.append(time.perf_counter() - t0)
        prev.wait()
        p50, p99 = percentiles(lat)
        row = {"p50_ms": p50, "p99_ms": p99, "meets_deadline_p99": p99 < DEADLINE_MS, **label}
        if mode == "pipelined":
            row["staleness_ticks"] = 1
        out[tag if mode == "blocking" else f"{tag}_pipelined"] = row
        print(f"interactive {tag} {mode}: tick p50={p50:.3f} ms p99={p99:.3f} ms "
              f"({DEADLINE_MS:g} ms deadline, {backend})", file=sys.stderr)
    return out


def interactive_rows(ins, Bs=(1, 64), packed=True, **kw):
    """The interactive rows on the first B of the bench's inputs, a zero
    forecast: the scan controller (at B=1 unbatched, `make_rti_controller`,
    as the daemon runs it) and, with `packed`, the deployed controller."""
    dev = ins[0].device
    rows = {}
    for Bi in Bs:
        x0, xr, ur = (t[:Bi] for t in ins[:3])
        f = torch.zeros(Bi, N + 1, 3, dtype=x0.dtype, device=dev)
        if Bi == 1:
            scan = make_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True, device=dev)
            scan_ins = (x0[0], xr[0], ur[0], f[0])
        else:
            scan = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                               backend="jax", device=dev)
            scan_ins = (x0, xr, ur, f)
        rows |= rows_interactive(f"interactive_B{Bi}", scan, *scan_ins, "torch_scan",
                                 "cold@12 scan controller (the CPU daemon's program)", **kw)
        if packed:
            flags = deployed_flags()
            ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, device=dev, **flags)
            rows |= rows_interactive(
                f"interactive_B{Bi}_packed", ctl, x0, xr, ur, f, "cuda_whole_step",
                f"the deployed kernel config (warm@{flags['qp_iters']}, "
                f"bf16={flags['jac_bf16']}, one K1 launch a tick)", **kw)
    return rows


def row_cpu_daemon(ins, warm=50, ticks=1000):
    """The scan controller at B=1 on the CPU in float64: the `serve --cpu`
    program, blocking (nothing is queued on the CPU)."""
    x0, xr, ur = (t[0].to("cpu", torch.float64) for t in ins[:3])
    ctl = make_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True, device="cpu")
    f = torch.zeros(N + 1, 3, dtype=torch.float64)
    state = ctl.reset(xr, ur)
    for _ in range(warm):
        u0, state, _ = ctl.update(state, x0, xr, ur, f)
    lat = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        u0, state, info = ctl.update(state, x0, xr, ur, f)
        u0.numpy()
        lat.append(time.perf_counter() - t0)
    p50, p99 = percentiles(lat)
    print(f"cpu daemon tick: p50={p50:.3f} ms p99={p99:.3f} ms ({DEADLINE_MS:g} ms deadline)",
          file=sys.stderr)
    return {"p50_ms": p50, "p99_ms": p99, "deadline_ms": DEADLINE_MS,
            "meets_deadline_p99": p99 < DEADLINE_MS, "samples": ticks, "device": "cpu",
            "dtype": "float64", "torch_threads": torch.get_num_threads(),
            "gc_disabled": not gc.isenabled(), "ok": bool(info.ok)}


def roofline_row(flags, solves_per_s):
    """`bench.py:304-320`'s roofline of the deployed step at `solves_per_s`."""
    cost = step_cost(N=N, qp_iters=flags["qp_iters"], jac_bf16=flags["jac_bf16"],
                     whole_kernel=flags["whole_ipm"], lqr_start=flags["lqr_start"],
                     packed_state=flags["packed_state"], whole_step=flags["whole_step"])
    roof = roofline_report(cost, solves_per_s)
    print(f"roofline: {roof['hbm_bytes_per_solve'] / 1e3:.3f} KB/solve -> "
          f"{roof['achieved_gb_s']} GB/s = {roof['h100_hbm_pct']}% of the H100's HBM peak; "
          f"~{roof['achieved_tflops_est']} TFLOP/s = {roof['h100_f32_pct_est']}% of its f32 "
          f"peak (est.)", file=sys.stderr)
    return roof


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default=os.path.join(ROOT, "build", "bench_torch_details.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: bench_torch.py measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"device: {card}, torch {torch.__version__}, cuda {torch.version.cuda}",
          file=sys.stderr)

    flags = deployed_flags()
    mlp_bf16 = env_flag("BENCH_MLP_BF16", "1")
    B = int(os.environ.get("BENCH_BATCH", "65536"))
    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, device=dev, **flags)
    mlp = load_npz(ASSET, device=dev)
    step = control_step(ctl, mlp, mlp_bf16)
    ins = inputs(B, dev, args.seed)
    state = ctl.reset(ins[1], ins[2])

    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    row, state = row_throughput(step, state, ins)
    roof = roofline_row(flags, row["solves_per_s"])
    details["throughput"] = {**row, **flags, "mlp_bf16": mlp_bf16, "roofline": roof}
    print(f"throughput: B={B} device step {row['device_step_ms']:.3f} ms (wall "
          f"{row['wall_step_ms']:.3f}) -> {row['solves_per_s']:.0f} solves/s; blocking p50 "
          f"{row['blocking_p50_ms']:.3f} ms p90 {row['blocking_p90_ms']:.3f}; ok "
          f"{row['ok']}/{B}", file=sys.stderr)
    best, source = row["solves_per_s"], "queued_ticks"

    if env_flag("BENCH_MULTITICK", "1"):
        K = int(os.environ.get("BENCH_MULTITICK_K", "64"))
        reps = int(os.environ.get("BENCH_MULTITICK_REPS", "4"))
        row, state = row_multitick(step, state, ins, K, reps)
        details["throughput_multitick"] = row
        print(f"multi-tick (K={K} a CUDA graph replay): {row['device_step_ms']:.3f} ms a tick "
              f"-> {row['solves_per_s']:.0f} solves/s (ok {row['ok_last_tick']}/{B}; replay vs "
              f"eager {row['replay_vs_eager_max_abs_diff']:.3g})", file=sys.stderr)
        if row["solves_per_s"] > best:
            best, source = row["solves_per_s"], "cuda_graph_multitick"
    del state, step, ctl

    if env_flag("BENCH_INTERACTIVE", "1"):
        gc_was_enabled = gc.isenabled()
        gc.collect()
        gc.disable()  # the daemon's real-time GC policy
        try:
            details |= interactive_rows(ins, packed=env_flag("BENCH_INTERACTIVE_PACKED", "1"))
            details["cpu_daemon_tick"] = row_cpu_daemon(ins)
        finally:
            if gc_was_enabled:
                gc.enable()

    details["headline"] = {"solves_per_s": best, "metric_source": source}
    os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
    with open(args.details, "w") as fh:
        json.dump(details, fh, indent=1)
    print(json.dumps({
        "metric": "ndp_nmpc_solves_per_s_chip", "value": round(best, 1), "unit": "solves/s",
        "vs_baseline": round(best / 50.0, 2), "roofline": roof,
    }))


if __name__ == "__main__":
    main()
