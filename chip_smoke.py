"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --small    # CPU rehearsal of the control flow

Phases, one line each; any failure exits non-zero before the last line:
1. device: the card's name and count, then the line
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives.
2. build: nvcc of every kernel source (one process each, all started
   together), with ptxas' registers, stack and spills per kernel, and for
   K1, K2 (a team of lanes a scenario, the whole horizon in shared memory),
   K8, K4, K6 (a team of lanes a scenario, one stage at a time in shared
   memory) and K3 (a thread a (stage, scenario)) their launch geometry held
   against its Python mirror
   (`_cuda.team_geometry`, `_cuda.sweep_geometry`, `_cuda.lin_geometry`).
3. kernel vs plain, B=4096, f32 and bf16 payloads, at the tolerances stated
   in `check_pair` and `ndp_nmpc_qd_tpu_torch/testing.py`:
   a. K1, the fused control step, 3 chained ticks (cold, then warm), every
      tick checked (duals and mu at their own scale);
   b. K3 (linearization), K2 (whole IPM, 3 chained solves, with and without
      the folded axpy), K4 and K5 (one glue-fused IPM iteration), each on
      the same inputs as its plain version, K4 + K5 also at B=4095, where K4
      runs its one-thread sweep (the rows are not 16-byte aligned: no tensor
      copy); and the one-kernel step against the two-kernel path (K3 + K2)
      over 3 chained ticks in f32.
   c. K6 and K7 (one Newton sweep, `riccati_sweep_sparse`) in both ways the
      IPM calls them: at the zero iterate with the clip and the hold
      rollout (the clipped-LQR start), and at a jittered iterate with
      sig/corr from `ipm_corr_terms`, no clip, no hold (the unfused glue);
      at B=4096 and at 4095, where K6 runs its one-thread sweep.
   d. K8 and K9 (the dense sweep of the legacy packed path,
      `riccati_sweep_packed`, f32) in both ways `ipm_packed` calls them:
      the clipped-LQR start (zero sig, clip) and a Newton iteration
      (nonzero sig, the defects rhat, no clip); at B=4096 (tensor copies)
      and 4095 (element copies).
   Each K4, K6 and K8 launch's route is checked against its batch.
4. main path: bf16 downwash forecast + `reset` + `update` of the deployed
   controller (warm start, 3 QP iterations, bf16 Jacobians, one K1 launch a
   tick) at B=65536: health, mean step time over 30 queued ticks (CUDA
   events), solves/s, the kernel's launch count, peak memory.
5. two-kernel path: the same drive with `whole_step=False, whole_ipm=True`
   (K3 + K2 a tick), then one tick of it and of the one-kernel step from
   the same state, held against each other.
6. per-iteration path: `whole_step=False, whole_ipm=False, lqr_start=False`
   (K3, then K4 + K5 per IPM iteration).
   b. the same from the clipped-LQR start (`lqr_start=True`: K3, K6 + K7,
      then K4 + K5 per IPM iteration).
   c. the legacy dense path (`backend="pallas_packed"`, cold, 12 QP
      iterations, f32: the dense linearizer, then K8 + K9 for the
      clipped-LQR start and once per IPM iteration, 13 of each a tick),
      then one tick of it and of the scan controller (`backend="jax"`) on
      a 256-scenario sub-batch, held at 1e-4, twice: from `reset` (the
      deltas of order one) and from the state the path left.
   d. the tensor-op linearizer (`fused_lin=False`, batch-first state) in
      place of K3: its whole-IPM path (K2 a tick, no K3); one tick of it
      and of the fused K3 + K2 from the state it left (f32 payload, u0
      atol 2e-5, x_bar atol 2e-4, `ok` equal); K3's payload against its
      (f32: each field at 5e-6 of its scale, dx0 at 1e-5; bf16: hq, a, b
      within one ulp); then its per-iteration path from the clipped-LQR
      start at B - 1 (K6's and K4's one-thread sweeps, routes checked).
7. closed loop: 150-tick hover recovery at B=65536 through an RK4 plant that
   feels the same node-0 forecast force the controller was given.
8. kernels: each kernel against its plain version once more at B=65536 on
   the state its path left (the deployed bf16 payload), K3, K4, K6 and K8
   also on its first 65535 scenarios (the swarms' batch: K4's and K6's
   one-thread sweeps, K8's element copies), timed there too; then one JSON
   line, each hand-written kernel with its launches on its path, time,
   bound, plain-version time and error against it (K1, K2, K3, K4, K6 and
   K8 also with their lanes a scenario, scenarios, threads and shared
   memory a block, and bound share; K3 with its ptxas registers and stack;
   K3, K4, K6 and K8 with their time and error at the odd batch, K4, K6 and
   K8 with the route each batch took; every kernel with its launches on
   the tensor-op linearizer's paths).
9. missions through the port's CLI (`cli.run_mission`), 200 hold ticks and
   16 s of the figure-eight (1000 ticks), recovery on:
   a. `three_qd_ndp` (3 drones: the scan controller cold@12, as the JAX
      CLI resolves a small topology, no kernel), every tick's controls held
      against the JAX mission golden (assets/mission_golden_three_qd_ndp.npz,
      the JAX scan mission) at 1e-3;
   b. `three_qd_ndp --backend pallas` on the kernels cold@12 with
      batch-first state and the clipped-LQR start (K3, K6 + K7, then
      K4 + K5 per IPM iteration), held against the same golden;
   c. `swarm --formation --drones 65536` (21845 three-drone NDP
      formations), the deployed one-kernel configuration;
   d. the same with the clipped-LQR per-iteration controller
      (`--no-whole-step --no-whole-ipm`);
   each with its launches per tick, health, RMSE and wall time per tick;
   e. `one_qd --controller thrust --track-secs 8` (the motor-thrust NMPC,
      its dense IPM cold@12, 600 ticks), every tick's rotor thrusts held
      against its JAX golden (assets/mission_golden_one_qd_thrust.npz) at
      1e-3 N; no K1-K9 launch.
10. the runtime daemons on the card (`runtime/nodes.py`), the plant and the
   controller as threads of this process over the shared-memory bus:
   a. a live mission, `tests/test_runtime.py:215-224`'s goal, the
      controller with its defaults (the deployed one-kernel step at B=1,
      pipelined): status 1, pos RMSE < 0.25 m, more than 3 feedback
      messages, the pose published, the GC restored, no recovery, and K1
      launched once a tick plus the warm-up's once;
   b. the same with `pipeline=False`;
   c. the NDP leader (`tests/test_runtime.py:152-185`): a companion's
      horizon 0.9 m above, the forecast on the card; the drone ends 0.05-1.5
      m above its 1.0 m hold;
   d. preempt, then resume (`tests/test_runtime.py:281-333`): status 2,
      then status 1 (the resumed goal starts ~0.7 m from where the drone
      held: its RMSE is printed, not bounded);
   e. K1 at the daemon's operating point: on the state the controller of
      (a) left at B=1, and on a deployed controller's at B=64, against its
      plain version at `check_pair`'s tolerances, and timed; one deployed
      `update` at B=1 and one at B=65536 under
      `torch.cuda.set_sync_debug_mode("error")` (no host sync inside it).
11. train: the downwash MLP's trainer at full width (6-128-64-128-3) from
   a seeded `init_mlp`, 200 full-batch epochs of Adam at lr 1e-4 with the
   spectral-norm projection to 4, n_train 16384 (the JAX tool's default),
   on the card and the same steps in f32 on the CPU: every epoch's loss
   and the weights within the bounds stated at `TRAIN_LOSS_RTOL`, the loss
   dropping, sigma_max <= 4 + 1e-3, epochs/s; the trained net's forecast
   into one deployed tick (one K1 launch).
12. envelope: `tools/qp_envelope_torch.py --iters 3 --whole-ipm --bf16`,
   cold and `--warm` (K3 + K2), d = 1 ... 100 m, and the same sweep on the
   deployed K1 controller: every scenario healthy; then the closed loop
   from 50 m (`tests/test_far_regime.py:74-99`: 500 ticks of the
   per-scenario scan controller at qp_iters 8, float64): the setpoint
   within 0.05 m, the command never outside the actuator box.
13. validate: `tools/validate_backends_torch.py --warm-iters 3
   --whole-step`, 300 ticks (200 tracking): the kernels cold@12 and warm@3
   from the clipped-LQR start and the deployed K1 against the scan
   controller, max control deviation below 1e-3 (`BASELINE.md`).
14. ipm_whole: `tools/bench_ipm_whole_torch.py` at B=65536, 6 iterations:
   K2 against K4 + K5 on one QP batch, element by element, both timed.
15. sharded: the parallel package (`ndp_nmpc_qd_tpu_torch/parallel/`) over
   a one-rank NCCL group (a coordinator on 127.0.0.1 at a free port), so
   that its collectives run on the card:
   a. the deployed step (forecast + K1, B=65536) through
      `make_sharded_step`, 3 chained ticks, against the unsharded step on
      the same inputs: u0, the state and `ok` bitwise equal, K1 launched
      once a tick; the blocks gathered back over the group;
   b. the sharded row (`measure_sharded_row`, 30 ticks, against the
      one-kernel path's solves/s of phase 4): n_devices 1, ok 65536;
   c. the grouped formation swarm of phase 9c (21845 three-drone NDP
      formations, 65535 drones, its deployed flags) with batch-first state
      (`solver_packed_state=False`: the two-kernel path, K3 + K2 a tick)
      as a sharded episode on a (data 1, swarm 1) mesh, 100 ticks with 50
      of hold, against the unsharded episode: metrics and the final plant
      state bitwise equal, the two-kernel path's launches a tick;
   d. the sharded swarm step (S=64 scenarios of 4 drones, f32, the MLP's
      pair forces, K3 + K2) against its unsharded replay: bitwise equal;
   then the process group is destroyed. Then, one process a card of this
   host (`parallel/launch.spawn`, NCCL; 1 on a one-card machine):
   e. `entry.dryrun_multichip` on every rank (the sharded NDP episode and
      the grouped formation on the scan controller, every drone `ok`; one
      data-parallel MLP training step, its averaged gradients, loss and
      weights held against the one-process step on the whole batch:
      bitwise at world 1, else weights atol 1e-6, gradients 1e-5 of their
      largest, loss rtol 1e-5; the weights and gradients equal on every
      rank);
   f. `bench_torch.py`'s sharded row (`deployed.sharded_row_rank`) on
      every card: n_devices the card count, ok 65536, K1 31 launches a
      rank.
16. profilers: `tools/profile_trace_torch.py`'s attribution of the
   deployed step at B=65536 by bucket (the buckets sum to the device total
   within 0.1%, the K1 bucket within 15% of K1's ms on the kernels line,
   K1 launched 6 times); `tools/profile_step_torch.py` at B=4096 (t(12) >
   t(6) > t(0) on the qp_iters sweep, the marginal, the kernels alone, the
   glue); the device-only interactive tick at B=1 and 64 of the scan
   controller and of K1 (K1 under 20 ms).
   Then the kernels line (K1 also with its B=1 and B=64 times and its
   launches a daemon tick).
Every path, mission, daemon run and tool phase sets its kernels' launch
counts to 0 just before it is driven and reads them just after. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import gc
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndp_nmpc_qd_tpu_torch import cli
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import (
    init_mlp, load_npz, make_trainer, predict_downwash,
)
from ndp_nmpc_qd_tpu_torch.models.quadrotor import (
    body_rate_dynamics, hover_input, hover_state,
)
from ndp_nmpc_qd_tpu_torch.ops.integrators import make_discrete_dynamics
from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels import (
    _build, _cuda, ipm_whole, linearize, riccati, riccati_sparse, step_whole,
)
from ndp_nmpc_qd_tpu_torch.ops.layout import pack
from ndp_nmpc_qd_tpu_torch.entry import (
    ROWS_PER_RANK, TRAIN_LR, multichip_rank, train_step_diff,
)
from ndp_nmpc_qd_tpu_torch.parallel import batch_step, distributed
from ndp_nmpc_qd_tpu_torch.parallel.launch import spawn
from ndp_nmpc_qd_tpu_torch.parallel.episode import make_sharded_episode
from ndp_nmpc_qd_tpu_torch.parallel.mesh import make_mesh, make_sharded_swarm_step, tree_map
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.runtime import bus as qb
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode
from ndp_nmpc_qd_tpu_torch.sim.swarm_scale import grid_placement
from ndp_nmpc_qd_tpu_torch.runtime.nodes import (
    ControllerDaemon, NodeTopics, PlantDaemon, send_trajectory,
)
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import (
    SparseQp, ipm_consts, lin_consts, make_linearizer, make_ocp_functions_sparse,
    sparse_consts, whole_step_consts,
)
from ndp_nmpc_qd_tpu_torch.solver.ocp_packed import make_ocp_functions_packed
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm, cold_warm, ipm_sparse
from ndp_nmpc_qd_tpu_torch.solver.rti import (
    RtiState, first_control_and_health, make_batched_rti_controller, make_rti_controller,
)
from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints
from ndp_nmpc_qd_tpu_torch.utils.roofline import F32_FLOPS_PER_S, HBM_BYTES_PER_S

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
ASSET = os.path.join(ASSETS, "downwash_analytic_sn4.npz")
GOLDEN = os.path.join(ASSETS, "mission_golden_three_qd_ndp.npz")
THRUST_GOLDEN = os.path.join(ASSETS, "mission_golden_one_qd_thrust.npz")
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
    """Counts the arithmetic the plain version does: one operation per
    element of an elementwise result, two per multiply-add of a matrix
    product (the dense plain versions contract with einsum, i.e. bmm)."""

    ARITH = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "reciprocal", "abs",
        "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    }
    MATMUL = {"bmm", "mm"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.ARITH:
            self.ops += out.numel()
        elif name in self.MATMUL:
            self.ops += 2 * out.numel() * args[0].shape[-1]
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


def ptxas_summary(log):
    """Per kernel instantiation: registers, stack frame and spills, from
    nvcc's `-Xptxas -v` output."""
    out, name, frame = [], "?", "stack frame not reported"
    for ln in log.splitlines():
        m = re.search(r"entry function '_Z(\d+)(\w+)'", ln)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            t = re.match(r"I(f|13__nv_bfloat16)(?:Lb([01])E)?", rest)
            if t:  # the jac dtype, and a bool argument (K3's multi-substep instance)
                flag = "" if t.group(2) is None else ", true" if t.group(2) == "1" else ", false"
                name += f"<{'f32' if t.group(1) == 'f' else 'bf16'}{flag}>"
        elif "bytes stack frame" in ln:
            frame = ln.strip()
        elif "ptxas info" in ln and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name} {regs.group(1) if regs else '?'} registers, {frame}")
    return " | ".join(out)


def ptxas_fields(log):
    """Per kernel instantiation of a build: {name: {registers, stack_bytes,
    spill_store_bytes}}, from nvcc's `-Xptxas -v` output."""
    out = {}
    for part in ptxas_summary(log).split(" | "):
        m = re.match(r"(.+?) (\d+|\?) registers, (?:(\d+) bytes stack frame, (\d+) bytes "
                     r"spill stores)?", part)
        if m:
            out[m.group(1)] = dict(
                registers=int(m.group(2)) if m.group(2).isdigit() else None,
                stack_bytes=int(m.group(3)) if m.group(3) else None,
                spill_store_bytes=int(m.group(4)) if m.group(4) else None)
    return out


TEAM_KERNELS = {"step_whole": step_whole, "ipm_whole": ipm_whole}  # K1, K2
SWEEP_KERNELS = {"riccati_packed": "packed", "riccati_iter": "glue",
                 "riccati_sweep": "given"}  # K8, K4, K6


def sweep_geometry(kind, B, jac_bf16):
    """A streamed sweep's launch geometry as its library computes it."""
    if kind == "packed":
        return riccati.geometry(B)
    if kind == "given":
        return riccati_sparse.sweep_geometry(B, jac_bf16)
    return riccati_sparse.geometry(B, jac_bf16)


def lin_smem():
    """K3's launch geometry at B=65536, held against its Python mirror for
    a few batch sizes."""
    for B in (1, 301, 4096, 65535, 65536):
        got, want = linearize.geometry(B, N), _cuda.lin_geometry(B, N)
        check(got == want, f"linearize geometry at B={B}: C {got}, Python {want}")
    g = linearize.geometry(65536, N)
    return (f"geometry (B=65536) a thread a (stage, scenario), {g['scenarios_per_block']} "
            f"scenarios of one stage a block, {g['blocks']} blocks, "
            f"{g['smem_bytes_per_block']} B of shared memory")


def sweep_smem(kind):
    """The dynamic shared memory of a streamed sweep (K8, K4) at B=65536,
    held against the Python mirror of its geometry for its payloads and a
    few batch sizes."""
    payloads = (False,) if kind == "packed" else (False, True)
    for B in (1, 301, 4096, 65535, 65536):
        for jac_bf16 in payloads:
            got = sweep_geometry(kind, B, jac_bf16)
            want = _cuda.sweep_geometry(kind, B, jac_bf16)
            check(got == want, f"{kind} sweep geometry at B={B}: C {got}, Python {want}")
    return "; ".join(
        f"dynamic shared memory ({tag} payload, B=65536) {g['scenarios_per_block']} scenarios, "
        f"{g['threads_per_block']} threads, {g['smem_bytes_per_block']} B a block, "
        f"{g['threads_per_scenario']} lanes a scenario"
        for tag, g in ((("f32", sweep_geometry(kind, 65536, False)),) if kind == "packed" else
                       (("bf16", sweep_geometry(kind, 65536, True)),
                        ("f32", sweep_geometry(kind, 65536, False)))))


def team_smem(mod):
    """The dynamic shared memory of a team kernel (K1, K2) at B=65536, held
    against the Python mirror of its geometry for both payloads and a few
    batch sizes."""
    for B in (1, 301, 4096, 65535, 65536):
        for jac_bf16 in (False, True):
            got = mod.geometry(B, N, jac_bf16)
            want = _cuda.team_geometry(B, N, jac_bf16)
            check(got == want, f"{mod.__name__} geometry at B={B}: C {got}, Python {want}")
    return "; ".join(
        f"dynamic shared memory ({tag} payload, B=65536) {g['scenarios_per_block']} scenarios x "
        f"{g['slot_bytes']} B = {g['smem_bytes_per_block']} B a block, "
        f"{g['threads_per_scenario']} lanes a scenario"
        for tag, g in (("bf16", mod.geometry(65536, N, True)),
                       ("f32", mod.geometry(65536, N, False))))


def phase_build():
    t0 = time.perf_counter()
    _build.build()
    wall = time.perf_counter() - t0
    for name, info in _build.build_info.items():
        smem = (f"; {team_smem(TEAM_KERNELS[name])}" if name in TEAM_KERNELS else
                f"; {sweep_smem(SWEEP_KERNELS[name])}" if name in SWEEP_KERNELS else
                f"; {lin_smem()}" if name == "linearize" else "")
        print(f"build: {name}.cu in {info['seconds']:.1f} s (wall {wall:.1f} s, "
              f"cached={info['cached']}); ptxas: {ptxas_summary(info['log'])}{smem}")


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
    tag = "bf16" if jac_bf16 else "f32"
    worst = {}
    for tick in range(ticks):
        eq_k = step_whole.control_step_whole(k[0], k[1], *ins, *k[2:], **consts)
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


def first(ts, B):
    """The first B scenarios of kernel-layout tensors (batch last), each
    contiguous; None stays None."""
    return [None if t is None else t[..., :B].contiguous() for t in ts]


# The staging route of a K4 / K6 / K8 launch at batch B: tensor copies where
# a box row is 16-byte aligned (B a multiple of 8 / 8 / 4), else K4's and
# K6's one-thread sweeps and K8's element copies.
def k4_route(B):
    return "tensor copies" if B % 8 == 0 else "one-thread sweep"


def k6_route(B):
    return "tensor copies" if B % 8 == 0 else "one-thread sweep"


def k8_route(B):
    return "tensor copies" if B % 4 == 0 else "element copies"


def check_route(name, got, want, B):
    check(got == want, f"{name} at B={B} took {got!r}, want {want!r}")


PACKED_ITERS = 12  # the packed path has no warm start: cold@12, as the JAX CLI runs cold

# Each path's kernels and launches per tick (qp_iters=3 unless given).
KERNELS = {
    "K1": step_whole.control_step_whole,
    "K3": linearize.linearize_stage_data,
    "K2": ipm_whole.riccati_ipm_whole,
    "K4": riccati_sparse.riccati_backward_glue,
    "K5": riccati_sparse.riccati_forward_glue,
    "K6": riccati_sparse.riccati_sweep_backward,
    "K7": riccati_sparse.riccati_sweep_forward,
    "K8": riccati.riccati_backward_packed,
    "K9": riccati.riccati_forward_packed,
}
PATHS = {
    "one-kernel": (dict(whole_step=True), {"K1": 1}),
    "two-kernel": (dict(whole_step=False, whole_ipm=True, lqr_start=False), {"K3": 1, "K2": 1}),
    "per-iteration": (dict(whole_step=False, whole_ipm=False, lqr_start=False),
                      {"K3": 1, "K4": 3, "K5": 3}),
    "per-iteration LQR": (dict(whole_step=False, whole_ipm=False, lqr_start=True),
                          {"K3": 1, "K6": 1, "K7": 1, "K4": 3, "K5": 3}),
    # the legacy dense path is cold and f32; it ignores the other flags
    "pallas_packed": (dict(backend="pallas_packed", packed_state=False, whole_step=False,
                           qp_iters=PACKED_ITERS), {"K8": 1 + PACKED_ITERS, "K9": 1 + PACKED_ITERS}),
    # the tensor-op linearizer in place of K3 (batch-first state)
    "tensor-lin whole IPM": (dict(fused_lin=False, packed_state=False, whole_step=False,
                                  whole_ipm=True, lqr_start=False), {"K2": 1}),
    "tensor-lin per-iteration LQR": (dict(fused_lin=False, packed_state=False, whole_step=False,
                                          whole_ipm=False, lqr_start=True),
                                     {"K6": 1, "K7": 1, "K4": 3, "K5": 3}),
}
TENSOR_LIN = ("tensor-lin whole IPM", "tensor-lin per-iteration LQR")


def controller(dev, jac_bf16=True, **flags):
    """The deployed flags (bench.py): warm start, 3 QP iterations, bf16
    Jacobians, packed state; `flags` pick the path."""
    kw = dict(with_disturbance=True, qp_iters=3, warm_start=True, jac_bf16=jac_bf16,
              whole_ipm=True, packed_state=True, whole_step=True, device=dev)
    kw.update(flags)
    return make_batched_rti_controller(CFG.ocp, CFG.vehicle, **kw)


def clone_state(st):
    return RtiState(st.x_bar.clone(), st.u_bar.clone(), tuple(t.clone() for t in st.ipm))


def check_agreement(tag, jac_bf16, k, eq_k, p, eq_p, B):
    """Two paths from the same state: with the bf16 payload at `check_pair`'s
    tolerances; in f32 at `tests/test_packed_state.py:46-78`'s: u0 atol
    1e-5, iterates atol 2e-5, duals and mu rtol 1e-4 at their own scale,
    eq_res rtol 1e-4 / atol 1e-6, `ok` identical."""
    e = pair_errors(k, eq_k, p, eq_p)
    if jac_bf16:
        check_pair(tag, True, e, B)
        return e
    eq_excess = float(((eq_k - eq_p).abs() - 1e-4 * eq_p.abs()).max())
    bad = [what for what, good in (
        ("ok flags differ", e["ok_mismatch"] == 0), ("unhealthy scenarios", e["n_ok"] == B),
        ("u0", e["u0"] <= 1e-5), ("iterates", max(e["xb"], e["ub"]) <= 2e-5),
        ("duals", e["duals_scaled"] <= 1e-4), ("eq_res", eq_excess <= 1e-6),
    ) if not good]
    check(not bad, f"{tag}: {', '.join(bad)} out of tolerance: " + describe_pair(e))
    return e


def phase_compare_two_kernel(B, dev, seed, mlp):
    """K3, K2 (3 chained solves, with and without the fold), K4 and K5
    against their plain versions on the same inputs, f32 and bf16 payloads;
    then the one-kernel step against the two-kernel path in f32."""
    ic = ipm_consts(CFG.ocp, num_iters=3)
    for jac_bf16 in (False, True):
        tag = "bf16" if jac_bf16 else "f32"
        lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
        ins = testing.kernel_inputs(B, N, dev, seed)
        errs, bad, qp = testing.check_linearize(ins, lc)
        lines = {("K3", B): (errs, bad)}
        for name, xu in (("K2, 3 chained solves", None), ("K2 with the axpy fold", ins[:2])):
            lines[name, B] = testing.check_ipm_whole(
                qp, cold_warm(N, B, torch.float32, dev), ic, xu=xu)
        for b in (B, B - 1):
            lines[f"K4 + K5, K4 by {k4_route(b)}", b] = testing.check_iter(
                testing.iter_args(first(qp, b), ic), ic)
            check_route("K4", riccati_sparse.last_route(), k4_route(b), b)
        for (name, b), (errs, bad) in lines.items():
            print(f"kernel vs plain ({name}, {tag} payload, B={b}): {testing.describe(errs)}")
            check(not bad, f"{name} vs plain ({tag} payload, B={b}): "
                  f"{', '.join(bad)} out of tolerance")

    x0, xr, ur, other = inputs(B, dev, seed)
    f = forecast(mlp, other, xr, x0, None)
    one = controller(dev, jac_bf16=False, **PATHS["one-kernel"][0])
    two = controller(dev, jac_bf16=False, **PATHS["two-kernel"][0])
    s1, s2 = one.reset(xr, ur), two.reset(xr, ur)
    worst = {}
    for tick in range(3):
        _, s1, i1 = one.update(s1, x0, xr, ur, f)
        _, s2, i2 = two.update(s2, x0, xr, ur, f)
        e = check_agreement(f"two-kernel vs one-kernel (f32, B={B}, tick {tick})", False,
                            [s2.x_bar, s2.u_bar, *s2.ipm], i2.eq_res,
                            [s1.x_bar, s1.u_bar, *s1.ipm], i1.eq_res, B)
        worst = {n: max(worst.get(n, v), v) for n, v in e.items() if isinstance(v, float)}
    print(f"two-kernel (K3 + K2) vs one-kernel (K1) path (f32, B={B}, 3 chained ticks, worst): "
          + ", ".join(f"{n} {worst[n]:.3g}" for n in ("u0", "xb", "ub", "duals_scaled", "eq")))


def phase_compare_sweep(B, dev, seed):
    """K6 and K7 against their plain versions on the same inputs, f32 and
    bf16 payloads, in both ways the IPM calls them (`testing.sweep_args`),
    at B and B - 1 (K6's one-thread sweep), each K6 launch's route
    checked."""
    ic = ipm_consts(CFG.ocp, num_iters=3)
    for jac_bf16 in (False, True):
        tag = "bf16" if jac_bf16 else "f32"
        lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
        qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, dev, seed), **lc)
        for call in ("lqr_start", "unfused_glue"):
            args, hold = testing.sweep_args(qp, ic, call)
            for b in (B, B - 1):
                errs, bad = testing.check_sweep(first(args, b), hold, ic)
                route = riccati_sparse.last_sweep_route() if dev.type == "cuda" else "plain version"
                print(f"kernel vs plain (K6 + K7, {call}, {tag} payload, B={b}, K6 by {route}): "
                      f"{testing.describe(errs)}")
                check(not bad, f"K6 + K7 vs plain ({call}, {tag} payload, B={b}): "
                      f"{', '.join(bad)} out of tolerance")
                if dev.type == "cuda":
                    check_route("K6", route, k6_route(b), b)


def phase_compare_packed(B, dev, seed):
    """K8 and K9 against their plain versions on the same inputs, f32, in
    both ways `ipm_packed` calls them (`testing.packed_args`)."""
    p, dx0 = testing.dense_payload(CFG, B, dev, seed)
    for b in (B, B - 1):
        for call in ("lqr_start", "newton"):
            errs, bad = testing.check_packed(first(testing.packed_args(p, dx0, call), b))
            route = riccati.last_route() if dev.type == "cuda" else "plain version"
            print(f"kernel vs plain (K8 + K9, {call}, f32, B={b}, K8 by {route}): "
                  f"{testing.describe(errs)}")
            check(not bad, f"K8 + K9 vs plain ({call}, B={b}): {', '.join(bad)} out of tolerance")
            if dev.type == "cuda":
                check_route("K8", route, k8_route(b), b)


def phase_path(B, dev, seed, mlp, path="one-kernel", warm_ticks=3, timed_ticks=30):
    """Drive one controller path: every kernel's count set to 0 just before,
    read just after; health, step time, launches per tick."""
    flags, per_tick = PATHS[path]
    ctl = controller(dev, **flags)
    x0, xr, ur, other = inputs(B, dev, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = ctl.reset(xr, ur)
    box = {}

    def tick():
        f = forecast(mlp, other, xr, x0, torch.bfloat16)
        box["u0"], box["state"], box["info"] = ctl.update(box.get("state", state), x0, xr, ur, f)

    for fn in KERNELS.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    ticks = warm_ticks + timed_ticks
    info, u0 = box["info"], box["u0"]
    n_ok = int(info.ok.sum())
    finite = bool(torch.isfinite(u0).all())
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    where = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    counted = ", ".join(f"{k} {launches[k]}" for k in KERNELS if launches[k] or k in per_tick)
    config = (f"qp_iters={flags['qp_iters']}, cold, f32" if "backend" in flags
              else "qp_iters=3, bf16 Jacobians, warm start")
    print(f"{path} path (B={B}, N={N}, {config}): ok {n_ok}/{B}; "
          f"step {step_ms:.3f} ms mean over {timed_ticks} queued ticks ({where}); "
          f"{B / step_ms * 1e3:.0f} solves/s; launches {counted} for {ticks} ticks; "
          f"max eq_res {float(info.eq_res.max()):.3g}; peak memory {peak:.2f} GiB")
    check(finite and u0.shape == (B, 4), f"{path}: u0 not finite or of the wrong shape")
    check(n_ok == B, f"{path} path: {B - n_ok} unhealthy scenarios")
    if dev.type == "cuda":
        want = {k: per_tick.get(k, 0) * ticks for k in KERNELS}
        check(launches == want, f"{path} path launched {launches}, want {want}")
    return dict(ctl=ctl, state=box["state"], x0=x0, xr=xr, ur=ur, other=other, path=path,
                launches=launches, ticks=ticks, step_ms=step_ms)


def phase_agree(two, dev, mlp):
    """One tick of the one-kernel step and one of the two-kernel path from
    the two-kernel path's state, on the same inputs (bf16 payload)."""
    B = two["x0"].shape[0]
    args = (two["x0"], two["xr"], two["ur"],
            forecast(mlp, two["other"], two["xr"], two["x0"], torch.bfloat16))
    _, s1, i1 = controller(dev).update(clone_state(two["state"]), *args)
    _, s2, i2 = two["ctl"].update(clone_state(two["state"]), *args)
    e = check_agreement(f"two-kernel vs one-kernel (bf16, B={B})", True,
                        [s2.x_bar, s2.u_bar, *s2.ipm], i2.eq_res,
                        [s1.x_bar, s1.u_bar, *s1.ipm], i1.eq_res, B)
    print(f"two-kernel vs one-kernel path (bf16 payload, B={B}, one tick from the two-kernel "
          f"path's state): " + describe_pair(e))


def phase_packed_agree(res, dev, mlp, sub=256):
    """One tick of the pallas_packed controller and one of the scan
    controller on a sub-batch of the path's inputs, from `reset` (where the
    Newton directions are of order one: hover offsets up to 1 m) and from
    the state the path left: they solve the same QP with the same IPM (the
    nominal regime, where the scan path's far-regime fallback is not
    taken), so the controls agree at `tests/test_pallas_riccati.py`'s 1e-4.
    |du0| = |u0 - u_bar0| says how far the tick moved the controls."""
    st = res["state"]
    x0, xr, ur = res["x0"][:sub], res["xr"][:sub], res["ur"][:sub]
    f = forecast(mlp, res["other"][:sub], xr, x0, torch.bfloat16)
    scan = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                       qp_iters=PACKED_ITERS, backend="jax", device=dev)
    starts = {"reset": res["ctl"].reset(xr, ur),
              "the path's state": RtiState(st.x_bar[:sub].clone(), st.u_bar[:sub].clone())}
    for where, state in starts.items():
        u_k, _, i_k = res["ctl"].update(state, x0, xr, ur, f)
        u_s, _, i_s = scan.update(state, x0, xr, ur, f)
        err = float((u_k - u_s).abs().max())
        du = float((u_k - state.u_bar[:, 0]).abs().max())
        ok_diff = int((i_k.ok != i_s.ok).sum())
        print(f"pallas_packed vs scan controller (B={sub}, one tick from {where}): max "
              f"|u0 - u0_scan| {err:.3g} (bound 1e-4) at max |du0| {du:.3g}; ok mismatches "
              f"{ok_diff}; ok {int(i_k.ok.sum())}/{sub}; max eq_res "
              f"{float(i_k.eq_res.max()):.3g} (scan {float(i_s.eq_res.max()):.3g})")
        check(err <= 1e-4 and ok_diff == 0, f"pallas_packed vs scan controller from {where}: "
              f"u0 {err}, {ok_diff} ok flags differ")


def phase_tensor_lin(B, dev, seed, mlp, warm_ticks=3, timed_ticks=30):
    """Phase 6d: the tensor-op linearizer (`fused_lin=False`) in place of K3.
    Drive its whole-IPM path at B (K2 a tick, no K3); then, from the state
    it left and on its inputs, one tick of the fused (K3 + K2) and one of the
    tensor-op controller with the f32 payload, held at
    `tests/test_lin_kernel.py:76-97`'s bounds (u0 atol 2e-5, x_bar atol
    2e-4, `ok` equal); K3's payload against the tensor-op linearizer's,
    field by field at `test_lin_kernel.py:55-73`'s scaled 5e-6 (f32) and
    dx0 at 1e-5, and with the bf16 payload hq, a and b within one bf16 ulp
    of max(1, max|ref|) (2^(e - 7) for that value in [2^e, 2^(e+1)): the
    f32 values before the rounding differ by ~2e-7 of their scale, so an
    entry next to a rounding boundary may round the other way, by one ulp
    of its own binade); then the per-iteration path from the clipped-LQR
    start (K6 + K7, then K4 + K5) at B - 1, each sweep's route checked.
    Returns the two paths' results."""
    res = phase_path(B, dev, seed, mlp, TENSOR_LIN[0], warm_ticks, timed_ticks)
    st, x0, xr, ur = res["state"], res["x0"], res["xr"], res["ur"]
    f = forecast(mlp, res["other"], xr, x0, torch.bfloat16)
    out = {}
    for fused in (True, False):
        ctl = controller(dev, jac_bf16=False, **dict(PATHS[TENSOR_LIN[0]][0], fused_lin=fused))
        out[fused] = ctl.update(clone_state(st), x0, xr, ur, f)
    (u_k, s_k, i_k), (u_j, s_j, i_j) = out[True], out[False]
    e_u = float((u_k - u_j).abs().max())
    e_x = float((s_k.x_bar - s_j.x_bar).abs().max())
    ok_diff = int((i_k.ok != i_j.ok).sum())
    print(f"tensor-op vs fused linearizer (K2 after each, f32 payload, B={B}, one tick from "
          f"the path's state): max |u0 diff| {e_u:.3g} (bound 2e-5), max |x_bar diff| "
          f"{e_x:.3g} (bound 2e-4), ok mismatches {ok_diff}, ok {int(i_k.ok.sum())}/{B}")
    check(e_u <= 2e-5 and e_x <= 2e-4 and ok_diff == 0,
          f"tensor-op vs fused linearizer: u0 {e_u}, x_bar {e_x}, {ok_diff} ok flags differ")
    for jac_bf16 in (False, True):
        lin_k, _ = make_linearizer(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
        lin_j, _, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
        (q_k, d_k), (q_j, d_j) = (lin(st.x_bar, st.u_bar, xr, ur, f, x0) for lin in (lin_k, lin_j))
        errs, bad = {}, []
        for name in q_j._fields:
            got, ref = getattr(q_k, name).float(), getattr(q_j, name).float()
            scale = max(1.0, float(ref.abs().max()))
            if jac_bf16 and name in ("hq", "a", "b"):  # in ulps of the scale's binade
                errs[name] = float((got - ref).abs().max()) / 2.0 ** (math.floor(
                    math.log2(scale)) - 7)
                bound = 1.0
            else:
                errs[name], bound = float((got - ref).abs().max()) / scale, 5e-6
            if not errs[name] <= bound:
                bad.append(name)
        e_d = float((d_k - d_j).abs().max())
        tag = "bf16" if jac_bf16 else "f32"
        print(f"K3 vs the tensor-op linearizer ({tag} payload, B={B}, the path's state; "
              f"{'hq, a, b in bf16 ulps, ' if jac_bf16 else ''}the rest of max(1, max|ref|)): "
              + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()) + f"; dx0 {e_d:.3g}")
        check(not bad and e_d <= 1e-5, f"K3 vs the tensor-op linearizer ({tag} payload): "
              f"{', '.join(bad) or 'dx0'} out of tolerance")
    lqr = phase_path(B - 1, dev, seed, mlp, TENSOR_LIN[1], warm_ticks, timed_ticks)
    if dev.type == "cuda":
        check_route("K4", riccati_sparse.last_route(), k4_route(B - 1), B - 1)
        check_route("K6", riccati_sparse.last_sweep_route(), k6_route(B - 1), B - 1)
        print(f"tensor-lin per-iteration LQR path (B={B - 1}): K6 by {k6_route(B - 1)}, K4 by "
              f"{k4_route(B - 1)}")
    return {TENSOR_LIN[0]: res, TENSOR_LIN[1]: lqr}


def phase_closed_loop(B, dev, seed, mlp, ticks=150):
    ctl = controller(dev)
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


def bound_of(B, ins, outs, plain, args, kwargs):
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations (the arithmetic the plain version does
    on a 64-lane slice of these inputs, scaled to B) over the f32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs) if t is not None)
    cpu = lambda t: t[..., :64].to("cpu") if isinstance(t, torch.Tensor) else t
    counter = OpCount()
    with counter, torch.no_grad():
        plain(*(cpu(t) for t in args), **kwargs)
    flops = counter.ops / 64 * B
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops)


def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound, B, **extra):
    return dict(name=name, route="cuda", source=f"ndp_nmpc_qd_tpu_torch/csrc/{source}",
                replaces=f"ndp_nmpc_qd_tpu/ops/pallas/{replaces}", launches=launches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None,
                B=B, **extra)


def team_fields(mod, B, ms, bound, g=None):
    """The kernels-line fields of a kernel with a team of lanes a scenario
    (K1, K2; K8, K4, K6 and K3 with their geometry `g`): its geometry at
    this run's B with the deployed bf16 payload and its share of its
    bound."""
    g = g or mod.geometry(B, N, True)
    return dict(threads_per_scenario=g["threads_per_scenario"],
                scenarios_per_block=g["scenarios_per_block"],
                threads_per_block=g["threads_per_block"],
                smem_bytes_per_block=g["smem_bytes_per_block"],
                bound_share=bound["bound_ms"] / ms)


def phase_kernels(main, compare, mlp):
    """Hold K1 against its plain version at the main path's size, on the
    main path's state and inputs with the deployed bf16 payload, then time
    both. Returns K1's entry of the kernels line."""
    dev = main["x0"].device
    B = main["x0"].shape[0]
    consts = whole_step_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=True, num_iters=3)
    st = main["state"]
    f = forecast(mlp, main["other"], main["xr"], main["x0"], torch.bfloat16)
    ins = (pack(main["xr"]), pack(main["ur"]), pack(f), pack(main["x0"][:, None]))
    k_state = [st.x_bar.clone(), st.u_bar.clone(), *[t.clone() for t in st.ipm]]
    p_state = [t.clone() for t in k_state]
    plain = step_whole.control_step_whole_plain
    plain_args = (*p_state[:2], *ins, *p_state[2:])

    def run_kernel():
        return step_whole.control_step_whole(k_state[0], k_state[1], *ins, *k_state[2:],
                                             **consts)

    eq_k = run_kernel()
    outs = plain(*plain_args, **consts)
    for dst, src in zip(p_state, outs[:7]):
        dst.copy_(src)
    e = pair_errors(k_state, eq_k, p_state, outs[7])
    print(f"kernel vs plain (K1, bf16 payload, B={B}, one tick from the one-kernel path's "
          f"state): " + describe_pair(e))
    check_pair(f"bf16 payload, B={B}", True, e, B)
    ms = cuda_ms(run_kernel, 10)
    plain_ms = cuda_ms(lambda: plain(*plain_args, **consts), 1)
    bound = bound_of(B, (*k_state, *ins), (*k_state, eq_k), plain, plain_args, consts)
    return entry(
        "control_step_whole", "step_whole.cu", "step_whole.py:184", main["launches"]["K1"],
        # bf16 payload at B=65536, every output; then the f32 payload at B=4096
        max(e[n] for n in STATE), ms, plain_ms, bound, B,
        launches_per_tick=main["launches"]["K1"] / main["ticks"], u0_abs_err=e["u0"],
        max_abs_err_f32_payload=max(compare["f32"][n] for n in STATE),
        **team_fields(step_whole, B, ms, bound),
    )


def phase_kernels_two_kernel(two, per, mlp):
    """K3, K2, K4 and K5 against their plain versions at B=65536 on the
    state their path left (K3 and K2: the two-kernel path's; K3, K4 and K5:
    the per-iteration path's), bf16 payload, then timed and bounded; and the
    per-iteration IPM's time beside its kernels'. Returns their entries."""
    dev = two["x0"].device
    B = two["x0"].shape[0]
    lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=True)
    ic = ipm_consts(CFG.ocp, num_iters=3)

    def checked(name, errs, bad):
        print(f"kernel vs plain ({name}, bf16 payload, B={B}): {testing.describe(errs)}")
        check(not bad, f"{name} vs plain (bf16 payload, B={B}): {', '.join(bad)} out of tolerance")
        return errs["max_abs"]

    def path_inputs(res):
        f = forecast(mlp, res["other"], res["xr"], res["x0"], torch.bfloat16)
        st = res["state"]
        return st, (st.x_bar, st.u_bar, pack(res["xr"]), pack(res["ur"]), pack(f),
                    pack(res["x0"][:, None]))

    st2, ins2 = path_inputs(two)
    errs, bad, qp2 = testing.check_linearize(ins2, lc)
    err3 = checked("K3, the two-kernel path's state", errs, bad)
    st3, ins3 = path_inputs(per)
    errs, bad, qp3 = testing.check_linearize(ins3, lc)
    err3 = max(err3, checked("K3, the per-iteration path's state", errs, bad))
    # the swarms' odd batch on the first B - 1 scenarios
    odd = B - 1
    ins3o = first(ins2, odd)
    errs, bad, _ = testing.check_linearize(ins3o, lc)
    print(f"kernel vs plain (K3, the two-kernel path's state, bf16 payload, B={odd}): "
          f"{testing.describe(errs)}")
    check(not bad, f"K3 vs plain (bf16 payload, B={odd}): {', '.join(bad)} out of tolerance")
    err3o = errs["max_abs"]
    plain3 = linearize.linearize_stage_data_plain
    ms3 = cuda_ms(lambda: KERNELS["K3"](*ins2, **lc), 10)
    bound3 = bound_of(B, ins2, qp2, plain3, ins2, lc)
    g3 = linearize.geometry(B, N)
    k3 = entry(
        "linearize_stage_data", "linearize.cu", "linearize.py:297", two["launches"]["K3"],
        err3, ms3, cuda_ms(lambda: plain3(*ins2, **lc), 1), bound3, B,
        launches_per_path={p: r["launches"]["K3"] for p, r in (("two-kernel", two),
                                                              ("per-iteration", per))},
        **team_fields(None, B, ms3, bound3, g3),
        ptxas=ptxas_fields(_build.build_info["linearize"]["log"]),
        odd_B=odd, odd_B_ms=cuda_ms(lambda: KERNELS["K3"](*ins3o, **lc), 10),
        odd_B_max_abs_err=err3o,
    )

    # K2 with the axpy folded, as the two-kernel path runs it
    xu = (st2.x_bar, st2.u_bar)
    errs, bad = testing.check_ipm_whole(qp2, st2.ipm, ic, xu=xu, calls=1)
    err2 = checked("K2 with the axpy fold, one solve from the two-kernel path's state", errs, bad)
    kd = [t.clone() for t in st2.ipm]
    kx = [t.clone() for t in xu]
    plain2 = ipm_whole.riccati_ipm_whole_plain
    args2 = (*qp2[:11], *st2.ipm, qp2[11], *xu)
    eq = torch.empty(B, device=dev)
    ms2 = cuda_ms(lambda: KERNELS["K2"](*qp2[:11], *kd, qp2[11], *kx, **ic), 10)
    bound2 = bound_of(B, args2, (*xu, *st2.ipm, eq), plain2, args2, ic)
    k2 = entry(
        "riccati_ipm_whole", "ipm_whole.cu", "ipm_whole.py:459", two["launches"]["K2"], err2,
        ms2, cuda_ms(lambda: plain2(*args2, **ic), 1), bound2, B,
        **team_fields(ipm_whole, B, ms2, bound2),
    )

    # K4 and K5 at the per-iteration path's start, its carried duals mixed in
    warm = IpmWarm(*st3.ipm)
    args = testing.iter_args(qp3, ic, warm=warm)
    errs, bad = testing.check_iter(args, ic)
    checked("K4 + K5, the per-iteration path's state", errs, bad)
    kw4 = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    kw5 = dict(h=ic["h"], tau=ic["tau"])
    bwd = args[:22]
    plain4 = riccati_sparse.riccati_backward_glue_plain
    plain5 = riccati_sparse.riccati_forward_glue_plain
    K, kf, rh, res2 = plain4(*bwd, **kw4)
    fwd = (args[3], args[4], args[5], rh, K, kf, *args[7:22], args[22])
    ms4 = cuda_ms(lambda: KERNELS["K4"](*bwd, **kw4), 10)
    check_route("K4", riccati_sparse.last_route(), k4_route(B), B)
    ms5 = cuda_ms(lambda: KERNELS["K5"](*fwd, **kw5), 10)
    bound4 = bound_of(B, bwd, (K, kf, rh, res2), plain4, bwd, kw4)
    # the swarms' odd batch on the first B - 1 scenarios: the one-thread sweep
    odd = B - 1
    oargs = first(args, odd)
    errs_o, bad = testing.check_iter(oargs, ic)
    check_route("K4", riccati_sparse.last_route(), k4_route(odd), odd)
    print(f"kernel vs plain (K4 + K5, the per-iteration path's state, bf16 payload, B={odd}, "
          f"K4 by {k4_route(odd)}): {testing.describe(errs_o)}")
    check(not bad, f"K4 + K5 vs plain (bf16 payload, B={odd}): {', '.join(bad)} out of tolerance")
    ms4o = cuda_ms(lambda: KERNELS["K4"](*oargs[:22], **kw4), 10)
    k4 = entry(
        "riccati_backward_glue", "riccati_iter.cu", "riccati_sparse.py:728",
        per["launches"]["K4"], errs["max_abs_K4"], ms4, cuda_ms(lambda: plain4(*bwd, **kw4), 1),
        bound4, B, route_taken=k4_route(B),
        **team_fields(None, B, ms4, bound4, sweep_geometry("glue", B, True)),
        odd_B=odd, odd_B_route=k4_route(odd), odd_B_ms=ms4o,
        odd_B_max_abs_err=errs_o["max_abs_K4"],
    )
    k5 = entry(
        "riccati_forward_glue", "riccati_iter.cu", "riccati_sparse.py:787",
        per["launches"]["K5"], errs["max_abs_K5"], ms5, cuda_ms(lambda: plain5(*fwd, **kw5), 1),
        bound_of(B, fwd, plain5(*fwd, **kw5), plain5, fwd, kw5), B,
    )

    # the per-iteration IPM: its kernels and the torch work around them
    p3 = SparseQp(*qp3[:11])
    ipm_ms = cuda_ms(lambda: ipm_sparse(p3, sparse_consts(CFG.ocp), qp3[11], num_iters=3,
                                        warm=warm, lqr_start=False), 10)
    print(f"per-iteration IPM (3 iterations, B={B}): {ipm_ms:.3f} ms a solve (CUDA events, "
          f"10 queued); K4 + K5 3 x ({ms4:.3f} + {ms5:.3f}) = {3 * (ms4 + ms5):.3f} ms; the "
          f"start and the torch work between the launches {ipm_ms - 3 * (ms4 + ms5):.3f} ms")
    return [k3, k2, k4, k5]


def phase_kernels_sweep(lqr, mlp):
    """K6 and K7 against their plain versions at B=65536 on the state the
    clipped-LQR path left (bf16 payload), as its start calls them (zero
    iterate, clip, hold rollout), then timed and bounded. Returns their
    entries of the kernels line."""
    dev = lqr["x0"].device
    B = lqr["x0"].shape[0]
    lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=True)
    ic = ipm_consts(CFG.ocp, num_iters=3)
    st = lqr["state"]
    f = forecast(mlp, lqr["other"], lqr["xr"], lqr["x0"], torch.bfloat16)
    qp = linearize.linearize_stage_data_plain(
        st.x_bar, st.u_bar, pack(lqr["xr"]), pack(lqr["ur"]), pack(f), pack(lqr["x0"][:, None]),
        **lc)
    args, hold = testing.sweep_args(qp, ic, "lqr_start")
    errs, bad = testing.check_sweep(args, hold, ic)
    check_route("K6", riccati_sparse.last_sweep_route(), k6_route(B), B)
    print(f"kernel vs plain (K6 + K7, the clipped-LQR start, bf16 payload, B={B}, the LQR "
          f"path's state, K6 by {k6_route(B)}): {testing.describe(errs)}")
    check(not bad, f"K6 + K7 vs plain (B={B}): {', '.join(bad)} out of tolerance")
    kw6 = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    kw7 = dict(h=ic["h"], with_hold=True)
    bwd = args[:13]
    plain6 = riccati_sparse.riccati_sweep_backward_plain
    plain7 = riccati_sparse.riccati_sweep_forward_plain
    K, kf, rh = plain6(*bwd, **kw6)
    fwd = (args[3], args[4], args[5], rh, K, kf, args[13], args[14], args[15])
    ms6 = cuda_ms(lambda: KERNELS["K6"](*bwd, **kw6), 10)
    check_route("K6", riccati_sparse.last_sweep_route(), k6_route(B), B)
    bound6 = bound_of(B, bwd, (K, kf, rh), plain6, bwd, kw6)
    # the swarms' odd batch on the first B - 1 scenarios: the one-thread sweep
    odd = B - 1
    oargs = first(args, odd)
    errs_o, bad = testing.check_sweep(oargs, hold, ic)
    check_route("K6", riccati_sparse.last_sweep_route(), k6_route(odd), odd)
    print(f"kernel vs plain (K6 + K7, the clipped-LQR start, bf16 payload, B={odd}, K6 by "
          f"{k6_route(odd)}): {testing.describe(errs_o)}")
    check(not bad, f"K6 + K7 vs plain (B={odd}): {', '.join(bad)} out of tolerance")
    ms6o = cuda_ms(lambda: KERNELS["K6"](*oargs[:13], **kw6), 10)
    k6 = entry(
        "riccati_sweep_backward", "riccati_sweep.cu", "riccati_sparse.py:926",
        lqr["launches"]["K6"], errs["max_abs_K6"], ms6, cuda_ms(lambda: plain6(*bwd, **kw6), 1),
        bound6, B, route_taken=k6_route(B),
        **team_fields(None, B, ms6, bound6, sweep_geometry("given", B, True)),
        odd_B=odd, odd_B_route=k6_route(odd), odd_B_ms=ms6o,
        odd_B_max_abs_err=errs_o["max_abs_K6"],
    )
    k7 = entry(
        "riccati_sweep_forward", "riccati_sweep.cu", "riccati_sparse.py:994",
        lqr["launches"]["K7"], errs["max_abs_K7"], cuda_ms(lambda: KERNELS["K7"](*fwd, **kw7), 10),
        cuda_ms(lambda: plain7(*fwd, **kw7), 1),
        bound_of(B, fwd, plain7(*fwd, **kw7), plain7, fwd, kw7), B,
    )
    return [k6, k7]


def phase_kernels_packed(res, mlp):
    """K8 and K9 against their plain versions at B=65536 on the dense QP
    of the pallas_packed path's state, as its start calls them (zero sig,
    clip), then timed and bounded. Returns their entries of the kernels
    line."""
    dev = res["x0"].device
    B = res["x0"].shape[0]
    lin, _ = make_ocp_functions_packed(CFG.ocp, CFG.vehicle, True)
    st = res["state"]
    f = forecast(mlp, res["other"], res["xr"], res["x0"], torch.bfloat16)
    p, dx0 = lin(st.x_bar, st.u_bar, res["xr"], res["ur"], f, res["x0"])
    args = testing.packed_args(p, dx0, "lqr_start")
    errs, bad = testing.check_packed(args)
    print(f"kernel vs plain (K8 + K9, the clipped-LQR start, f32, B={B}, the pallas_packed "
          f"path's state): {testing.describe(errs)}")
    check(not bad, f"K8 + K9 vs plain (B={B}): {', '.join(bad)} out of tolerance")
    bwd, fwd_tail = args[:9], args[9:]
    plain8 = riccati.riccati_backward_packed_plain
    plain9 = riccati.riccati_forward_packed_plain
    K, kf = plain8(*bwd)
    fwd = (args[6], args[7], args[8], K, kf, *fwd_tail)
    ms8 = cuda_ms(lambda: KERNELS["K8"](*bwd), 10)
    check_route("K8", riccati.last_route(), k8_route(B), B)
    bound8 = bound_of(B, bwd, (K, kf), plain8, bwd, {})
    # an odd batch on the first B - 1 scenarios: element copies
    odd = B - 1
    oargs = first(args, odd)
    errs_o, bad = testing.check_packed(oargs)
    check_route("K8", riccati.last_route(), k8_route(odd), odd)
    print(f"kernel vs plain (K8 + K9, the clipped-LQR start, f32, B={odd}, K8 by "
          f"{k8_route(odd)}): {testing.describe(errs_o)}")
    check(not bad, f"K8 + K9 vs plain (B={odd}): {', '.join(bad)} out of tolerance")
    ms8o = cuda_ms(lambda: KERNELS["K8"](*oargs[:9]), 10)
    k8 = entry(
        "riccati_backward_packed", "riccati_packed.cu", "riccati.py:318",
        res["launches"]["K8"], errs["max_abs_K8"], ms8, cuda_ms(lambda: plain8(*bwd), 1),
        bound8, B, route_taken=k8_route(B),
        **team_fields(None, B, ms8, bound8, sweep_geometry("packed", B, False)),
        odd_B=odd, odd_B_route=k8_route(odd), odd_B_ms=ms8o,
        odd_B_max_abs_err=errs_o["max_abs_K8"],
    )
    k9 = entry(
        "riccati_forward_packed", "riccati_packed.cu", "riccati.py:359",
        res["launches"]["K9"], errs["max_abs_K9"], cuda_ms(lambda: KERNELS["K9"](*fwd), 10),
        cuda_ms(lambda: plain9(*fwd), 1), bound_of(B, fwd, plain9(*fwd), plain9, fwd, {}), B,
    )
    return [k8, k9]


# The missions of phase 9: CLI arguments, the backend they resolve to and
# the kernel launches per tick. three_qd_ndp flies twice, on the scan
# controller its "auto" rule picks (no kernel) and on the kernels cold at
# 12 QP iterations; the one JAX golden holds both.
MISSIONS = {
    "three_qd_ndp": (["three_qd_ndp"], "jax", {}),
    "three_qd_ndp, kernels": (
        ["three_qd_ndp", "--backend", "pallas", "--qp-iters", "12", "--no-warm",
         "--no-whole-ipm", "--no-bf16", "--no-whole-step"],
        "pallas", {"K3": 1, "K6": 1, "K7": 1, "K4": 12, "K5": 12}),
    "swarm, deployed": (["swarm", "--formation", "--drones", "65536"], "pallas", {"K1": 1}),
    "swarm, LQR start": (["swarm", "--formation", "--drones", "65536", "--no-whole-step",
                          "--no-whole-ipm"], "pallas",
                         {"K3": 1, "K6": 1, "K7": 1, "K4": 3, "K5": 3}),
}


def phase_mission(name, extra=(), n_ticks=None):
    """Fly one mission through `cli.run_mission`, every kernel's count set
    to 0 just before and read just after; check health, the launches per
    tick and, for three_qd_ndp, every tick's controls against the JAX
    golden (the scan mission, which JAX's kernel controller meets to
    2.9e-6); for the swarms the spread of the leaders' RMSE across groups
    (they fly the same mission at different anchors)."""
    argv, want_backend, per_tick = MISSIONS[name]
    args = cli.make_parser().parse_args(["mission", *argv, *extra])
    golden = argv[0] == "three_qd_ndp"
    for fn in KERNELS.values():
        fn.launches = 0
    result, run = cli.run_mission(args, record_traces=golden, n_ticks=n_ticks)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    T = result["ticks"]
    m = run["metrics"]
    print(f"mission {name}: {json.dumps(result)}")
    line = (f"mission {name} ({result['n_drones']} drones, {T} ticks): "
            f"{result['ms_per_tick']:.3f} ms a tick (wall, synchronised); ok "
            f"{int(m.ok.sum())}/{m.ok.numel()}; recovered {result['recovered']}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v or k in per_tick))
    check(bool(m.ok.all()), f"mission {name}: {int((~m.ok).sum())} drones not ok at the end")
    check(result["solver"]["backend"] == want_backend,
          f"mission {name} ran backend {result['solver']['backend']!r}, want {want_backend!r}")
    if golden:
        with np.load(GOLDEN) as g:
            u0_g, pos_g, form_g = g["u0"][:T], g["pos_rmse"], g["form_rmse"]
        u0 = run["traces"][1].double().cpu().numpy()
        dev_u0 = float(np.abs(u0 - u0_g).max())
        line += (f"; max |u0 - u0_jax| {dev_u0:.3g} over {T} ticks and 3 drones (bound 1e-3); "
                 f"pos RMSE {result['pos_rmse']} (JAX {[round(float(v), 5) for v in pos_g]}), form "
                 f"RMSE {result['form_rmse']} (JAX {[round(float(v), 5) for v in form_g]})")
        check(dev_u0 < 1e-3, f"mission {name}: control deviation {dev_u0} from the JAX golden")
    else:
        lead = m.pos_rmse.reshape(-1, 3)[:, 0]
        spread = float(lead.max() - lead.min())
        line += (f"; pos RMSE leaders {result['pos_rmse_leaders']}, followers "
                 f"{result['pos_rmse_followers']}; leader RMSE spread across "
                 f"{lead.numel()} groups {spread:.3g} m")
        check(spread < 1e-3, f"mission {name}: leader RMSE spread {spread} m across groups")
    if not args.cpu and launches["K4"]:
        line += f"; K4 by {riccati_sparse.last_route()}"
    if not args.cpu and launches["K6"]:
        line += f"; K6 by {riccati_sparse.last_sweep_route()}"
    print(line)
    if args.cpu:
        return result
    want = {k: per_tick.get(k, 0) * T for k in KERNELS}
    check(launches == want, f"mission {name} launched {launches}, want {want}")
    return result


def phase_thrust_mission(cpu=False, n_ticks=None):
    """Phase 9e: `mission one_qd --controller thrust` through
    `cli.run_mission` with the argv its JAX golden was recorded with
    (assets/mission_golden_one_qd_thrust.npz, written by
    `tools/validate_port_mission.py --mission thrust --golden`), every
    kernel's count set to 0 just before and read just after: `ok`, every
    tick's rotor thrusts within 1e-3 N of the golden's (BASELINE.md's
    control bound, in the thrusts' unit; hover is m g / 4 ~ 3.64 N), and no
    K1-K9 launch (the controller is the dense IPM, plain tensor code)."""
    with np.load(THRUST_GOLDEN) as g:
        argv = json.loads(str(g["argv"]))
        u0_g, x_g, pos_g = g["u0"], g["x"], g["pos_rmse"]
    args = cli.make_parser().parse_args(argv + (["--cpu"] if cpu else []))
    for fn in KERNELS.values():
        fn.launches = 0
    result, run = cli.run_mission(args, record_traces=True, n_ticks=n_ticks)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    T = result["ticks"]
    x, u0 = (t.double().cpu().numpy() for t in run["traces"])
    dev_u0 = float(np.abs(u0 - u0_g[:T]).max())
    dev_x = float(np.abs(x - x_g[:T]).max())
    print(f"mission one_qd, thrust controller: {json.dumps(result)}")
    print(f"mission one_qd, thrust controller ({' '.join(argv[1:])}, {T} ticks): "
          f"{result['ms_per_tick']:.3f} ms a tick (wall, synchronised); ok {result['ok']}; pos "
          f"RMSE {result['pos_rmse']} (JAX {[round(float(v), 5) for v in pos_g]}); max |u0 - "
          f"u0_jax| {dev_u0:.3g} N over {T} ticks (bound 1e-3 N), max |x - x_jax| {dev_x:.3g}; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(result["ok"] == [True], "thrust mission: not ok")
    check(u0.shape == (T, 1, 4) and dev_u0 < 1e-3,
          f"thrust mission: control deviation {dev_u0} N from the JAX golden")
    check(not any(launches.values()), f"thrust mission launched {launches}")
    return result


# the JAX live tests' goal (`tests/test_runtime.py:215-218`): 4 segments of 2 s
DAEMON_WPTS = np.stack([[0, 0.5, 1.0, 0.5, 0.0], [0, 0.5, 0, -0.5, 0], np.ones(5)], axis=-1)


class Live:
    """A plant and a controller daemon as threads on a fresh namespace, on
    `dev`; every kernel's launch count set to 0 before the controller is
    built (its warm-up launches count). On exit: both stopped and joined,
    the namespace unlinked, an exception of either thread raised here."""

    def __init__(self, dev, ctl_ticks=0, **ctl_kw):
        self.ns = f"smoke_{uuid.uuid4().hex[:8]}"
        self.dev, self.ctl_ticks, self.ctl_kw = dev, ctl_ticks, ctl_kw
        self.out, self.stop = {}, threading.Event()

    def _run(self, name, fn, **kw):
        try:
            self.out[name] = fn(stop_event=self.stop, **kw)
        except BaseException as e:  # handed to the main thread in __exit__
            self.out[name] = e

    def __enter__(self):
        self.plant = PlantDaemon(self.ns, device=self.dev)
        for fn in KERNELS.values():
            fn.launches = 0
        self.ctl = ControllerDaemon(self.ns, device=self.dev, **self.ctl_kw)
        pr, cr = threading.Event(), threading.Event()
        self.threads = [
            threading.Thread(target=self._run, args=("plant", self.plant.run),
                             kwargs=dict(ready_event=pr)),
            threading.Thread(target=self._run, args=("ctl", self.ctl.run),
                             kwargs=dict(ready_event=cr, max_ticks=self.ctl_ticks)),
        ]
        self.threads[0].start()
        check(pr.wait(60), "the plant daemon did not start")
        self.threads[1].start()
        while not cr.wait(1.0):
            check(self.threads[1].is_alive(), f"the controller daemon ended: {self.out.get('ctl')}")
        return self

    def join_controller(self, timeout):
        self.threads[1].join(timeout)
        check(not self.threads[1].is_alive(), "the controller daemon did not end")

    def __exit__(self, *exc):
        self.stop.set()
        for th in self.threads:
            th.join(60)
        NodeTopics.unlink(self.ns)
        self.launches = {k: fn.launches for k, fn in KERNELS.items()}
        for name, res in self.out.items():
            if isinstance(res, BaseException):
                raise res
        check(not any(th.is_alive() for th in self.threads), "a daemon did not stop")
        return False


def check_daemon(tag, live, dev, res=None, feedback=None, rmse_bound=None):
    """The daemon's run: the GC restored, the pose published; on the card no
    recovery and K1 launched once a tick plus the warm-up's once and nothing
    else (the CPU rehearsal's loop runs late, and may recover); the goal's
    result where given. Returns the controller's result."""
    c = live.out["ctl"]
    lat = c["tick_latency"]
    line = (f"daemon {tag} ({live.ctl.solver}, pipeline={live.ctl.pipeline}, {dev.type}): "
            f"{c['ticks']} ticks, {c['overruns']} overruns, {c['recoveries']} recoveries, "
            f"tick p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} max {lat['max_ms']:.3f}, "
            f"goal_to_first_cmd_s {c['goal_to_first_cmd_s']}, K1 launches {live.launches['K1']}; "
            f"plant {live.out['plant']}")
    if res is not None:
        line += (f"; result status {int(res['status'])}, pos RMSE {float(res['pos_rmse']):.4f} m, "
                 f"{len(feedback)} feedback messages")
    print(line)
    pseq, pose = live.ctl.t.pose.read_latest()
    check(gc.isenabled(), f"daemon {tag}: the GC was left disabled")
    check(pseq > 0 and np.isfinite(pose["pos"]).all(), f"daemon {tag}: no pose published")
    if dev.type == "cuda":
        check(c["recoveries"] == 0, f"daemon {tag}: {c['recoveries']} recoveries")
        want = {k: (c["ticks"] + 1 if k == "K1" else 0) for k in KERNELS}
        check(live.launches == want, f"daemon {tag} launched {live.launches}, want {want}")
    if res is not None:
        check(int(res["status"]) == 1 and len(feedback) > 3,
              f"daemon {tag}: status {int(res['status'])}, {len(feedback)} feedback messages")
        if rmse_bound is not None:
            check(float(res["pos_rmse"]) < rmse_bound,
                  f"daemon {tag}: pos RMSE {float(res['pos_rmse'])} >= {rmse_bound}")
    return c


def phase_daemons(dev, small=False):
    """Phase 10 a-d. On the card the RMSE bound of the JAX live test holds;
    the CPU rehearsal (the scan controller, whose tick overruns the 20 ms
    period there) holds the protocol. Returns the pipelined live mission's
    controller, its result and its K1 launches."""
    traj = fit_waypoints(DAEMON_WPTS, np.full(4, 2.0))
    bound = None if small else 0.25
    runs = [("a, live mission", {})] + ([] if small else [("b, blocking", dict(pipeline=False))])
    first = None
    for tag, kw in runs:
        with Live(dev, **kw) as live:
            res, fb = send_trajectory(live.ns, traj, goal_id=3, timeout_s=30)
        c = check_daemon(tag, live, dev, res, fb, bound)
        first = first or (live.ctl, c, live.launches["K1"])
    if small:
        return first

    comp = f"smoke_comp_{uuid.uuid4().hex[:8]}"
    m = np.zeros((), qb.PRED_XU)
    m["x"][:, 2] = 1.9  # hovering 0.9 m above the plant's start (z = 1)
    m["x"][:, 6] = 1.0
    qb.Topic(f"{comp}/ref_x_u", qb.PRED_XU).publish(m)
    try:
        with Live(dev, ctl_ticks=250, use_ndp=True, companion_ns=comp) as live:
            live.join_controller(120)
            _, odom = live.plant.t.odom.read_latest()
    finally:
        qb.Topic.unlink(f"{comp}/ref_x_u")
    check_daemon("c, NDP leader", live, dev)
    rise = float(odom["pos"][2]) - 1.0
    print(f"daemon c, NDP leader: the drone ends {rise:.4f} m above its 1.0 m hold "
          f"(band 0.05-1.5: the forecast's phantom downwash compensated)")
    check(0.05 < rise < 1.5, f"NDP leader: {rise} m above the hold, want 0.05-1.5")

    with Live(dev) as live:
        res, fb = send_trajectory(live.ns, traj, goal_id=11, timeout_s=30, cancel_after_s=2.0)
        res2, fb2 = send_trajectory(live.ns, fit_waypoints(DAEMON_WPTS[:3], np.full(2, 2.0)),
                                    goal_id=12, timeout_s=30)
    check_daemon("d, preempt then resume", live, dev, res2, fb2)
    lat = live.ctl.goal_to_first_cmd_s
    print(f"daemon d: goal 11 status {int(res['status'])} (partial pos RMSE "
          f"{float(res['pos_rmse']):.4f} m, {len(fb)} feedback messages), goal 12 status "
          f"{int(res2['status'])}; goal-to-first-command {lat:.4f} s")
    check(int(res["status"]) == 2 and np.isfinite(res["pos_rmse"]),
          f"preempt: status {int(res['status'])}")
    check(lat is not None and lat < 2.0, f"goal-to-first-command {lat} s")
    return first


def k1_pair(st, x0, xr, ur, f, tag):
    """K1 against its plain version from a batch-first operating point and
    a kernel-layout state (bf16 payload, `check_pair`'s tolerances).
    Returns (errors, the kernel call on clones of the state, for timing)."""
    B = x0.shape[0]
    consts = whole_step_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=True, num_iters=3)
    ins = (pack(xr), pack(ur), pack(f), pack(x0[:, None]))
    k = [st.x_bar.clone(), st.u_bar.clone(), *[t.clone() for t in st.ipm]]
    p = [t.clone() for t in k]

    def run_kernel():
        return step_whole.control_step_whole(k[0], k[1], *ins, *k[2:], **consts)

    eq_k = run_kernel()
    outs = step_whole.control_step_whole_plain(p[0], p[1], *ins, *p[2:], **consts)
    e = pair_errors(k, eq_k, list(outs[:7]), outs[7])
    print(f"kernel vs plain (K1, bf16 payload, B={B}, {tag}): " + describe_pair(e))
    check_pair(f"bf16 payload, B={B}, {tag}", True, e, B)
    return e, run_kernel


def no_sync_update(ctl, st, args, tag):
    """One `update` under `set_sync_debug_mode("error")`: a host sync inside
    it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u0, _, info = ctl.update(st, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(info.ok.all()) and bool(torch.isfinite(u0).all()), f"{tag}: unhealthy update")
    print(f"no host sync inside the deployed update ({tag}): set_sync_debug_mode('error') "
          f"passed")


def phase_daemon_kernel(daemon, dev, mlp, seed, B_batch=64):
    """Phase 10 e: K1 on the state the daemon's controller left (B=1) and
    on a deployed controller's after 10 ticks at B_batch, against its plain
    version, timed on the card; the no-sync updates. Returns the fields
    K1's kernels-line entry gains."""
    last = daemon.last
    st1 = last["state"]
    one = [t[None] for t in (last["x0"], last["xr"], last["ur"], last["f"])]
    e1, run1 = k1_pair(st1, *one, "the live daemon's state")
    ctl = controller(dev)
    x0, xr, ur, other = inputs(B_batch, dev, seed + 2)
    st = ctl.reset(xr, ur)
    f = forecast(mlp, other, xr, x0, torch.bfloat16)
    for _ in range(10):
        _, st, _ = ctl.update(st, x0, xr, ur, f)
    eb, runb = k1_pair(st, x0, xr, ur, f, "a deployed controller's state after 10 ticks")
    out = dict(max_abs_err_B1=max(e1[n] for n in STATE),
               max_abs_err_B64=max(eb[n] for n in STATE))
    if dev.type != "cuda":
        return out
    out |= dict(ms_B1=cuda_ms(run1, 200), ms_B64=cuda_ms(runb, 200))
    print(f"K1 at the daemon's operating point: {out['ms_B1']:.4f} ms at B=1, "
          f"{out['ms_B64']:.4f} ms at B={B_batch} (CUDA events, 200 queued launches)")
    no_sync_update(daemon.ctl, clone_state(st1),
                   (last["x0"], last["xr"], last["ur"], last["f"]), "B=1, the daemon's")
    big = controller(dev)
    x0, xr, ur, other = inputs(65536, dev, seed + 3)
    f = forecast(mlp, other, xr, x0, torch.bfloat16)
    st = big.reset(xr, ur)
    _, st, _ = big.update(st, x0, xr, ur, f)
    no_sync_update(big, st, (x0, xr, ur, f), "B=65536")
    return out


def tool(name):
    """A port tool, `tools/<name>.py`, as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count_launches(fn, *args, **kwargs):
    """Run fn with every kernel's count set to 0 just before; returns
    (fn's result, {kernel: launches} read just after)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn(*args, **kwargs)
    return out, {name: k.launches for name, k in KERNELS.items()}


def launched(launches):
    return ", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none"


def check_launches(tag, got, want, dev):
    """On the card, the launches a phase made are exactly `want` (kernel ->
    count; the others 0); on the CPU none."""
    want = {k: want.get(k, 0) if dev.type == "cuda" else 0 for k in KERNELS}
    check(got == want, f"{tag} launched {got}, want {want}")


# Phase 11's bounds: the trainer on the card against the same steps on the
# CPU in f32 (TF32 off), 200 epochs at lr 1e-4. The two differ by the
# summation order of the products, the reductions and the SVD, and Adam
# moves every component by about lr a step whatever its gradient's size, so
# a component whose gradient is near zero can take another sign on the two
# and the weights part by a few lr over the epochs while the losses agree.
# Measured on an H100 (700 W): losses 2.72e-6 relative, weights 1.18e-4.
TRAIN_LOSS_RTOL = 2e-5
TRAIN_W_ATOL = 5e-4


def phase_train(dev, seed, epochs=200, n_train=16384, B=65536):
    """Phase 11: the downwash MLP's trainer (`make_trainer`: full-batch
    Adam, MSE, the spectral-norm projection to 4 after every step) at full
    width (6-128-64-128-3) from `init_mlp`'s seeded init, `epochs` epochs
    on `n_train` samples of `tools/train_downwash_torch.sample_dataset` (the
    JAX tool's default size) at lr 1e-4 (the reference's rate), on the card
    and in f32 on the CPU from the same init: every epoch's loss within
    TRAIN_LOSS_RTOL of the CPU's, the largest weight difference within
    TRAIN_W_ATOL, the loss dropping, every weight's sigma_max <= 4 + 1e-3;
    epochs/s on the card. Then the trained net's bf16 forecast feeds one
    tick of the deployed step (K1) at B: healthy, one K1 launch."""
    x, y = tool("train_downwash_torch").sample_dataset(n_train, seed=0)
    runs = {}
    for where in (torch.device("cpu"), dev):
        mlp = init_mlp(torch.Generator().manual_seed(seed), device=where)
        init_opt, train_step, _ = make_trainer(sn=4.0, lr=1e-4)
        opt = init_opt(mlp)
        xt, yt = torch.as_tensor(x, device=where), torch.as_tensor(y, device=where)
        losses = [train_step(mlp, opt, xt, yt)[2]]
        sync = torch.cuda.synchronize if where.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        for _ in range(epochs - 1):
            losses.append(train_step(mlp, opt, xt, yt)[2])
        sync()
        rate = (epochs - 1) / (time.perf_counter() - t0)
        runs[where.type] = (mlp, torch.stack(losses).double().cpu(), rate)
    (cpu_net, cpu_loss, cpu_rate), (net, loss, rate) = runs["cpu"], runs[dev.type]
    loss_rel = float(((loss - cpu_loss).abs() / cpu_loss.abs()).max())
    w_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(net.parameters(), cpu_net.parameters()))
    sigma = max(float(torch.linalg.matrix_norm(layer.weight.detach(), ord=2))
                for layer in net.layers)
    print(f"train ({epochs} full-batch epochs, n_train {n_train}, lr 1e-4, SN 4, f32, TF32 off): "
          f"loss {float(loss[0]):.5f} -> {float(loss[-1]):.5f}; {dev.type} {rate:.1f} epochs/s, "
          f"cpu {cpu_rate:.1f} epochs/s; max |loss - loss_cpu| / loss_cpu over the epochs "
          f"{loss_rel:.3g} (bound {TRAIN_LOSS_RTOL:g}); max |w - w_cpu| {w_diff:.3g} (bound "
          f"{TRAIN_W_ATOL:g}); max sigma_max {sigma:.6f} (bound 4 + 1e-3)")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train: losses {loss_rel} from the CPU's, relative")
    check(w_diff <= TRAIN_W_ATOL, f"train: weights {w_diff} from the CPU's")
    check(float(loss[-1]) < float(loss[0]), "train: the loss did not drop")
    check(sigma <= 4.0 + 1e-3, f"train: sigma_max {sigma} past the projection")

    x0, xr, ur, other = inputs(B, dev, seed)
    ctl = controller(dev)
    st = ctl.reset(xr, ur)
    f = forecast(net, other, xr, x0, torch.bfloat16)
    (u0, _, info), launches = count_launches(ctl.update, st, x0, xr, ur, f)
    n_ok = int(info.ok.sum())
    print(f"train: the trained net's bf16 forecast (max |f| {float(f.abs().max()):.4f} N) into one "
          f"deployed tick at B={B}: ok {n_ok}/{B}; launches {launched(launches)}")
    check(bool(torch.isfinite(u0).all()) and n_ok == B, "train: the forecast's tick is unhealthy")
    check_launches("train's deployed tick", launches, {"K1": 1}, dev)
    return {"epochs_per_s": rate, "loss_rel": loss_rel, "w_diff": w_diff}


def phase_envelope(dev, max_d=100, recovery_ticks=500):
    """Phase 12: the far-regime envelope, `tools/qp_envelope_torch.py` at
    `--iters 3 --whole-ipm --bf16` (K3 + K2), cold and `--warm`, d = 1 ...
    `max_d` m; the same sweep on the deployed one-kernel controller (K1,
    warm@3, bf16): every scenario healthy (the JAX package's 100/100,
    BENCH_DETAILS.json `envelope_at_3_iters`). Then the closed loop from 50
    m (`tests/test_far_regime.py:74-99`): the per-scenario scan controller
    at qp_iters 8, float64, `recovery_ticks` ticks through an RK4 plant:
    the setpoint reached within 0.05 m and the command never outside the
    actuator box."""
    qe = tool("qp_envelope_torch")
    cpu = ["--cpu", "--f32"] if dev.type == "cpu" else []
    out = {}
    for tag, flags in (("cold", []), ("warm", ["--warm"])):
        args = qe.make_parser().parse_args(
            ["--backend", "pallas", "--iters", "3", "--whole-ipm", "--bf16", "--max-d",
             str(max_d)] + flags + cpu)
        res, launches = count_launches(qe.run, args)
        lines = res.pop("lines")
        print(f"envelope {tag} (K3 + K2, 3 iterations, bf16): {json.dumps(res)}; launches "
              f"{launched(launches)}" + "".join("\n" + line for line in lines))
        check_launches(f"envelope {tag}", launches, {"K3": 1, "K2": 1}, dev)
        check(res["n_ok"] == res["n"], f"envelope {tag}: {res['n_ok']}/{res['n']} ok, first "
              f"not ok at {res['first_not_ok_m']} m")
        out[tag] = res
    ds = qe.offsets(max_d, 1.0)
    ctl = controller(dev)
    res, launches = count_launches(qe.sweep, ctl, ds, torch.float32, dev)
    s = qe.summary(ds, res)
    print(f"envelope deployed (K1, warm@3, bf16): {json.dumps(s)}; launches {launched(launches)}"
          + "".join("\n" + line for line in qe.boundary_lines(ds, res, 1.0)))
    check_launches("envelope deployed", launches, {"K1": 1}, dev)
    check(s["n_ok"] == s["n"], f"envelope deployed: {s['n_ok']}/{s['n']} ok, first not ok at "
          f"{s['first_not_ok_m']} m")
    out["deployed"] = s

    ocp, veh, f64 = CFG.ocp, CFG.vehicle, torch.float64
    ctl = make_rti_controller(ocp, veh, qp_iters=8, device=dev)
    tgt = torch.tensor([0.0, 0.0, 1.0], dtype=f64, device=dev)
    xr = hover_state(tgt)[None].repeat(N + 1, 1)
    ur = hover_input(veh, (), f64, dev)[None].repeat(N, 1)
    plant = make_discrete_dynamics(
        lambda x, u: body_rate_dynamics(x, u, mass=veh.mass, gravity=veh.gravity),
        ocp.ts_nmpc, 4)
    u_lo = torch.tensor(ocp.u_lower(), dtype=f64, device=dev)
    u_hi = torch.tensor(ocp.u_upper(), dtype=f64, device=dev)
    x = hover_state(torch.tensor([50.0, 0.0, 1.0], dtype=f64, device=dev))
    state = ctl.reset(xr, ur)
    out_of_box = torch.zeros((), dtype=f64, device=dev)
    not_ok = torch.zeros((), dtype=torch.int64, device=dev)
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(recovery_ticks):
        u0, state, info = ctl.update(state, x, xr, ur)
        out_of_box = torch.maximum(out_of_box, torch.maximum(u_lo - u0, u0 - u_hi).max())
        not_ok += ~info.ok
        x = plant(x, u0)
    err = float((x[0:3] - tgt).norm())
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"envelope: closed loop from 50 m ({recovery_ticks} ticks, scan controller at qp_iters "
          f"8, f64): |pos - target| {err:.4g} m (bound 0.05); worst excursion of the command past "
          f"the actuator box {float(out_of_box):.3g} (bound 1e-9); not-ok ticks "
          f"{int(not_ok)}; {wall * 1e3 / recovery_ticks:.2f} ms a tick; launches "
          f"{launched(launches)}")
    check(err < 0.05, f"recovery from 50 m left {err} m")
    check(float(out_of_box) <= 1e-9, f"recovery from 50 m: command {float(out_of_box)} past "
          "the actuator box")
    check_launches("recovery from 50 m", launches, {}, dev)
    out["recovery"] = {"err_m": err, "not_ok_ticks": int(not_ok)}
    return out


# Phase 13's paths and their launches a tick (the scan controller none)
VALIDATE = {
    "jax": {},
    "pallas": {"K3": 1, "K6": 1, "K7": 1, "K4": 12, "K5": 12},
    "pallas_warm": {"K3": 1, "K6": 1, "K7": 1, "K4": 3, "K5": 3},
    "whole_step_bf16": {"K1": 1},
}


def phase_validate(dev, ticks=300, hold_ticks=100):
    """Phase 13: `tools/validate_backends_torch.py --warm-iters 3
    --whole-step`, the figure-eight mission (`hold_ticks` hold, then
    tracking) on the scan controller, the kernels cold@12 and warm@3 from
    the clipped-LQR start (K3, K6 + K7, K4 + K5 each iteration) and the
    deployed one-kernel step (K1, warm@3, bf16): each kernel path's max
    control deviation from the scan controller below 1e-3 (BASELINE.md),
    its launches exact."""
    vb = tool("validate_backends_torch")
    args = vb.make_parser().parse_args(
        ["--ticks", str(ticks), "--hold-ticks", str(hold_ticks), "--warm-iters", "3",
         "--whole-step"] + (["--cpu"] if dev.type == "cpu" else []))
    traces = {}
    for name, extra in vb.variants(args):
        traces[name], launches = count_launches(vb.fly, extra, args, dev)
        metrics, wall = traces[name][2:]
        print(f"validate {name}: pos RMSE {float(metrics.pos_rmse[0]):.5f} m, ok "
              f"{bool(metrics.ok.all())}, {wall * 1e3 / ticks:.2f} ms a tick; launches "
              f"{launched(launches)}")
        check(bool(metrics.ok.all()), f"validate {name}: not ok")
        check_launches(f"validate {name}", launches,
                       {k: v * ticks for k, v in VALIDATE[name].items()}, dev)
    out = vb.deviations(traces, ticks, 1)
    print("validate: " + "; ".join(
        f"{n} max |u - u_scan| {v['max_control_deviation']:.3g}, max divergence "
        f"{v['max_traj_divergence_m']:.3g} m" for n, v in out.items() if isinstance(v, dict))
        + f" over {ticks} ticks ({ticks - hold_ticks} tracking; bound {vb.TOLERANCE:g})")
    check(out["pass"], f"validate: a path's control deviation reached {vb.TOLERANCE}")
    return out


def phase_ipm_whole(dev, B=65536, iters=6, reps=20):
    """Phase 14: `tools/bench_ipm_whole_torch.py` at B, `iters` IPM
    iterations: one linearized QP batch (one K3 launch) solved by K2 (the
    whole IPM) and by K4 + K5 each iteration, cold solves held element by
    element, then each timed over `reps` solves carrying the duals after
    one warm-up solve: reps + 2 solves each way."""
    res, launches = count_launches(tool("bench_ipm_whole_torch").run, B, iters, reps, dev)
    print(f"ipm_whole (B={B}, {iters} iterations, {res['card']}): K2 {res['whole_ms']:.3f} ms a "
          f"solve, K4 + K5 {res['per_iter_ms']:.3f} ms ({res['speedup']:.2f}x); cold solves "
          f"{testing.describe(res['errors'])}; launches {launched(launches)}")
    check(not res["bad"], f"ipm_whole: {res['bad']} out of tolerance")
    solves = reps + 2
    check_launches("ipm_whole", launches,
                   {"K3": 1, "K2": solves, "K4": solves * iters, "K5": solves * iters}, dev)
    return res


def same(tag, got, want):
    """Every tensor of two equally shaped trees bitwise equal."""
    bad = []
    tree_map(lambda a, b: a is None or torch.equal(a, b) or bad.append(tuple(a.shape)), got, want)
    check(not bad, f"{tag}: sharded and unsharded differ in the leaves of shapes {bad}")


def phase_sharded(dev, mlp, seed, single_sps, B=65536, ticks=3, n_swarms=21845,
                  episode_ticks=100, S=64):
    """Phase 15: the parallel package over a one-rank process group (NCCL
    on the card, gloo in the CPU rehearsal), every path against its
    unsharded twin on the same inputs, bitwise; each path's launches
    counted from 0 just before it and read just after."""
    t_phase = time.perf_counter()
    with distributed.local_group(device=None if dev.type == "cuda" else dev):
        # a. the deployed step through make_sharded_step
        ctl = controller(dev)
        x0, xr, ur, other = inputs(B, dev, seed)

        def step(state, x0, xr, ur, other):
            return ctl.update(state, x0, xr, ur, forecast(mlp, other, xr, x0, torch.bfloat16))

        args0 = (ctl.reset(xr, ur), x0, xr, ur, other)
        mesh = batch_step.data_mesh()
        sfn, place = batch_step.make_sharded_step(step, mesh, args0, layout=ctl.layout)
        st_s, *rest = place(args0)
        for k in KERNELS.values():
            k.launches = 0
        for _ in range(ticks):
            u_s, st_s, info_s = sfn(st_s, *rest)
        launches = {name: k.launches for name, k in KERNELS.items()}
        st_u = clone_state(args0[0])
        for _ in range(ticks):
            u_u, st_u, info_u = step(st_u, *args0[1:])
        same(f"sharded step (B={B}, {ticks} ticks)", (u_s, st_s, info_s.ok), (u_u, st_u, info_u.ok))
        same("sharded step, gathered u0", batch_step.gather(mesh, u_s), u_u)
        print(f"sharded step (deployed, B={B}, world {distributed.process_count()}, "
              f"{dist_backend()}): {ticks} chained ticks bitwise equal to the unsharded step "
              f"(u0, state, ok); ok {int(info_s.ok.sum())}/{B}; launches {launched(launches)}")
        check_launches("sharded step", launches, {"K1": ticks}, dev)
        check(bool(info_s.ok.all()), f"sharded step: {int((~info_s.ok).sum())} unhealthy")

        # b. the sharded row
        row, skip = batch_step.measure_sharded_row(step, args0, B=B, single_sps=single_sps,
                                                   mesh=mesh, packed_state=True)
        check(skip is None, f"sharded row skipped: {skip}")
        print(f"sharded row: {json.dumps(row)}")
        check(row["n_devices"] == 1 and row["B_global"] == B and row["ok"] == B,
              f"sharded row: {row}")
        del args0, st_s, st_u, rest, ctl

        # c. the grouped formation swarm as a sharded episode
        D = 3 * n_swarms
        kw = dict(n_groups=n_swarms, anchors=grid_placement(n_swarms), use_ndp=True,
                  downwash_params=mlp, true_downwash=True, qp_iters=3, solver_warm_start=True,
                  solver_whole_ipm=True, solver_jac_bf16=True, solver_packed_state=False,
                  solver_whole_step=True, solver_backend="pallas", recover=True,
                  hold_ticks=episode_ticks // 2)
        traj = cli.build_eight(device=dev)
        runs = {"sharded": make_sharded_episode(CFG, traj, make_mesh(1, 1), n_drones=D,
                                                scenario_batch=1, **kw),
                "unsharded": make_episode(CFG, traj, n_drones=D, device=dev, **kw)[::2]}
        out, ms, counted = {}, {"sharded": [], "unsharded": []}, {}
        for turn in ("unsharded", "sharded", "sharded", "unsharded"):  # in turns: A, B, B, A
            init, run = runs[turn]
            st0 = init(dtype=torch.float32)
            for k in KERNELS.values():
                k.launches = 0
            sync(dev)
            t0 = time.perf_counter()
            res = run(st0, episode_ticks)[:2]
            sync(dev)
            ms[turn].append((time.perf_counter() - t0) * 1e3 / episode_ticks)
            counted[turn] = {name: k.launches for name, k in KERNELS.items()}
            out.setdefault(turn, res)
            del st0, res
        (st_s, m_s), (st_u, m_u) = out["sharded"], out["unsharded"]
        unstack = lambda t: tree_map(lambda a: a[0] if isinstance(a, torch.Tensor) else a, t)
        same(f"sharded episode ({D} drones)", (unstack(m_s), unstack(st_s).plant),
             (m_u, st_u.plant))
        print(f"sharded episode (formation swarm, {D} drones, mesh data 1 x swarm 1, "
              f"batch-first state, {episode_ticks} ticks, {kw['hold_ticks']} of hold): metrics "
              f"and plant state bitwise equal to the unsharded episode; ok "
              f"{int(m_s.ok.sum())}/{D}, recovered {int(m_s.recovered.sum())}; ms a tick (wall, "
              f"synchronised, in turns unsharded, sharded, sharded, unsharded): sharded "
              f"{' / '.join(f'{t:.3f}' for t in ms['sharded'])}, unsharded "
              f"{' / '.join(f'{t:.3f}' for t in ms['unsharded'])}; launches a run "
              f"{launched(counted['sharded'])}")
        per_tick = PATHS["two-kernel"][1]
        for turn, launches in counted.items():
            check_launches(f"{turn} episode", launches,
                           {k: v * episode_ticks for k, v in per_tick.items()}, dev)
        check(bool(m_s.ok.all()), f"sharded episode: {int((~m_s.ok).sum())} drones not ok")
        del out, st_s, st_u, m_s, m_u

        # d. the sharded swarm step against its unsharded replay
        ctl = controller(dev, packed_state=False, whole_step=False)
        g = torch.Generator().manual_seed(seed + 2)
        Dw = 4
        x0 = hover_state(torch.rand(S, Dw, 3, generator=g) * 2.0 - 1.0).to(dev)
        xr_lead = hover_state(torch.zeros(S, 3, device=dev))[:, None].repeat(1, N + 1, 1)
        ur_lead = hover_input(CFG.vehicle, (S,), device=dev)[:, None].repeat(1, N, 1)
        offsets = torch.zeros(S, Dw, 3, device=dev)
        offsets[..., 2] = 0.7 * torch.arange(Dw, device=dev)
        xr = torch.cat([xr_lead[:, None, :, 0:3] + offsets[:, :, None, :],
                        xr_lead[:, None, :, 3:].expand(S, Dw, N + 1, 7)], dim=-1)
        ur = ur_lead[:, None].expand(S, Dw, N, 4)
        flat = lambda a: a.reshape((S * Dw,) + a.shape[2:])
        unflat = lambda a: a.reshape((S, Dw) + a.shape[1:])
        rti0 = tree_map(unflat, ctl.reset(flat(xr), flat(ur)))
        swarm_step = make_sharded_swarm_step(CFG, ctl, make_mesh(1, 1), downwash_params=mlp)
        for k in KERNELS.values():
            k.launches = 0
        u_s, new_s, n_ok_s = swarm_step(rti0, x0, xr_lead, ur_lead, offsets)
        launches = {name: k.launches for name, k in KERNELS.items()}
        rel = x0[:, None, :, 0:6] - x0[:, :, None, 0:6]
        with torch.no_grad():
            f_pair = mlp(rel)
        f_pair = torch.where((rel == 0.0).all(dim=-1, keepdim=True),
                             torch.zeros((), dtype=f_pair.dtype, device=dev), f_pair)
        f_dist = f_pair.sum(dim=2)[:, :, None, :].expand(S, Dw, N + 1, 3)
        u_u, new_u, info_u = ctl.update(tree_map(flat, rti0), flat(x0), flat(xr), flat(ur),
                                        flat(f_dist))
        same(f"sharded swarm step (S={S}, D={Dw})", (u_s, new_s, n_ok_s),
             (unflat(u_u), tree_map(unflat, new_u), info_u.ok.reshape(S, Dw).sum(dim=1)))
        print(f"sharded swarm step (S={S} scenarios x {Dw} drones, f32, the MLP's pair forces, "
              f"batch-first K3 + K2): bitwise equal to the unsharded replay; n_ok "
              f"{int(n_ok_s.sum())}/{S * Dw}; launches {launched(launches)}")
        check_launches("sharded swarm step", launches, PATHS["two-kernel"][1], dev)
        check(bool(torch.isfinite(u_s).all()), "sharded swarm step: u0 not finite")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")


def phase_spawned(dev, seed, single_sps, B=65536):
    """Phase 15, across processes: `dryrun_multichip` and the sharded row on
    every card of this host, one process a card (`launch.spawn` of
    `entry.multichip_rank`; one gloo rank in the CPU rehearsal). Holds the
    data-parallel training step (its averaged gradients, its loss, the
    weights after it) against the one-process step on the whole batch
    (`entry.train_step_diff`: bitwise at world 1), `ok` B on the row, and
    `ok` for every drone of the dry run's episodes."""
    world = torch.cuda.device_count() if dev.type == "cuda" else 1
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(multichip_rank, world, device=None if dev.type == "cuda" else "cpu",
                args=(B, seed, single_sps), timeout_s=600)
    t_spawn = time.perf_counter() - t0
    for r in res:
        dry = r["dry"]
        n_ok = sum(int(np.sum(dry[part]["ok"])) for part in ("episode", "formation"))
        n_all = sum(np.size(dry[part]["ok"]) for part in ("episode", "formation"))
        print(f"dryrun_multichip rank {r['rank']} on {r['device']} (mesh {dry['mesh']}): episode "
              f"and formation ok {n_ok}/{n_all} drones, loss {dry['loss']!r}; {r['t_dry']:.1f} s")
        check(n_ok == n_all, f"dryrun rank {r['rank']}: {n_all - n_ok} drones not ok")
    d = train_step_diff([r["dry"] for r in res], dev)
    print(f"data-parallel training step at world {world} against the one-process step on the "
          f"whole batch ({world * ROWS_PER_RANK} rows, lr {TRAIN_LR}): {json.dumps(d)}")
    check(d["replicated"], "data-parallel step: the ranks' weights or gradients differ")
    if world == 1:
        check(d["bitwise"], "data-parallel step at world 1 is not bitwise the one-process step")
    else:
        check(d["weights_max_abs_diff"] <= 1e-6 and d["grads_max_rel_diff"] <= 1e-5
              and d["loss_rel_diff"] <= 1e-5, "data-parallel step out of tolerance")
    rows = [r["row"] for r in res]
    row = rows[0]
    check(res[0]["skip"] is None, f"sharded row skipped: {res[0]['skip']}")
    print(f"sharded row over {world} process(es) (one a card): {json.dumps(row)}; K1 launches a "
          f"rank {[r['k1'] for r in res]}; the launch {t_spawn:.1f} s")
    check(all(r == row for r in rows), f"the ranks' rows differ: {rows}")
    check(row["n_devices"] == world and row["B_global"] == B and row["ok"] == B,
          f"sharded row: {row}")
    if dev.type == "cuda":
        check(all(r["k1"] == 31 for r in res), "sharded row: K1 not launched 31 times a rank")
    return row


def phase_profilers(dev, k1_ms, B=65536, sweep_B=4096):
    """Phase 16: the two profilers. The deployed step's attribution at B
    (`tools/profile_trace_torch.py`): the buckets sum to the device total
    within 0.1%, the K1 bucket within 15% of K1's ms on the kernels line;
    the qp_iters sweep at `sweep_B` (`tools/profile_step_torch.py`):
    t(12) > t(6) > t(0); K1's device-only tick at B=1 and 64 under 20 ms
    (and the scan controller's beside it)."""
    t_phase = time.perf_counter()
    trace, prof_step = tool("profile_trace_torch"), tool("profile_step_torch")
    att, launches = count_launches(trace.step_attribution, B, dev=dev)
    total, per = att["device_total_us_per_step"], att["per_component_us"]
    trace.report(att, file=sys.stdout)
    s = sum(per.values())
    print(f"attribution at B={B}: buckets sum {s:.1f} us against the device total {total:.1f} "
          f"us ({100 * abs(s - total) / total:.4f}%); K1 bucket {per['step_whole_kernel']:.1f} "
          f"us against K1's {k1_ms * 1e3:.1f} on the kernels line; launches {launched(launches)}")
    check(abs(s - total) <= 1e-3 * total, "attribution: the buckets do not sum to the total")
    check(abs(per["step_whole_kernel"] - k1_ms * 1e3) <= 0.15 * k1_ms * 1e3,
          "attribution: the K1 bucket is not within 15% of K1's time")
    check_launches("attribution", launches, {"K1": 1 + trace.N_STEPS}, dev)
    res, launches = count_launches(prof_step.run, sweep_B)
    t, k = res["qp_iters_ms"], res["kernels_us"]
    print(f"profile_step at B={sweep_B}: qp_iters 0 / 6 / 12 {t['0']:.3f} / {t['6']:.3f} / "
          f"{t['12']:.3f} ms a tick; variants {json.dumps(res['variants_ms'])}; marginal "
          f"{res['per_iter_marginal_us']:.1f} us an iteration (base "
          f"{res['base_extrapolated_ms']:.3f} ms); alone K6 + K7 {k['K6+K7']:.1f}, K3 "
          f"{k['K3']:.1f}, K4 + K5 {k['K4+K5']:.1f} us; glue {res['glue_us']:.1f} us an iteration "
          f"({100 * res['glue_share']:.1f}%); launches {launched(launches)}")
    check(t["12"] > t["6"] > t["0"], f"qp_iters sweep not increasing: {t}")
    if dev.type == "cuda":
        check(all(launches[k] > 0 for k in ("K3", "K4", "K5", "K6", "K7"))
              and launches["K1"] == launches["K2"] == 0,
              f"profile_step launched {launches}: want K3-K7, no K1 or K2")
    inter, launches = count_launches(trace.interactive, dev=dev)
    for key, v in inter.items():
        print(f"interactive device-only {key}: {v['device_us_per_tick'] / 1e3:.3f} ms a tick "
              f"({v['backend']}, {v['config']}; {v['kernels_per_tick']:.0f} kernels a tick, "
              f"wall {v['wall_ms_per_tick']:.3f} ms with the profiler on)")
    print(f"interactive launches {launched(launches)}")
    for key in ("B1_pallas_whole_step", "B64_pallas_whole_step"):
        check(inter[key]["device_us_per_tick"] < 20e3, f"{key}: device tick over 20 ms")
    check_launches("interactive", launches, {"K1": 2 * (1 + trace.N_STEPS)}, dev)
    print(f"profilers phase: {time.perf_counter() - t_phase:.1f} s")
    return att, res, inter


def dist_backend():
    return torch.distributed.get_backend() if torch.distributed.is_initialized() else "no group"


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


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
            one = phase_path(8, dev, args.seed, mlp, "one-kernel", 1, 2)
            two = phase_path(8, dev, args.seed, mlp, "two-kernel", 1, 2)
            phase_agree(two, dev, mlp)
            phase_path(8, dev, args.seed, mlp, "per-iteration", 1, 2)
            phase_compare_sweep(8, dev, args.seed)
            phase_path(8, dev, args.seed, mlp, "per-iteration LQR", 1, 2)
            phase_tensor_lin(8, dev, args.seed, mlp, 1, 2)
            phase_compare_packed(8, dev, args.seed)
            packed = phase_path(8, dev, args.seed, mlp, "pallas_packed", 1, 2)
            phase_packed_agree(packed, dev, mlp, sub=4)
            phase_closed_loop(8, dev, args.seed, mlp)
            phase_mission("three_qd_ndp", ("--cpu",), n_ticks=3)
            phase_mission("three_qd_ndp, kernels", ("--cpu",), n_ticks=3)
            phase_thrust_mission(cpu=True, n_ticks=3)
            phase_daemons(dev, small=True)
            packed = ControllerDaemon(f"smoke_{uuid.uuid4().hex[:8]}", solver="packed", device=dev)
            odom = np.zeros((), qb.ODOMETRY)
            odom["pos"], odom["quat"] = [0.3, -0.2, 1.1], [1.0, 0.0, 0.0, 0.0]
            packed.t.odom.publish(odom)
            packed.run(max_ticks=2)
            NodeTopics.unlink(packed.ns)
            phase_daemon_kernel(packed, dev, mlp, args.seed, B_batch=8)
            phase_train(dev, args.seed, epochs=3, n_train=256, B=8)
            phase_envelope(dev, max_d=10)
            phase_validate(dev, ticks=3, hold_ticks=1)
            phase_ipm_whole(dev, B=8, iters=2)
            phase_sharded(dev, mlp, args.seed, 8 / one["step_ms"] * 1e3, B=8, n_swarms=2,
                          episode_ticks=4, S=2)
            phase_spawned(dev, args.seed, 8 / one["step_ms"] * 1e3, B=8)
            print("rehearsal done: no kernel ran, so no result is printed")
            sys.exit(2)
        phase_build()
        compare = phase_compare(4096, dev, args.seed, mlp)
        phase_compare_two_kernel(4096, dev, args.seed, mlp)
        phase_compare_sweep(4096, dev, args.seed)
        phase_compare_packed(4096, dev, args.seed)
        main_ = phase_path(65536, dev, args.seed, mlp)
        single_sps = 65536 / main_["step_ms"] * 1e3
        two = phase_path(65536, dev, args.seed, mlp, "two-kernel")
        phase_agree(two, dev, mlp)
        per = phase_path(65536, dev, args.seed, mlp, "per-iteration")
        lqr = phase_path(65536, dev, args.seed, mlp, "per-iteration LQR")
        tensor_lin = phase_tensor_lin(65536, dev, args.seed, mlp)
        packed = phase_path(65536, dev, args.seed, mlp, "pallas_packed")
        phase_packed_agree(packed, dev, mlp)
        phase_closed_loop(65536, dev, args.seed, mlp)
        kernels = [phase_kernels(main_, compare, mlp)]
        kernels += phase_kernels_two_kernel(two, per, mlp)
        kernels += phase_kernels_sweep(lqr, mlp)
        kernels += phase_kernels_packed(packed, mlp)
        for k in kernels:  # the launches of the tensor-op linearizer's paths
            name = next(n for n, fn in KERNELS.items() if fn.__name__ == k["name"])
            k["launches_tensor_lin"] = {p: r["launches"][name] for p, r in tensor_lin.items()}
        del main_, two, per, lqr, packed, tensor_lin
        for name in MISSIONS:
            phase_mission(name)
        phase_thrust_mission()
        daemon, c, k1 = phase_daemons(dev)
        kernels[0] |= phase_daemon_kernel(daemon, dev, mlp, args.seed)
        kernels[0]["launches_per_daemon_tick"] = (k1 - 1) / c["ticks"]  # less the warm-up's
        phase_train(dev, args.seed)
        phase_envelope(dev)
        phase_validate(dev)
        phase_ipm_whole(dev)
        phase_sharded(dev, mlp, args.seed, single_sps)
        phase_spawned(dev, args.seed, single_sps)
        phase_profilers(dev, kernels[0]["ms"])
        print(json.dumps({"kernels": kernels}))
    except Fail as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
