"""K1 and K2, the team kernels, on one CUDA card: build, check, time.

Builds `csrc/step_whole.cu` (K1) and `csrc/ipm_whole.cu` (K2) with a team
of 16 lanes a scenario (the default) and of 8 (`NDP_TEAM=8`), and once
with phase clocks (`NDP_TEAM_CLOCKS`), every nvcc started together. Prints ptxas'
registers, stack and spills of each and its launch geometry, held against
the Python mirror (`_cuda.team_geometry`); holds each variant of K1 (3
chained ticks) and K2 (3 chained solves, with the axpy folded) against its
plain version at B=4096 with the f32 and the bf16 payload, at
`chip_smoke.check_pair`'s and `testing.py`'s tolerances; then times K1 and
K2 at B=65536 on the bench's operating point (bf16 payload, warm after the
first launch), the variants in turns (16, 8, 8, 16), CUDA
events over 10 queued launches each; last, the cycles of each phase of one
scenario (the clocks build).

    python3 tools/time_team_kernels.py [--sass DIR]

`--sass DIR` also writes the clocks build's SASS into DIR.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ndp_nmpc_qd_tpu_torch import testing  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.ops.kernels import (  # noqa: E402
    _build, _cuda, ipm_whole, linearize, step_whole,
)
from ndp_nmpc_qd_tpu_torch.ops.layout import pack  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import (  # noqa: E402
    ipm_consts, lin_consts, whole_step_consts,
)
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm  # noqa: E402

N = cs.N
VARIANTS = {16: (), 8: ("NDP_TEAM=8",)}
CLOCKS = ("NDP_TEAM_CLOCKS",)


def libs(team):
    d = VARIANTS[team]
    return (step_whole._lib(_build.load("step_whole", d)),
            ipm_whole._lib(_build.load("ipm_whole", d)))


def k1(lib, state, ins, consts):
    args, eq = step_whole.launch_args(state[0], state[1], *ins, *state[2:], **consts)
    _cuda.launch(lib.step_whole_launch, *args)
    return eq


def k2(lib, qp, duals, xu, consts):
    args, outs = ipm_whole.launch_args(*qp[:11], *duals, qp[11], *xu, **consts)
    _cuda.launch(lib.ipm_whole_launch, *args)
    return outs


def check(team, dev, mlp, B=4096):
    lk1, lk2 = libs(team)
    for jac_bf16 in (False, True):
        tag = f"T={team}, {'bf16' if jac_bf16 else 'f32'} payload, B={B}"
        consts = whole_step_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=jac_bf16,
                                   num_iters=3)
        x0, xr, ur, other = cs.inputs(B, dev, 0)
        fd = cs.forecast(mlp, other, xr, x0, None)
        ins = (pack(xr), pack(ur), pack(fd), pack(x0[:, None]))
        k = [pack(xr).clone(), pack(ur).clone(), *cold_warm(N, B, torch.float32, dev)]
        p = [t.clone() for t in k]
        worst = {}
        for tick in range(3):
            eq_k = k1(lk1, k, ins, consts)
            outs = step_whole.control_step_whole_plain(p[0], p[1], *ins, *p[2:], **consts)
            for dst, src in zip(p, outs[:7]):
                dst.copy_(src)
            e = cs.pair_errors(k, eq_k, p, outs[7])
            cs.check_pair(f"K1 {tag}, tick {tick}", jac_bf16, e, B)
            worst = {n: max(worst.get(n, v), v) for n, v in e.items() if isinstance(v, float)}
        print(f"K1 vs plain ({tag}, 3 chained ticks, worst): "
              + ", ".join(f"{n} {v:.3g}" for n, v in worst.items()))

        lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=jac_bf16)
        ic = ipm_consts(cs.CFG.ocp, num_iters=3)
        xin = testing.kernel_inputs(B, N, dev, 0)
        qp = linearize.linearize_stage_data_plain(*xin, **lc)
        dk = list(cold_warm(N, B, torch.float32, dev))
        dp = [t.clone() for t in dk]
        xk = [t.clone() for t in xin[:2]]
        xp = list(xin[:2])
        worst, bad = {}, set()
        for _ in range(3):
            zx, zu, eq = k2(lk2, qp, dk, xk, ic)
            ref = ipm_whole.riccati_ipm_whole_plain(*qp[:11], *dp, qp[11], *xp, **ic)
            dp, xp = list(ref[2:7]), list(ref[:2])
            errs, b = testing.compare({
                n: ("primal" if n in ("zx", "zu") else "resid" if n == "eq" else "dual", g, r)
                for n, g, r in zip(("zx", "zu") + testing.DUAL_NAMES + ("eq",),
                                   (zx, zu, *dk, eq), ref)})
            bad.update(b)
            worst = {n: max(worst.get(n, 0.0), v) for n, v in errs.items()}
        print(f"K2 vs plain ({tag}, 3 chained solves, fold): {testing.describe(worst)}")
        cs.check(not bad, f"K2 ({tag}): {sorted(bad)} out of tolerance")


def timing(dev, mlp, B=65536, reps=10):
    consts = whole_step_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True, num_iters=3)
    lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True)
    ic = ipm_consts(cs.CFG.ocp, num_iters=3)
    x0, xr, ur, other = cs.inputs(B, dev, 0)
    fd = cs.forecast(mlp, other, xr, x0, torch.bfloat16)
    ins = (pack(xr), pack(ur), pack(fd), pack(x0[:, None]))
    state = [pack(xr).clone(), pack(ur).clone(), *cold_warm(N, B, torch.float32, dev)]
    qp = linearize.linearize_stage_data(state[0], state[1], *ins, **lc)
    duals = list(cold_warm(N, B, torch.float32, dev))
    xu = [state[0].clone(), state[1].clone()]
    times = {}
    for team in (16, 8, 8, 16):
        lk1, lk2 = libs(team)
        t1 = cs.cuda_ms(lambda: k1(lk1, state, ins, consts), reps)
        t2 = cs.cuda_ms(lambda: k2(lk2, qp, duals, xu, ic), reps)
        times.setdefault(team, []).append((t1, t2))
        print(f"T={team}: K1 {t1:.3f} ms, K2 {t2:.3f} ms (B={B}, bf16 payload, CUDA events, "
              f"{reps} queued launches)")
    for team, ts in times.items():
        g = step_whole.geometry(B, N, True, lib=libs(team)[0])
        print(f"T={team} mean of its two turns: K1 {sum(t[0] for t in ts) / 2:.3f} ms, K2 "
              f"{sum(t[1] for t in ts) / 2:.3f} ms; {g['scenarios_per_block']} scenarios, "
              f"{g['threads_per_block']} threads and {g['smem_bytes_per_block']} B of shared "
              f"memory a block")
    cs.check(bool(torch.isfinite(state[0]).all()), "K1 state not finite after timing")


PHASES = (
    "stage in", "linearize", "IPM start", "bwd terminal", "bwd A (defects, glue)",
    "bwd B (P rh, PA, PB)", "bwd C (S, Qh, Rh, chol4, gains)", "bwd E (P update)",
    "rollout", "box rows", "row sums c1-c4", "pass B", "stage out", "wait", "bwd D",
)


def clocks(dev, mlp, B=65536):
    """Cycles of each phase in block 0's first scenario (lane 0's clock64),
    one launch of each kernel built with NDP_TEAM_CLOCKS, T=16."""
    consts = whole_step_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True, num_iters=3)
    lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True)
    ic = ipm_consts(cs.CFG.ocp, num_iters=3)
    x0, xr, ur, other = cs.inputs(B, dev, 0)
    fd = cs.forecast(mlp, other, xr, x0, torch.bfloat16)
    ins = (pack(xr), pack(ur), pack(fd), pack(x0[:, None]))
    state = [pack(xr).clone(), pack(ur).clone(), *cold_warm(N, B, torch.float32, dev)]
    qp = linearize.linearize_stage_data(state[0], state[1], *ins, **lc)
    duals = list(cold_warm(N, B, torch.float32, dev))
    xu = [state[0].clone(), state[1].clone()]
    d = CLOCKS
    runs = (("K1", step_whole._lib(_build.load("step_whole", d)), "step_whole_clocks",
             lambda lib: k1(lib, state, ins, consts)),
            ("K2", ipm_whole._lib(_build.load("ipm_whole", d)), "ipm_whole_clocks",
             lambda lib: k2(lib, qp, duals, xu, ic)))
    for name, lib, fn, run in runs:
        take = getattr(lib, fn)
        take.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        take.restype = ctypes.c_int
        out = (ctypes.c_longlong * len(PHASES))()
        run(lib)
        torch.cuda.synchronize()
        take(out)  # drop the first launch's counts
        ms = cs.cuda_ms(lambda: run(lib), 1)
        cs.check(take(out) == 0, f"{fn} failed")
        total = sum(out)
        print(f"{name} cycles in block 0's first scenario (one launch, {ms:.3f} ms with the "
              f"clocks): total {total}; " + ", ".join(
                  f"{ph} {v} ({100 * v / total:.1f}%)" for ph, v in zip(PHASES, out) if v))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    procs = []  # every variant builds at once: one process each
    for d in (*VARIANTS.values(), CLOCKS):
        code = ("import sys; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
                f"import _build; _build.build(('step_whole', 'ipm_whole'), {d!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code]))
    cs.check(all(p.wait() == 0 for p in procs), "a build failed")
    for team in VARIANTS:
        libs(team)
    for key, info in _build.build_info.items():
        print(f"build: {key}: {cs.ptxas_summary(info['log'])}")
    if "--sass" in sys.argv:  # the clocks build's SASS, for reading offline
        out = sys.argv[sys.argv.index("--sass") + 1]
        os.makedirs(out, exist_ok=True)
        for name in ("step_whole", "ipm_whole"):
            lib = _build._lib_path(name, CLOCKS)
            cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
            with open(os.path.join(out, f"{name}_clocks.sass"), "w") as f:
                subprocess.run([cuobjdump, "-sass", str(lib)], stdout=f, timeout=120)
    for team in VARIANTS:
        for B in (1, 7, 301, 4096, 65535, 65536):
            for jac_bf16 in (False, True):
                for lib in libs(team):
                    fn = getattr(lib, [n for n in ("step_whole_geometry", "ipm_whole_geometry")
                                       if hasattr(lib, n)][0])
                    got = _cuda.c_geometry(fn, B, N, jac_bf16)
                    want = _cuda.team_geometry(B, N, jac_bf16, team)
                    cs.check(got == want, f"geometry T={team} B={B}: C {got}, Python {want}")
        print(f"geometry T={team}: C export == Python mirror at B in (1, 7, 301, 4096, 65535, "
              f"65536), both payloads; B=65536 bf16: "
              f"{_cuda.team_geometry(65536, N, True, team)}")
    mlp = load_npz(cs.ASSET, device=dev)
    try:
        for team in VARIANTS:
            check(team, dev, mlp)
        timing(dev, mlp)
        clocks(dev, mlp)
    except cs.Fail as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
