"""K8 and K4, the streamed backward sweeps, on one CUDA card: build, check,
time; and the parent commit against this tree in turns.

    python3 tools/time_sweep_kernels.py [--clocks] [--parent DIR] [--sass DIR]

1. Builds `csrc/riccati_packed.cu` (K8) and `csrc/riccati_iter.cu` (K4),
   both nvcc started together. Prints ptxas' registers, stack and spills,
   and each build's launch geometry, held against the Python mirror
   (`_cuda.sweep_geometry`).
2. Holds both against their plain versions at B=4096 and 65536 (tensor
   copies) and 4095 and 65535 (K8's element copies, K4's one-thread sweep),
   at the tolerances of `testing.py` (K8: the dense payload of
   `testing.dense_payload`, in both ways `ipm_packed` calls it; K4: the f32
   and the bf16 payload at the per-iteration path's start, `iter_args`),
   each launch's route checked.
3. Times both at B=65536 and 65535 (CUDA events over 20 queued launches),
   K8 on the Newton call and K4 on the bf16 payload.
4. With `--parent DIR` (for example an unpacked `git archive` of the parent
   commit): the parent (B) and this tree (A) in turns A, B, B, A, each turn
   a process in its checkout that builds that checkout's kernels, prints
   their ptxas lines, and prints K8, K4 and K9 ms at B=65536 and K8 and K4
   at 65535 on the same inputs, then the legacy dense step, the
   per-iteration steps from both starts, and the one- and two-kernel steps
   as controls (`chip_smoke.phase_path`: step ms, launches, peak memory).
   Before the turns, K4 at B=65535 from both checkouts' libraries in one
   process on the same tensors (`same_inputs`).

`--clocks` also builds K8 and K4 with phase clocks (`NDP_TEAM_CLOCKS`) and
prints each phase's cycles in block 0's first thread over one launch.
`--sass DIR` writes the default builds' SASS into DIR.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from ndp_nmpc_qd_tpu_torch import testing  # noqa: E402
from ndp_nmpc_qd_tpu_torch.ops.kernels import (  # noqa: E402
    _build, _cuda, linearize, riccati, riccati_sparse,
)
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, lin_consts  # noqa: E402

N = cs.N
BUILDS = {  # name -> (source, defines)
    "K8": ("riccati_packed", ()),
    "K4": ("riccati_iter", ()),
}

K4_OUT = (("K", "primal"), ("kf", "primal"), ("rhat", "primal"), ("res2", "resid"))

# One turn of the parent/tree comparison, run in a checkout's root.
DRIVE = (
    "import json, torch, chip_smoke as cs\n"
    "from ndp_nmpc_qd_tpu_torch import testing\n"
    "from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz\n"
    "from ndp_nmpc_qd_tpu_torch.ops.kernels import _build, linearize, riccati, riccati_sparse\n"
    "from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, lin_consts\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "dev, B = torch.device('cuda'), 65536\n"
    "p, dx0 = testing.dense_payload(cs.CFG, B, dev, 0)\n"
    "a8 = testing.packed_args(p, dx0, 'newton')[:9]\n"
    "l8 = testing.packed_args(p, dx0, 'lqr_start')\n"
    "K, kf = riccati.riccati_backward_packed_plain(*l8[:9])\n"
    "a9 = (l8[6], l8[7], l8[8], K, kf, *l8[9:])\n"
    "ic = ipm_consts(cs.CFG.ocp, num_iters=3)\n"
    "lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True)\n"
    "qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, cs.N, dev, 0), **lc)\n"
    "a4 = testing.iter_args(qp, ic)[:22]\n"
    "kw4 = {k: ic[k] for k in ('h', 'diag6_stage', 'diag6_term', 'rdiag_stage')}\n"
    "riccati.riccati_backward_packed(*a8); riccati_sparse.riccati_backward_glue(*a4, **kw4)\n"
    "riccati.riccati_forward_packed(*a9)\n"
    "torch.cuda.synchronize()\n"
    "for n in ('riccati_packed', 'riccati_iter'):\n"
    "    print(f'ptxas {n}: {cs.ptxas_summary(_build.build_info[n][\"log\"])}', flush=True)\n"
    "k9 = cs.cuda_ms(lambda: riccati.riccati_forward_packed(*a9), 20)\n"
    "k8 = cs.cuda_ms(lambda: riccati.riccati_backward_packed(*a8), 20)\n"
    "k4 = cs.cuda_ms(lambda: riccati_sparse.riccati_backward_glue(*a4, **kw4), 20)\n"
    "o8 = [t[..., :B - 1].contiguous() for t in a8]\n"
    "o4 = [t[..., :B - 1].contiguous() for t in a4]\n"
    "k8o = cs.cuda_ms(lambda: riccati.riccati_backward_packed(*o8), 20)\n"
    "k4o = cs.cuda_ms(lambda: riccati_sparse.riccati_backward_glue(*o4, **kw4), 20)\n"
    "print(json.dumps({'K8_ms': k8, 'K4_ms': k4, 'K9_ms': k9, 'K8_ms_B65535': k8o,\n"
    "                  'K4_ms_B65535': k4o}), flush=True)\n"
    "del o8, o4\n"
    "del p, dx0, a8, l8, a9, K, kf, qp, a4\n"
    "mlp = load_npz(cs.ASSET, device=dev)\n"
    "for path in ('pallas_packed', 'per-iteration', 'per-iteration LQR', 'one-kernel',\n"
    "             'two-kernel'):\n"
    "    cs.phase_path(B, dev, 0, mlp, path)\n"
)


def build_all():
    procs = []  # every build at once: one process each
    for src, defines in BUILDS.values():
        code = ("import sys; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
                f"import _build; _build.build(({src!r},), {defines!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE))
    cs.check(all(p.wait() == 0 for p in procs), "a build failed")
    libs = {}
    for name, (src, defines) in BUILDS.items():
        lib = _build.load(src, defines)
        libs[name] = (riccati._lib(lib) if src == "riccati_packed" else riccati_sparse._lib(lib))
        key = f"{src}[{','.join(defines)}]" if defines else src
        print(f"build {name}: {cs.ptxas_summary(_build.build_info[key]['log'])}")
    return libs


def geometry(libs):
    for B in (1, 7, 301, 4096, 65535, 65536):
        got = riccati.geometry(B, libs["K8"])
        want = _cuda.sweep_geometry("packed", B)
        cs.check(got == want, f"K8 geometry B={B}: C {got}, Python {want}")
        for jac_bf16 in (False, True):
            got = riccati_sparse.geometry(B, jac_bf16, libs["K4"])
            want = _cuda.sweep_geometry("glue", B, jac_bf16)
            cs.check(got == want, f"K4 geometry B={B}: C {got}, Python {want}")
    print(f"geometry K8 (B=65536): {riccati.geometry(65536, libs['K8'])}")
    print(f"geometry K4 (B=65536): {riccati_sparse.geometry(65536, True, libs['K4'])}")
    print("geometry: C export == Python mirror for K8 and K4 (both payloads) at B in "
          "(1, 7, 301, 4096, 65535, 65536)")


def k8_inputs(B, dev):
    p, dx0 = testing.dense_payload(cs.CFG, B, dev, 0)
    return {call: testing.packed_args(p, dx0, call)[:9] for call in ("lqr_start", "newton")}


def k4_inputs(B, dev):
    ic = ipm_consts(cs.CFG.ocp, num_iters=3)
    kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    out = {}
    for jac_bf16 in (False, True):
        lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=jac_bf16)
        qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, dev, 0), **lc)
        out["bf16" if jac_bf16 else "f32"] = testing.iter_args(qp, ic)[:22]
    return out, kw


def check(libs, dev):
    for B in (4096, 65536):
        i8, (i4, kw) = k8_inputs(B, dev), k4_inputs(B, dev)
        for b in (B, B - 1):  # tensor copies; K8's element copies, K4's one-thread sweep
            for call, args in i8.items():
                args = cs.first(args, b)
                ref = riccati.riccati_backward_packed_plain(*args)
                got = riccati.backward_packed_launch(*args, lib=libs["K8"])
                route = riccati.last_route(libs["K8"])
                cs.check_route("K8", route, cs.k8_route(b), b)
                errs, bad = testing.compare(
                    {n: ("primal", g, r) for n, g, r in zip(("K", "kf"), got, ref)})
                print(f"K8 vs plain ({call}, B={b}, {route}): {testing.describe(errs)}")
                cs.check(not bad, f"K8 ({call}, B={b}): {bad} out of tolerance")
            for tag, args in i4.items():
                args = cs.first(args, b)
                ref = riccati_sparse.riccati_backward_glue_plain(*args, **kw)
                got = riccati_sparse.backward_glue_launch(*args, lib=libs["K4"], **kw)
                route = riccati_sparse.last_route(libs["K4"])
                cs.check_route("K4", route, cs.k4_route(b), b)
                errs, bad = testing.compare({n: (kind, g, r) for (n, kind), g, r in zip(
                    K4_OUT, got, ref)})
                print(f"K4 vs plain ({tag} payload, B={b}, {route}): {testing.describe(errs)}")
                cs.check(not bad, f"K4 ({tag}, B={b}): {bad} out of tolerance")
    torch.cuda.synchronize()


def timing(libs, dev, B=65536, reps=20):
    a8 = k8_inputs(B, dev)["newton"]
    ins, kw = k4_inputs(B, dev)
    a4 = ins["bf16"]
    odd = B - 1  # K8's rows element by element, K4's one-thread sweep
    o8, o4 = cs.first(a8, odd), cs.first(a4, odd)
    runs = {
        "K8": lambda: riccati.backward_packed_launch(*a8, lib=libs["K8"]),
        "K4": lambda: riccati_sparse.backward_glue_launch(*a4, lib=libs["K4"], **kw),
        f"K8 at B={odd}": lambda: riccati.backward_packed_launch(*o8, lib=libs["K8"]),
        f"K4 at B={odd}": lambda: riccati_sparse.backward_glue_launch(*o4, lib=libs["K4"], **kw),
    }
    times = {}
    for name in list(runs) + list(runs)[::-1]:
        runs[name]()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(cs.cuda_ms(runs[name], reps))
    for name, ts in times.items():
        print(f"time {name}: {ts[0]:.4f}, {ts[1]:.4f} ms ({reps} queued launches each, turns "
              f"forward then backward; K8 the Newton call, K4 the bf16 payload)")


CLOCK_BUILDS = {  # phase clocks (NDP_TEAM_CLOCKS)
    "K8": ("riccati_packed", ("NDP_TEAM_CLOCKS",)),
    "K4": ("riccati_iter", ("NDP_TEAM_CLOCKS",)),
}
PHASES = ("stage io", "bwd terminal", "bwd A (rows, defects)", "bwd B", "bwd C", "bwd E",
          "bwd D (gains)", "stage out (payload store)", "wait (inputs, block barrier)")
PHASE_IDS = (0, 3, 4, 5, 6, 7, 14, 12, 13)  # their ndp::ClockPhase values


def clocks(dev, B=65536):
    """Cycles of each phase in block 0's first thread, one launch of each
    clocks build (the first launch's counts dropped)."""
    import ctypes
    builds = {}
    procs = []
    for src, defines in CLOCK_BUILDS.values():
        code = ("import sys; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
                f"import _build; _build.build(({src!r},), {defines!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE))
    cs.check(all(p.wait() == 0 for p in procs), "a clocks build failed")
    a8 = k8_inputs(B, dev)["newton"]
    ins, kw = k4_inputs(B, dev)
    for name, (src, defines) in CLOCK_BUILDS.items():
        raw = _build.load(src, defines)
        if src == "riccati_packed":
            lib, take = riccati._lib(raw), raw.riccati_packed_backward_clocks
            run = lambda lib=lib: riccati.backward_packed_launch(*a8, lib=lib)
        else:
            lib, take = riccati_sparse._lib(raw), raw.riccati_backward_clocks
            run = lambda lib=lib: riccati_sparse.backward_glue_launch(*ins["bf16"], lib=lib, **kw)
        take.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        take.restype = ctypes.c_int
        out = (ctypes.c_longlong * 16)()
        run()
        torch.cuda.synchronize()
        take(out)
        ms = cs.cuda_ms(run, 1)
        cs.check(take(out) == 0, f"{name} clocks failed")
        vals = [out[i] for i in PHASE_IDS]
        total = sum(vals)
        print(f"{name} cycles in block 0's first thread (one launch, {ms:.3f} ms with the clocks, "
              f"B={B}): total {total}; " + ", ".join(
                  f"{ph} {v} ({100 * v / total:.1f}%)" for ph, v in zip(PHASES, vals) if v))


def same_inputs(libs, other, dev, B=65535, reps=20):
    """K4's one-thread sweep (an odd B) from this tree's library (A) and
    the other checkout's (B), loaded in one process and run on the same
    tensors in turns A, B, B, A: the kernels alone, where the turns'
    processes also differ in where their allocations lie. Needs the same
    `IterPtrs` layout on both sides; says so and returns where it is not."""
    import ctypes
    code = ("import sys; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
            "import _build; _build.build(('riccati_iter',)); "
            "print(_build._lib_path('riccati_iter'))")
    done = subprocess.run([sys.executable, "-c", code], cwd=other, capture_output=True, text=True,
                          timeout=600)
    cs.check(done.returncode == 0, f"the other checkout's build failed:\n{done.stderr}")
    lib = ctypes.CDLL(done.stdout.strip().splitlines()[-1])
    if lib.riccati_iter_ptrs_size() != ctypes.sizeof(riccati_sparse._IterPtrs):
        print("same inputs: the other checkout's IterPtrs differs; not compared")
        return
    lib.riccati_backward_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_longlong, ctypes.c_void_p]
    lib.riccati_backward_launch.restype = ctypes.c_int
    lib._ndp_ready = True  # typed here: its other exports may differ from this tree's
    ins, kw = k4_inputs(B + 1, dev)
    a4 = cs.first(ins["bf16"], B)
    ref = riccati_sparse.riccati_backward_glue_plain(*a4, **kw)
    sides = {"A": libs["K4"], "B": lib}
    times = {}
    for key in "ABBA":
        got = riccati_sparse.backward_glue_launch(*a4, lib=sides[key], **kw)
        errs, bad = testing.compare({n: (kind, g, r) for (n, kind), g, r in zip(K4_OUT, got, ref)})
        cs.check(not bad, f"same inputs: {key}: {bad} out of tolerance")
        times.setdefault(key, []).append(cs.cuda_ms(
            lambda: riccati_sparse.backward_glue_launch(*a4, lib=sides[key], **kw), reps))
    print(f"same inputs, K4 at B={B} (bf16 payload, one process, {reps} queued launches, turns "
          f"A, B, B, A): this tree {times['A'][0]:.4f}, {times['A'][1]:.4f} ms; the other checkout "
          f"{times['B'][0]:.4f}, {times['B'][1]:.4f} ms")


def parent_turns(other):
    trees = {"A": HERE, "B": os.path.abspath(other)}
    for turn, key in enumerate("ABBA"):
        print(f"turn {turn}: {key} = {trees[key]}", flush=True)
        done = subprocess.run([sys.executable, "-c", DRIVE], cwd=trees[key], timeout=1200)
        cs.check(done.returncode == 0, f"turn {turn} ({key}) failed: {done.returncode}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout (B) for the turns A, B, B, A")
    ap.add_argument("--sass", help="write the default builds' SASS into this directory")
    ap.add_argument("--clocks", action="store_true",
                    help="also the phase cycles of K8 and K4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    try:
        libs = build_all()
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
            for src, _ in BUILDS.values():
                with open(os.path.join(args.sass, f"{src}.sass"), "w") as f:
                    subprocess.run([cuobjdump, "-sass", str(_build._lib_path(src))], stdout=f,
                                   timeout=120)
        geometry(libs)
        check(libs, dev)
        timing(libs, dev)
        if args.clocks:
            clocks(dev)
        if args.parent:
            same_inputs(libs, args.parent, dev)
            parent_turns(args.parent)
    except cs.Fail as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
