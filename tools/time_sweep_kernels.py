"""K8, K4 and K6, the streamed backward sweeps, and K3, the linearization, on
one CUDA card: build, check, time; and the parent commit against this tree.

    python3 tools/time_sweep_kernels.py [--clocks] [--parent DIR] [--sass DIR]

1. Builds `csrc/riccati_packed.cu` (K8), `riccati_iter.cu` (K4),
   `riccati_sweep.cu` (K6) and `linearize.cu` (K3), every nvcc started
   together. Prints ptxas' registers, stack and spills, and each build's
   launch geometry, held against its Python mirror (`_cuda.sweep_geometry`,
   `_cuda.lin_geometry`).
2. Holds each against its plain version at B=4096 and 65536 (K8, K4, K6:
   tensor copies) and 4095 and 65535 (K8's element copies, K4's and K6's
   one-thread sweeps), at the tolerances of `testing.py` (K8: the dense
   payload of `testing.dense_payload`, in both ways `ipm_packed` calls it;
   K4: the f32 and the bf16 payload at the per-iteration path's start,
   `iter_args`; K6: both payloads in both ways the IPM calls it,
   `sweep_args`; K3: both payloads with the forecast, `kernel_inputs`),
   each launch's route checked.
3. Times each at B=65536 and 65535 (CUDA events over 20 queued launches),
   K8 on the Newton call, K4, K6 (the clipped-LQR start) and K3 on the bf16
   payload.
4. `--clocks`: K8, K4 and K6 built with phase clocks (`NDP_TEAM_CLOCKS`),
   each phase's cycles in block 0's first thread over one launch.
5. `--parent DIR` (for example an unpacked `git archive` of the parent
   commit): every kernel K1-K9 from both checkouts' libraries, loaded in one
   process, on the same tensors at B=65536 (K4, K6 and K8 also at 65535):
   outputs compared (bitwise where the kernel's source did not change) and
   times in turns A (this tree), B, B, A (`same_inputs`). Then the parent
   and this tree in turns A, B, B, A, each turn a process in its checkout
   that builds that checkout's kernels, prints their ptxas lines and drives
   the legacy dense step, the per-iteration steps from both starts and the
   one- and two-kernel steps (`chip_smoke.phase_path`: step ms, launches,
   peak memory).
`--sass DIR` writes the default builds' SASS into DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from ndp_nmpc_qd_tpu_torch import testing  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.ops.kernels import (  # noqa: E402
    _build, _cuda, ipm_whole, linearize, riccati, riccati_sparse, step_whole,
)
from ndp_nmpc_qd_tpu_torch.ops.layout import pack  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import (  # noqa: E402
    ipm_consts, lin_consts, whole_step_consts,
)
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm  # noqa: E402

N = cs.N
BUILDS = {  # name -> (source, defines)
    "K8": ("riccati_packed", ()),
    "K4": ("riccati_iter", ()),
    "K6": ("riccati_sweep", ()),
    "K3": ("linearize", ()),
}
K4_OUT = (("K", "primal"), ("kf", "primal"), ("rhat", "primal"), ("res2", "resid"))
K6_OUT = (("K", "primal"), ("kf", "primal"), ("rhat", "primal"))
KW = ("h", "diag6_stage", "diag6_term", "rdiag_stage")

# One turn of the parent/tree comparison, run in a checkout's root.
DRIVE = (
    "import torch, chip_smoke as cs\n"
    "from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz\n"
    "from ndp_nmpc_qd_tpu_torch.ops.kernels import _build\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "dev, B = torch.device('cuda'), 65536\n"
    "_build.build()\n"
    "for n in _build.SOURCES:\n"
    "    print(f'ptxas {n}: {cs.ptxas_summary(_build.build_info[n][\"log\"])}', flush=True)\n"
    "mlp = load_npz(cs.ASSET, device=dev)\n"
    "for path in ('pallas_packed', 'per-iteration', 'per-iteration LQR', 'one-kernel',\n"
    "             'two-kernel'):\n"
    "    cs.phase_path(B, dev, 0, mlp, path)\n"
)


def build_all(builds):
    """Build every (source, defines) at once, one process each; return the
    loaded libraries by name, typed by their wrapper modules."""
    procs = []
    for src, defines in set(builds.values()):
        code = ("import sys; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
                f"import _build; _build.build(({src!r},), {defines!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=HERE))
    cs.check(all(p.wait() == 0 for p in procs), "a build failed")
    libs = {}
    for name, (src, defines) in builds.items():
        raw = _build.load(src, defines)
        libs[name] = {"riccati_packed": riccati._lib, "riccati_iter": riccati_sparse._lib,
                      "riccati_sweep": riccati_sparse._sweep_lib,
                      "linearize": linearize._lib}[src](raw)
        key = f"{src}[{','.join(defines)}]" if defines else src
        print(f"build {name}: {cs.ptxas_summary(_build.build_info[key]['log'])}")
    return libs


def geometry(libs):
    for B in (1, 7, 301, 4096, 65535, 65536):
        got = riccati.geometry(B, libs["K8"])
        want = _cuda.sweep_geometry("packed", B)
        cs.check(got == want, f"K8 geometry B={B}: C {got}, Python {want}")
        for jac_bf16 in (False, True):
            for name, kind, fn in (("K4", "glue", riccati_sparse.geometry),
                                   ("K6", "given", riccati_sparse.sweep_geometry)):
                got = fn(B, jac_bf16, libs[name])
                want = _cuda.sweep_geometry(kind, B, jac_bf16)
                cs.check(got == want, f"{name} geometry B={B}: C {got}, Python {want}")
        got = linearize.geometry(B, N, libs["K3"])
        want = _cuda.lin_geometry(B, N)
        cs.check(got == want, f"K3 geometry B={B}: C {got}, Python {want}")
    print(f"geometry K8 (B=65536): {riccati.geometry(65536, libs['K8'])}")
    print(f"geometry K4 (B=65536, bf16): {riccati_sparse.geometry(65536, True, libs['K4'])}")
    print(f"geometry K6 (B=65536, bf16): {riccati_sparse.sweep_geometry(65536, True, libs['K6'])}")
    print(f"geometry K6 (B=65536, f32): {riccati_sparse.sweep_geometry(65536, False, libs['K6'])}")
    print(f"geometry K3 (B=65536): {linearize.geometry(65536, N, libs['K3'])}")
    print("geometry: C export == Python mirror for K8, K4, K6 (both payloads) and K3 at B in "
          "(1, 7, 301, 4096, 65535, 65536)")


def inputs(B, dev):
    """Every kernel's inputs at batch B, on the card: K8 by call, K4 by
    payload, K6 by (call, payload), K3 by payload, and the consts."""
    p, dx0 = testing.dense_payload(cs.CFG, B, dev, 0)
    ic = ipm_consts(cs.CFG.ocp, num_iters=3)
    out = dict(K8={c: testing.packed_args(p, dx0, c)[:9] for c in ("lqr_start", "newton")},
               K4={}, K6={}, K3={}, ic=ic, kw={k: ic[k] for k in KW}, lc={})
    for jac_bf16 in (False, True):
        tag = "bf16" if jac_bf16 else "f32"
        lc = lin_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=jac_bf16)
        ins = testing.kernel_inputs(B, N, dev, 0)
        qp = linearize.linearize_stage_data_plain(*ins, **lc)
        out["K3"][tag] = ins
        out["lc"][tag] = lc
        out["K4"][tag] = testing.iter_args(qp, ic)[:22]
        for call in ("lqr_start", "unfused_glue"):
            out["K6"][call, tag] = testing.sweep_args(qp, ic, call)[0][:13]
    return out


def check_k3(ins, lc):
    got = linearize.linearize_stage_data(*ins, **lc)
    ref = linearize.linearize_stage_data_plain(*ins, **lc)
    jac = "bf16" if lc.get("jac_bf16") else "primal"
    return testing.compare({n: (jac if n in ("hq", "a", "b") else "primal", g, r)
                            for n, g, r in zip(testing.QP_NAMES, got, ref)})


def check_k6(lib, args, kw):
    got = riccati_sparse.sweep_backward_launch(*args, lib=lib, **kw)
    ref = riccati_sparse.riccati_sweep_backward_plain(*args, **kw)
    return testing.compare({n: (kind, g, r) for (n, kind), g, r in zip(K6_OUT, got, ref)})


def report(name, where, errs, bad):
    print(f"{name} vs plain ({where}): {testing.describe(errs)}")
    cs.check(not bad, f"{name} ({where}): {bad} out of tolerance")


def check(libs, dev):
    for B in (4096, 65536):
        ins = inputs(B, dev)
        kw = ins["kw"]
        for b in (B, B - 1):  # tensor copies; K8's element copies, K4's / K6's one-thread sweep
            for call, args in ins["K8"].items():
                args = cs.first(args, b)
                ref = riccati.riccati_backward_packed_plain(*args)
                got = riccati.backward_packed_launch(*args, lib=libs["K8"])
                route = riccati.last_route(libs["K8"])
                cs.check_route("K8", route, cs.k8_route(b), b)
                report("K8", f"{call}, B={b}, {route}", *testing.compare(
                    {n: ("primal", g, r) for n, g, r in zip(("K", "kf"), got, ref)}))
            for tag, args in ins["K4"].items():
                args = cs.first(args, b)
                ref = riccati_sparse.riccati_backward_glue_plain(*args, **kw)
                got = riccati_sparse.backward_glue_launch(*args, lib=libs["K4"], **kw)
                route = riccati_sparse.last_route(libs["K4"])
                cs.check_route("K4", route, cs.k4_route(b), b)
                report("K4", f"{tag} payload, B={b}, {route}", *testing.compare(
                    {n: (kind, g, r) for (n, kind), g, r in zip(K4_OUT, got, ref)}))
            for (call, tag), args in ins["K6"].items():
                errs, bad = check_k6(libs["K6"], cs.first(args, b), kw)
                route = riccati_sparse.last_sweep_route(libs["K6"])
                cs.check_route("K6", route, cs.k6_route(b), b)
                report("K6", f"{call}, {tag} payload, B={b}, {route}", errs, bad)
            for tag, args in ins["K3"].items():
                report("K3", f"{tag} payload, B={b}", *check_k3(cs.first(args, b), ins["lc"][tag]))
        del ins
    torch.cuda.synchronize()


def runs(libs, ins, odd=None):
    """name -> a launch of each timed kernel from `libs` on `ins` (the first
    `odd` scenarios with `odd`)."""
    cut = (lambda a: cs.first(a, odd)) if odd else (lambda a: a)
    a8, a4 = cut(ins["K8"]["newton"]), cut(ins["K4"]["bf16"])
    a6, a3 = cut(ins["K6"]["lqr_start", "bf16"]), cut(ins["K3"]["bf16"])
    kw, lc = ins["kw"], ins["lc"]["bf16"]
    return {
        "K8": lambda: riccati.backward_packed_launch(*a8, lib=libs["K8"]),
        "K4": lambda: riccati_sparse.backward_glue_launch(*a4, lib=libs["K4"], **kw),
        "K6": lambda: riccati_sparse.sweep_backward_launch(*a6, lib=libs["K6"], **kw),
        "K3": lambda: linearize.linearize_stage_data(*a3, **lc),
    }


def timing(libs, dev, B=65536, reps=20):
    ins = inputs(B, dev)
    todo = {**runs(libs, ins), **{f"{k} at B={B - 1}": f for k, f in runs(libs, ins, B - 1).items()}}
    times = {}
    for name in list(todo) + list(todo)[::-1]:
        todo[name]()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(cs.cuda_ms(todo[name], reps))
    for name, ts in times.items():
        print(f"time {name}: {ts[0]:.4f}, {ts[1]:.4f} ms ({reps} queued launches each, turns "
              f"forward then backward; K8 the Newton call, K4, K6 (clipped-LQR start) and K3 the "
              f"bf16 payload)")


CLOCK_BUILDS = {  # phase clocks (NDP_TEAM_CLOCKS)
    "K8": ("riccati_packed", ("NDP_TEAM_CLOCKS",)),
    "K4": ("riccati_iter", ("NDP_TEAM_CLOCKS",)),
    "K6": ("riccati_sweep", ("NDP_TEAM_CLOCKS",)),
}
CLOCK_EXPORTS = {"K8": "riccati_packed_backward_clocks", "K4": "riccati_backward_clocks",
                 "K6": "riccati_sweep_backward_clocks"}
PHASES = ("stage io", "bwd terminal", "bwd A (rows, defects)", "bwd B", "bwd C", "bwd E",
          "bwd D (gains)", "stage out (payload store)", "wait (inputs, block barrier)")
PHASE_IDS = (0, 3, 4, 5, 6, 7, 14, 12, 13)  # their ndp::ClockPhase values


def clocks(dev, B=65536):
    """Cycles of each phase in block 0's first thread, one launch of each
    clocks build (the first launch's counts dropped)."""
    libs = build_all(CLOCK_BUILDS)
    ins = inputs(B, dev)
    run = runs(libs, ins)
    for name, (src, defines) in CLOCK_BUILDS.items():
        take = getattr(_build.load(src, defines), CLOCK_EXPORTS[name])
        take.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        take.restype = ctypes.c_int
        out = (ctypes.c_longlong * 16)()
        run[name]()
        torch.cuda.synchronize()
        take(out)
        ms = cs.cuda_ms(run[name], 1)
        cs.check(take(out) == 0, f"{name} clocks failed")
        vals = [out[i] for i in PHASE_IDS]
        total = sum(vals)
        print(f"{name} cycles in block 0's first thread (one launch, {ms:.3f} ms with the clocks, "
              f"B={B}): total {total}; " + ", ".join(
                  f"{ph} {v} ({100 * v / total:.1f}%)" for ph, v in zip(PHASES, vals) if v))


# Every kernel library's launch exports, typed here for the other checkout's
# libraries, whose other exports may differ from this tree's.
LAUNCHERS = {
    "step_whole": ("step_whole_launch",),
    "ipm_whole": ("ipm_whole_launch",),
    "linearize": ("linearize_launch",),
    "riccati_iter": ("riccati_backward_launch", "riccati_forward_launch"),
    "riccati_sweep": ("riccati_sweep_backward_launch", "riccati_sweep_forward_launch"),
    "riccati_packed": ("riccati_packed_backward_launch", "riccati_packed_forward_launch"),
}


def kernel_cases(dev, B=65536):
    """name -> (fn, inputs, kinds): each kernel K1-K9 through its wrapper
    (which launches from the library `_build.load` returns) on fresh copies
    of fixed inputs at B=65536 (K4, K6, K8 also 65535), and the kinds of its
    outputs for `testing.compare`."""
    ins = inputs(B, dev)
    kw, ic = ins["kw"], ins["ic"]
    lc = ins["lc"]["bf16"]
    mlp = load_npz(cs.ASSET, device=dev)
    x0, xr, ur, other = cs.inputs(B, dev, 0)
    f = cs.forecast(mlp, other, xr, x0, torch.bfloat16)
    k1 = (pack(xr), pack(ur), pack(xr), pack(ur), pack(f), pack(x0[:, None]),
          *cold_warm(N, B, torch.float32, dev))
    c1 = whole_step_consts(cs.CFG.ocp, cs.CFG.vehicle, True, jac_bf16=True, num_iters=3)
    qp = linearize.linearize_stage_data_plain(*ins["K3"]["bf16"], **lc)
    k2 = (*qp[:11], *cold_warm(N, B, torch.float32, dev), qp[11])
    a4 = ins["K4"]["bf16"]
    K, kf, rh, _ = riccati_sparse.riccati_backward_glue_plain(*a4, **kw)
    it = testing.iter_args(qp, ic)
    k5 = (it[3], it[4], it[5], rh, K, kf, *it[7:22], it[22])
    sw, _ = testing.sweep_args(qp, ic, "lqr_start")
    K6_, kf6, rh6 = riccati_sparse.riccati_sweep_backward_plain(*sw[:13], **kw)
    k7 = (sw[3], sw[4], sw[5], rh6, K6_, kf6, sw[13], sw[14], sw[15])
    l8 = testing.packed_args(*testing.dense_payload(cs.CFG, B, dev, 0), "lqr_start")
    K8_, kf8 = riccati.riccati_backward_packed_plain(*l8[:9])
    k9 = (l8[6], l8[7], l8[8], K8_, kf8, *l8[9:])
    a6 = ins["K6"]["lqr_start", "bf16"]
    a8 = ins["K8"]["newton"]
    p = lambda *names: tuple("dual" if n in testing.DUAL_NAMES else "primal" for n in names)
    return {
        "K1": (lambda *a: step_whole.control_step_whole(*a, **c1), k1,
               p("eq")),  # outputs: eq; the state in place is compared too
        "K2": (lambda *a: ipm_whole.riccati_ipm_whole(*a, **ic), k2, p("zx", "zu") +
               p(*testing.DUAL_NAMES) + ("resid",)),
        "K3": (lambda *a: linearize.linearize_stage_data(*a, **lc), ins["K3"]["bf16"],
               tuple("bf16" if n in ("hq", "a", "b") else "primal" for n in testing.QP_NAMES)),
        "K4": (lambda *a: riccati_sparse.riccati_backward_glue(*a, **kw), a4,
               tuple(k for _, k in K4_OUT)),
        "K4 at B=65535": (lambda *a: riccati_sparse.riccati_backward_glue(*a, **kw),
                          cs.first(a4, B - 1), tuple(k for _, k in K4_OUT)),
        "K5": (lambda *a: riccati_sparse.riccati_forward_glue(*a, h=ic["h"], tau=ic["tau"]), k5,
               tuple(k for _, k in testing.FWD_KINDS)),
        "K6": (lambda *a: riccati_sparse.riccati_sweep_backward(*a, **kw), a6, ("primal",) * 3),
        "K6 at B=65535": (lambda *a: riccati_sparse.riccati_sweep_backward(*a, **kw),
                          cs.first(a6, B - 1), ("primal",) * 3),
        "K7": (lambda *a: riccati_sparse.riccati_sweep_forward(*a, h=ic["h"], with_hold=True),
               k7, ("primal",) * 3),
        "K8": (lambda *a: riccati.riccati_backward_packed(*a), a8, ("primal",) * 2),
        "K8 at B=65535": (lambda *a: riccati.riccati_backward_packed(*a), cs.first(a8, B - 1),
                          ("primal",) * 2),
        "K9": (lambda *a: riccati.riccati_forward_packed(*a), k9, ("primal",) * 2),
    }


def same_inputs(other, dev, reps=20):
    """Every kernel from this tree's libraries (A) and the other
    checkout's (B), loaded in one process, on the same tensors: outputs
    (and the state K1 and K2 update in place) compared, then times in turns
    A, B, B, A. The wrappers launch from whichever library `_build.load`
    holds for their source, so each side's libraries are swapped in."""
    code = ("import sys, json; sys.path.insert(0, '.'); from ndp_nmpc_qd_tpu_torch.ops.kernels "
            "import _build; _build.build(); print(json.dumps({n: str(_build._lib_path(n)) "
            "for n in _build.SOURCES}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=other, capture_output=True, text=True,
                          timeout=900)
    cs.check(done.returncode == 0, f"the other checkout's build failed:\n{done.stderr}")
    paths = json.loads(done.stdout.strip().splitlines()[-1])
    _build.build()
    sides = {"A": {n: _build.load(n) for n in _build.SOURCES}, "B": {}}
    for n, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in LAUNCHERS[n]:
            getattr(lib, fn).argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_longlong, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib._ndp_ready = True
        sides["B"][n] = lib

    def use(key):
        _build._libs.update({(n, ()): lib for n, lib in sides[key].items()})

    cases = kernel_cases(dev)
    for name, (fn, args, kinds) in cases.items():
        outs = {}
        for key in "AB":
            use(key)
            a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
            out = fn(*a)
            out = out if isinstance(out, tuple) else (out,)
            outs[key] = [t for t in out if t is not None] + [t for t in a if isinstance(
                t, torch.Tensor)] if name in ("K1", "K2") else [t for t in out if t is not None]
        torch.cuda.synchronize()
        if name.split(" ")[0] in ("K3", "K6"):  # redesigned: held at tolerance, not bitwise
            errs, bad = testing.compare({str(i): (kinds[i] if i < len(kinds) else "primal", a, b)
                                         for i, (a, b) in enumerate(zip(outs["A"], outs["B"]))})
            same = f"A vs B at tolerance: {testing.describe(errs)}"
            cs.check(not bad, f"same inputs, {name}: A and B differ out of tolerance: {bad}")
        else:
            diff = [i for i, (a, b) in enumerate(zip(outs["A"], outs["B"]))
                    if not torch.equal(a.isnan(), b.isnan()) or not torch.equal(
                        a[~a.isnan()], b[~b.isnan()])]
            same = "outputs bitwise equal" if not diff else f"outputs {diff} differ"
            cs.check(not diff, f"same inputs, {name}: A and B differ in outputs {diff}")
        times = {}
        for key in "ABBA":
            use(key)
            a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
            fn(*a)
            torch.cuda.synchronize()
            times.setdefault(key, []).append(cs.cuda_ms(lambda: fn(*a), reps))
        print(f"same inputs, {name} (bf16 payload where it has one; {reps} queued launches, turns "
              f"A, B, B, A): this tree {times['A'][0]:.4f}, {times['A'][1]:.4f} ms; the other "
              f"checkout {times['B'][0]:.4f}, {times['B'][1]:.4f} ms; {same}", flush=True)
    use("A")


def parent_turns(other):
    trees = {"A": HERE, "B": os.path.abspath(other)}
    for turn, key in enumerate("ABBA"):
        print(f"turn {turn}: {key} = {trees[key]}", flush=True)
        done = subprocess.run([sys.executable, "-c", DRIVE], cwd=trees[key], timeout=1200)
        cs.check(done.returncode == 0, f"turn {turn} ({key}) failed: {done.returncode}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout (B) for the comparisons with it")
    ap.add_argument("--sass", help="write the default builds' SASS into this directory")
    ap.add_argument("--clocks", action="store_true", help="also the phase cycles of K8, K4, K6")
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
        libs = build_all(BUILDS)
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
            same_inputs(args.parent, dev)
            parent_turns(args.parent)
    except cs.Fail as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
