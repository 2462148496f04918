"""ctypes binding shared by the CUDA kernel wrappers.

Every `csrc/<name>.cu` exports `<name>_consts_size()` and `<name>_ptrs_size()`
(checked against the mirrors here at load) and launch functions of one
signature, `int fn(int jac_bf16, const StepConsts*, const Ptrs*, long long B,
void* stream)`, returning `cudaGetLastError()` after the launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_F = ctypes.c_float
_P = ctypes.c_void_p


def pointers(names):
    """ctypes fields of void pointers, one per name."""
    return [(n, _P) for n in names]


class StepConsts(ctypes.Structure):
    """Mirror of `ndp::StepConsts` (csrc/ndp.cuh)."""

    _fields_ = [
        ("h", _F), ("rk_half", _F), ("rk_step", _F), ("rk_sixth", _F),
        ("inv_mass", _F), ("gravity", _F), ("stage_scale", _F),
        ("q_diag", _F * 10), ("gx_scale", _F * 6), ("gu_scale", _F * 4),
        ("u_lo", _F * 4), ("u_hi", _F * 4), ("v_lo", _F * 3), ("v_hi", _F * 3),
        ("big", _F), ("diag6_stage", _F * 6), ("diag6_term", _F * 6),
        ("rdiag_stage", _F * 4), ("tau", _F), ("sigma", _F), ("mu0", _F),
        ("s_min", _F), ("mu_min", _F), ("substeps", ctypes.c_int),
        ("num_iters", ctypes.c_int), ("n_stages", ctypes.c_int),
        ("with_dist", ctypes.c_int),
    ]


QP_FIELDS = ("hq", "gx", "gu", "a", "b", "bc", "r", "lub", "uub", "lxb", "uxb", "dx0")


class QpPtrs(ctypes.Structure):
    """Mirror of `ndp::QpPtrs`: a SparseQp payload and dx0."""

    _fields_ = pointers(QP_FIELDS)


def step_consts(n_stages: int, c: dict) -> StepConsts:
    """Kernel constants from a keyword dict; products are formed here in
    double and rounded once, as the plain version's Python-float scalars
    are. Fields a kernel does not read may be missing: they stay 0."""
    arr = lambda key, n: (_F * n)(*[float(t) for t in c.get(key, (0.0,) * n)])
    out = StepConsts(
        h=c["h"], big=c.get("big", 0.0), q_diag=arr("q_diag", 10),
        u_lo=arr("u_lo", 4), u_hi=arr("u_hi", 4), v_lo=arr("v_lo", 3),
        v_hi=arr("v_hi", 3), diag6_stage=arr("diag6_stage", 6),
        diag6_term=arr("diag6_term", 6), rdiag_stage=arr("rdiag_stage", 4),
        tau=c.get("tau", 0.0), sigma=c.get("sigma", 0.0),
        mu0=c.get("mu_init", 0.0), s_min=c.get("s_min", 0.0),
        mu_min=c.get("mu_min", 0.0), num_iters=c.get("num_iters", 0),
        n_stages=n_stages, with_dist=int(bool(c.get("with_dist", False))),
    )
    if "substeps" in c:  # the linearization's constants
        hh = c["h"] / c["substeps"]
        s = c["stage_scale"]
        out.rk_half, out.rk_step, out.rk_sixth = 0.5 * hh, hh, hh / 6.0
        out.inv_mass, out.gravity, out.stage_scale = 1.0 / c["mass"], c["gravity"], s
        out.substeps = c["substeps"]
        out.gx_scale = (_F * 6)(*[s * q for q in c["q_diag"][:6]])
        out.gu_scale = (_F * 4)(*[s * r for r in c["r_diag"]])
    return out


def bind(name: str, ptrs_type, launchers, geometry=None, lib=None):
    """The loaded library of `csrc/<name>.cu` (or `lib`, one built from it)
    with its functions typed and its struct sizes checked against the
    mirrors. `geometry`: the name of its team-geometry export."""
    lib = lib or _build.load(name)
    if getattr(lib, "_ndp_ready", False):
        return lib
    with _build.lock:
        if getattr(lib, "_ndp_ready", False):
            return lib
        for fn in launchers:
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_int, _P, _P, ctypes.c_longlong, _P]
            f.restype = ctypes.c_int
        if geometry:
            f = getattr(lib, geometry)
            f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.POINTER(ctypes.c_longlong)]
            f.restype = None
        for fn in (f"{name}_consts_size", f"{name}_ptrs_size"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        sizes = (getattr(lib, f"{name}_consts_size")(),
                 getattr(lib, f"{name}_ptrs_size")())
        if sizes != (ctypes.sizeof(StepConsts), ctypes.sizeof(ptrs_type)):
            raise RuntimeError(f"{name}: ctypes mirrors disagree with csrc: {sizes}")
        lib._ndp_ready = True
    return lib


def launch(fn, jac_bf16: bool, consts: StepConsts, ptrs, B: int, device) -> None:
    """Launch on the current stream of `device`; raise if the launch failed."""
    err = fn(int(jac_bf16), ctypes.byref(consts), ctypes.byref(ptrs), B,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")


def need_cuda(name: str, t) -> None:
    """A wrapper takes the plain version for CPU tensors only."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype:
        raise ValueError(
            f"{name}: need {dtype} on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t):
    """Device pointer of a tensor, None for a missing one."""
    return None if t is None else t.data_ptr()


JAC_FIELDS = ("hq", "a", "b")  # stored in the jac dtype


def qp_shapes(N: int, B: int) -> dict:
    return dict(
        hq=(N + 1, 16, B), gx=(N + 1, 10, B), gu=(N, 4, B), a=(N, 40, B),
        b=(N, 30, B), bc=(N, 6, B), r=(N, 10, B), lub=(N, 4, B), uub=(N, 4, B),
        lxb=(N + 1, 3, B), uxb=(N + 1, 3, B), dx0=(1, 10, B),
    )


def qp_ptrs(fields: dict, N: int, B: int, jac_bf16: bool, device) -> QpPtrs:
    """Check the payload tensors given by name (a subset of QP_FIELDS) and
    return their pointers; fields not given stay null."""
    shapes = qp_shapes(N, B)
    jd = torch.bfloat16 if jac_bf16 else torch.float32
    for name, t in fields.items():
        check(name, t, shapes[name], device, jd if name in JAC_FIELDS else torch.float32)
    return QpPtrs(**{n: ptr(t) for n, t in fields.items()})


# ---- the team kernels' launch geometry (csrc/ndp_team.cuh) ----

TEAM = 16  # lanes a scenario (NDP_TEAM)
SMEM_MAX = 232448  # dynamic shared memory a block may take on sm_90
MAX_THREADS = 256  # the team kernels' __launch_bounds__
WORK_FLOATS = 352  # the backward stage's work area
SCALAR_FLOATS = 8
GEOMETRY_KEYS = (
    "threads_per_scenario", "scenarios_per_block", "threads_per_block", "blocks",
    "smem_bytes_per_block", "scenario_bytes", "slot_bytes",
)


def team_arrays(n_stages: int, jac_bf16: bool) -> list:
    """(name, bytes) of the arrays of one scenario's slot, in slot order,
    each f32 array padded to 16 bytes (the jac-dtype payload is one run).
    "K" also holds K1's step inputs and the box rows' directions, "work"
    (the backward stage's) the directions dx and du."""
    N = n_stages
    f = lambda *names_sizes: [(n, 16 * -(-s // 4)) for n, s in names_sizes]  # 16-byte aligned
    jb = 2 if jac_bf16 else 4
    u, x, v = N * 4, (N + 1) * 10, (N + 1) * 3
    k = max(N * 40, 2 * x + 2 * u + v + 10, 4 * u + 4 * v)
    return f(
        ("gx", x), ("gu", u), ("bc", N * 6), ("r", N * 10), ("lub", u), ("uub", u),
        ("lxb", v), ("uxb", v), ("dx0", 10),
        ("K", k), ("kf", u), ("rh", N * 10), ("sul", u), ("suu", u), ("sxl", v), ("sxu", v),
        ("zx", x), ("zu", u),
        ("lul", u), ("luu", u), ("lxl", v), ("lxu", v),
        ("work", max(WORK_FLOATS, x + u)), ("scalars", SCALAR_FLOATS),
    ) + [("hq", jb * (N + 1) * 16), ("a", jb * N * 40), ("b", jb * N * 30)]


def team_geometry(B: int, n_stages: int, jac_bf16: bool, team: int = TEAM) -> dict:
    """Launch geometry of K1/K2 for B scenarios, as `ndp::team_geometry`
    computes it: a slot of the arrays' bytes, padded to a stride of floats
    congruent to `team` mod 32 (neighbouring slots start `team` banks apart),
    as many slots a block as fit SMEM_MAX, at most MAX_THREADS threads and
    at most B slots."""
    nbytes = sum(b for _, b in team_arrays(n_stages, jac_bf16))
    stride = -(-nbytes // 4)
    stride += (team - stride % 32) % 32
    S = min(SMEM_MAX // (4 * stride), MAX_THREADS // team, B)
    return dict(zip(GEOMETRY_KEYS, (
        team, S, S * team, -(-B // S), S * 4 * stride, nbytes, 4 * stride,
    )))


def c_geometry(fn, B: int, n_stages: int, jac_bf16: bool) -> dict:
    """The geometry a kernel library computes (its `<name>_geometry`)."""
    out = (ctypes.c_longlong * len(GEOMETRY_KEYS))()
    fn(n_stages, int(jac_bf16), B, out)
    return dict(zip(GEOMETRY_KEYS, out))


# ---- the streamed sweeps' launch geometry: K8 (csrc/riccati_packed.cu,
# ndp::k8), K4 and K6 (csrc/riccati_iter.cu and csrc/riccati_sweep.cu, the
# body of csrc/ndp_stream.cuh over the sources ndp::GlueSrc / GivenSrc) ----

# Lanes a scenario (ndp::k8::TEAM, NDP_TEAM as riccati_iter.cu and
# riccati_sweep.cu set it), the compute threads a block at most
# (NDP_K8_THREADS / NDP_K4_THREADS / NDP_K6_THREADS as built by default) and
# the scenarios 16 bytes of a row hold, of each. A block's shared memory is
# its S slots (one stage buffer and the sweep's working set each, whatever
# the horizon), then a landing buffer of one stage's input rows and two
# output buffers of a stage's output rows, each field a box [rows][S] on 128
# bytes, and an mbarrier; its threads are the compute threads in whole warps
# and one producer warp.
SWEEP_KERNELS = {
    "packed": dict(team=4, max_threads=256, vec=4),
    "glue": dict(team=4, max_threads=320, vec=8),
    "given": dict(team=4, max_threads=320, vec=8),
}
_PACKED_IN = (100, 40, 10, 100, 16, 10, 4, 10, 4)  # a, b, r, hxx, huu, gx, gu, sig_x, sig_u
_PACKED_OUT = (40, 4)                              # K, kf
_STREAM_IN_JAC = (16, 40, 30)                      # hq, a, b
# per source: its f32 input fields' rows (landing order), its output fields'
# rows, and its stage buffer's f32 arrays before the jac-dtype payload
_STREAM = {
    "glue": dict(
        in_f32=(10, 4, 6, 10, 4, 4, 3, 3, 10, 4, 4, 4, 3, 3, 4, 4, 3, 3, 1),  # ..., mu
        out=(40, 4, 10, 1),  # K, kf, rh, res2
        slot=(("gx", 10), ("gu", 4), ("bc", 6), ("r", 10), ("lub", 4), ("uub", 4), ("lxb", 3),
              ("uxb", 3), ("zx", 10), ("zu", 4), ("sul", 4), ("suu", 4), ("sxl", 3), ("sxu", 3),
              ("lul", 4), ("luu", 4), ("lxl", 3), ("lxu", 3), ("K", 40), ("kf", 4), ("rh", 10))),
    "given": dict(
        in_f32=(10, 4, 6, 10, 10, 4, 4, 4, 3, 3),  # gx gu bc r zx zu sig_u corr_u sig_x corr_x
        out=(40, 4, 10),  # K, kf, rh
        slot=(("gx", 10), ("gu", 4), ("bc", 6), ("r", 10), ("zx", 10), ("zu", 4), ("sig_u", 4),
              ("corr_u", 4), ("sig_x", 3), ("corr_x", 3), ("K", 40), ("kf", 4), ("rh", 10))),
}


def sweep_arrays(kind: str, jac_bf16: bool = False) -> tuple:
    """(slot arrays, column arrays): (name, bytes) of one scenario's slot of
    K8 ("packed"), K4 ("glue") or K6 ("given") in slot order, every array
    starting on 16 bytes, and of its columns of the block's landing buffer
    (one stage's input rows; K4's also mu) and two output buffers (a stage's
    output rows: K8 K and kf, K4 and K6 also rh, K4 res2)."""
    f = lambda n: 16 * -(-n // 4)  # floats -> bytes, padded to 16
    if kind == "packed":
        slot = [("abr", f(160)), ("hxx_cols", f(120)), ("huu_cols", f(16)), ("ghat", f(16)),
                ("sig", f(16)), ("kf", f(4)), ("pabr_t", f(15 * 16)), ("k_cols", f(40))]
        cols = [("land", 4 * sum(_PACKED_IN)), ("out", 2 * 4 * sum(_PACKED_OUT))]
    else:
        src, jb = _STREAM[kind], 2 if jac_bf16 else 4
        slot = [(n, f(d)) for n, d in src["slot"]] + [("hq_a_b", 16 * -(-86 * jb // 16))]
        slot += [("work", f(WORK_FLOATS)), ("zx1", f(10))]
        cols = [("land_f32", 4 * sum(src["in_f32"])), ("land_jac", jb * sum(_STREAM_IN_JAC)),
                ("out", 2 * 4 * sum(src["out"]))]
    return slot, cols


def sweep_smem(kind: str, S: int, jac_bf16: bool = False) -> int:
    """Shared-memory bytes of a block of S scenarios (`ndp::k8::layout`,
    `ndp::stream::layout`)."""
    r = lambda b: -(-b // 128) * 128
    slot, _ = sweep_arrays(kind, jac_bf16)
    stride = sum(b for _, b in slot) // 4
    stride += (4 - stride % 32) % 32
    if kind == "packed":
        boxes = [4 * rows for rows in _PACKED_IN] + 2 * [4 * rows for rows in _PACKED_OUT]
    else:
        src, jb = _STREAM[kind], 2 if jac_bf16 else 4
        boxes = ([4 * rows for rows in src["in_f32"]] + [jb * rows for rows in _STREAM_IN_JAC]
                 + 2 * [4 * rows for rows in src["out"]])
    return r(4 * S * stride) + sum(r(b * S) for b in boxes) + 16


def sweep_geometry(kind: str, B: int, jac_bf16: bool = False) -> dict:
    """Launch geometry of K8 ("packed"), K4 ("glue") or K6 ("given") for B
    scenarios, as `ndp::k8::geometry` / `ndp::stream::geometry` compute it:
    as many scenarios a block as fit SMEM_MAX, at most the kernel's compute
    threads and B, a multiple of the step that fills whole warps and 16-byte
    rows when there are that many; the compute threads in whole warps, then
    the producer warp."""
    k = SWEEP_KERNELS[kind]
    S = min(k["max_threads"] // k["team"], B)
    while S > 1 and sweep_smem(kind, S, jac_bf16) > SMEM_MAX:
        S -= 1
    step = k["vec"] if k["vec"] * k["team"] > 32 else 32 // k["team"]
    if S >= step:
        S -= S % step
    slot, cols = sweep_arrays(kind, jac_bf16)
    stride = sum(b for _, b in slot) // 4
    stride += (4 - stride % 32) % 32
    return dict(zip(GEOMETRY_KEYS, (
        k["team"], S, -(-S * k["team"] // 32) * 32 + 32, -(-B // S),
        sweep_smem(kind, S, jac_bf16), sum(b for _, b in slot + cols), 4 * stride,
    )))


# ---- the linearization's launch geometry (K3, csrc/linearize.cu, ndp::k3):
# a thread a (stage, scenario), a block a stage of LIN_THREADS consecutive
# scenarios (the terminal node the last); no shared memory ----

LIN_THREADS = 128  # ndp::k3::THREADS


def lin_geometry(B: int, n_stages: int) -> dict:
    """Launch geometry of K3 for B scenarios, as `ndp::k3::geometry`
    computes it: threads a (stage, scenario), scenarios a block, threads a
    block, blocks (a tile of scenarios by a stage), shared memory a block."""
    return dict(
        threads_per_scenario=1, scenarios_per_block=LIN_THREADS, threads_per_block=LIN_THREADS,
        blocks=-(-B // LIN_THREADS) * (n_stages + 1), smem_bytes_per_block=0,
    )
