"""The fused control step: CUDA kernel wrapper, plain version, launch count.

Port of `ndp_nmpc_qd_tpu/ops/pallas/step_whole.py:control_step_whole`. One
step linearizes all N stages at the current RTI iterates, runs the whole
warm-started interior-point QP and folds the SQP axpy, per scenario.

- `control_step_whole` is the entry point. For CUDA tensors it launches the
  hand-written kernel (`csrc/step_whole.cu`, built at first use) or raises;
  for CPU tensors it runs `control_step_whole_plain`. Either way the
  iterates and carried duals update IN PLACE, as the TPU kernel's aliased
  outputs do, and it returns the equality residual.
- `control_step_whole_plain` computes the same function with batched tensor
  algebra: Python loops over stages and iterations, ops on (B,) tensors.
  It works in f32 and f64.

All tensors are in the port's kernel layout (stage, element, B).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ipm_whole import StagePayload, ipm_whole
from .linearize import NU, NX, lin_stage_terms, lin_terminal_terms

_F = ctypes.c_float


class _StepConsts(ctypes.Structure):
    """Mirror of `ndp::StepConsts` (csrc/step_whole.cuh)."""

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


_PTRS = (
    "xb", "ub", "xr", "ur", "fd", "x0", "lu_lo", "lu_up", "lx_lo", "lx_up",
    "mu", "eq", "ws", "wj",
)


class _StepPtrs(ctypes.Structure):
    """Mirror of `ndp::StepPtrs`."""

    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS]


def _lib():
    lib = _build.load("step_whole")
    if not getattr(lib, "_ndp_ready", False):
        lib.step_whole_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        for fn, args in (
            ("step_whole_ws_planes", [ctypes.c_int]),
            ("step_whole_jac_planes", [ctypes.c_int]),
            ("step_whole_consts_size", []),
            ("step_whole_ptrs_size", []),
        ):
            getattr(lib, fn).argtypes = args
        for fn in ("step_whole_launch", "step_whole_ws_planes",
                   "step_whole_jac_planes", "step_whole_consts_size",
                   "step_whole_ptrs_size"):
            getattr(lib, fn).restype = ctypes.c_int
        sizes = (lib.step_whole_consts_size(), lib.step_whole_ptrs_size())
        if sizes != (ctypes.sizeof(_StepConsts), ctypes.sizeof(_StepPtrs)):
            raise RuntimeError(f"ctypes mirrors disagree with csrc: {sizes}")
        lib._ndp_ready = True
    return lib


def _c_consts(c: dict, n_stages: int) -> _StepConsts:
    """Kernel constants; products are formed here in double and rounded
    once, as the plain version's Python-float scalars are."""
    hh = c["h"] / c["substeps"]
    s = c["stage_scale"]
    arr = lambda v, n: (_F * n)(*[float(t) for t in v])
    return _StepConsts(
        h=c["h"], rk_half=0.5 * hh, rk_step=hh, rk_sixth=hh / 6.0,
        inv_mass=1.0 / c["mass"], gravity=c["gravity"], stage_scale=s,
        q_diag=arr(c["q_diag"], 10),
        gx_scale=arr([s * q for q in c["q_diag"][:6]], 6),
        gu_scale=arr([s * r for r in c["r_diag"]], 4),
        u_lo=arr(c["u_lo"], 4), u_hi=arr(c["u_hi"], 4),
        v_lo=arr(c["v_lo"], 3), v_hi=arr(c["v_hi"], 3), big=c["big"],
        diag6_stage=arr(c["diag6_stage"], 6),
        diag6_term=arr(c["diag6_term"], 6),
        rdiag_stage=arr(c["rdiag_stage"], 4), tau=c["tau"],
        sigma=c["sigma"], mu0=c["mu_init"], s_min=c["s_min"],
        mu_min=c["mu_min"], substeps=c["substeps"],
        num_iters=c["num_iters"], n_stages=n_stages,
        with_dist=int(bool(c["with_dist"])),
    )


def make_workspace(B: int, n_stages: int, jac_bf16: bool, device):
    """The kernel's per-scenario scratch: the stage payload and the IPM
    arrays, (planes, B) each. Allocated once per batch size by the caller;
    the kernel allocates nothing."""
    lib = _lib()
    ws = torch.empty(
        (lib.step_whole_ws_planes(n_stages), B), dtype=torch.float32,
        device=device,
    )
    wj = torch.empty(
        (lib.step_whole_jac_planes(n_stages), B),
        dtype=torch.bfloat16 if jac_bf16 else torch.float32, device=device,
    )
    return ws, wj


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: need float32 on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def control_step_whole(
    xb, ub, xr, ur, fd, x0, lu_lo, lu_up, lx_lo, lx_up, mu,
    *, workspace=None, **consts,
):
    """One fused control step; updates xb/ub and the duals IN PLACE.

    xb (N+1, 10, B), ub (N, 4, B) are the RTI iterates; xr/ur the tick's
    references; fd (N+1, 3, B) the downwash forecast (None without
    disturbance); x0 (1, 10, B); lu_* (N, 4, B), lx_* (N+1, 3, B), mu (B,)
    the carried duals (mu < 0 = cold). `consts` are those of
    `solver/ocp_sparse.whole_step_consts`. Returns eq_res (B,).

    Counts its kernel launches in `control_step_whole.launches`.
    """
    state = (xb, ub, lu_lo, lu_up, lx_lo, lx_up, mu)
    if xb.device.type == "cpu":
        outs = control_step_whole_plain(
            xb, ub, xr, ur, fd, x0, lu_lo, lu_up, lx_lo, lx_up, mu, **consts
        )
        for dst, src in zip(state, outs[:7]):
            dst.copy_(src)
        return outs[7]
    if xb.device.type != "cuda":
        raise ValueError(f"control_step_whole: unsupported device {xb.device}")

    Np1, _, B = xb.shape
    N = Np1 - 1
    dev = xb.device
    with_dist = bool(consts["with_dist"])
    if B < 1:
        raise ValueError("control_step_whole: empty batch")
    for name, t, shape in (
        ("xb", xb, (Np1, NX, B)), ("ub", ub, (N, NU, B)),
        ("xr", xr, (Np1, NX, B)), ("ur", ur, (N, NU, B)),
        ("x0", x0, (1, NX, B)),
        ("lu_lo", lu_lo, (N, NU, B)), ("lu_up", lu_up, (N, NU, B)),
        ("lx_lo", lx_lo, (Np1, 3, B)), ("lx_up", lx_up, (Np1, 3, B)),
        ("mu", mu, (B,)),
    ) + ((("fd", fd, (Np1, 3, B)),) if with_dist else ()):
        _check(name, t, shape, dev)
    lib = _lib()
    jac_bf16 = bool(consts.get("jac_bf16", False))
    if workspace is None:
        workspace = make_workspace(B, N, jac_bf16, dev)
    ws, wj = workspace
    _check("workspace", ws, (lib.step_whole_ws_planes(N), B), dev)
    want_jd = torch.bfloat16 if jac_bf16 else torch.float32
    if tuple(wj.shape) != (lib.step_whole_jac_planes(N), B) or (
        wj.dtype != want_jd or wj.device != dev or not wj.is_contiguous()
    ):
        raise ValueError("workspace: jac planes of the wrong shape or dtype")

    eq = torch.empty(B, dtype=torch.float32, device=dev)
    ptrs = _StepPtrs(
        xb=xb.data_ptr(), ub=ub.data_ptr(), xr=xr.data_ptr(),
        ur=ur.data_ptr(), fd=fd.data_ptr() if with_dist else None,
        x0=x0.data_ptr(), lu_lo=lu_lo.data_ptr(), lu_up=lu_up.data_ptr(),
        lx_lo=lx_lo.data_ptr(), lx_up=lx_up.data_ptr(), mu=mu.data_ptr(),
        eq=eq.data_ptr(), ws=ws.data_ptr(), wj=wj.data_ptr(),
    )
    err = lib.step_whole_launch(
        int(jac_bf16), ctypes.byref(_c_consts(consts, N)), ctypes.byref(ptrs),
        B, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"step_whole kernel launch failed: cudaError {err}")
    control_step_whole.launches += 1
    return eq


control_step_whole.launches = 0


def control_step_whole_plain(
    xb, ub, xr, ur, fd, x0, wlu_lo, wlu_up, wlx_lo, wlx_up, wmu,
    *, h, substeps, mass, gravity, stage_scale, q_diag, r_diag,
    u_lo, u_hi, v_lo, v_hi, with_dist, big,
    diag6_stage, diag6_term, rdiag_stage,
    tau, sigma, mu_init, s_min, mu_min, num_iters, jac_bf16=False,
):
    """The same step as the kernel, without updating anything in place.

    Returns (xb_new, ub_new, lu_lo, lu_up, lx_lo, lx_up, mu, eq_res)."""
    N = xb.shape[0] - 1
    dt = xb.dtype

    def jac(terms):
        # curvature payloads are stored in the jac dtype and read back
        if not jac_bf16:
            return list(terms)
        return [t.to(torch.bfloat16).to(dt) for t in terms]

    hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb = ([] for _ in range(11))
    for k in range(N):
        x = tuple(xb[k, i] for i in range(NX))
        x1 = tuple(xb[k + 1, i] for i in range(NX))
        u = tuple(ub[k, l] for l in range(NU))
        xr_k = tuple(xr[k, i] for i in range(NX))
        ur_k = tuple(ur[k, l] for l in range(NU))
        fd_k = tuple(fd[k, t] for t in range(3)) if with_dist else None
        hq_k, gx_k, gu_k, a40, b30, bc6, r_k = lin_stage_terms(
            x, x1, u, xr_k, ur_k, fd_k,
            h=h, substeps=substeps, mass=mass, gravity=gravity,
            stage_scale=stage_scale, q_diag=q_diag, r_diag=r_diag,
        )
        hq.append(jac(hq_k))
        gx.append(gx_k)
        gu.append(gu_k)
        a.append(jac(a40))
        b.append(jac(b30))
        bc.append(bc6)
        r.append(r_k)
        # u box every stage; v box on interior nodes (0 and N get +-big)
        lub.append([u_lo[l] - u[l] for l in range(NU)])
        uub.append([u_hi[l] - u[l] for l in range(NU)])
        lxb.append([v_lo[t] - x[3 + t] for t in range(3)])
        uxb.append([v_hi[t] - x[3 + t] for t in range(3)])
    hqT, gxT = lin_terminal_terms(
        tuple(xb[N, i] for i in range(NX)), tuple(xr[N, i] for i in range(NX)),
        q_diag=q_diag,
    )
    hq.append(jac(hqT))
    gx.append(gxT)
    bigt = torch.full_like(xb[0, 0], big)
    lxb[0] = [-bigt] * 3
    uxb[0] = [bigt] * 3
    lxb.append([-bigt] * 3)
    uxb.append([bigt] * 3)
    dx0 = [x0[0, i] - xb[0, i] for i in range(NX)]

    qp = StagePayload(hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb, dx0)
    zx, zu, lul, luu, lxl, lxu, mu, eq = ipm_whole(
        qp, wlu_lo, wlu_up, wlx_lo, wlx_up, wmu,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term,
        rdiag_stage=rdiag_stage, tau=tau, sigma=sigma, mu_init=mu_init,
        s_min=s_min, mu_min=mu_min, num_iters=num_iters, xb=xb, ub=ub,
    )

    def stack(rows):
        return torch.stack([torch.stack(row) for row in rows])

    return (
        stack(zx), stack(zu), stack(lul), stack(luu), stack(lxl), stack(lxu),
        mu, eq,
    )
