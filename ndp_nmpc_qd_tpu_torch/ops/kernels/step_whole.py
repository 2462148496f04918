"""The fused control step: CUDA kernel wrapper, plain version, launch count.

Port of `ndp_nmpc_qd_tpu/ops/pallas/step_whole.py:control_step_whole`. One
step linearizes all N stages at the current RTI iterates, runs the whole
warm-started interior-point QP and folds the SQP axpy, per scenario.

- `control_step_whole` is the entry point. For CUDA tensors it launches the
  hand-written kernel (`csrc/step_whole.cu`, built at first use: a team of
  lanes a scenario, the scenario's payload and IPM scratch in shared memory,
  no workspace) or raises;
  for CPU tensors it runs `control_step_whole_plain`. Either way the
  iterates and carried duals update IN PLACE, as the TPU kernel's aliased
  outputs do, and it returns the equality residual.
- `control_step_whole_plain` computes the same function with batched tensor
  algebra: the plain versions of the two-kernel path's K3 and K2 (Python
  loops over stages and iterations, ops on (B,) tensors). It works in f32
  and f64.

All tensors are in the port's kernel layout (stage, element, B).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .ipm_whole import riccati_ipm_whole_plain
from .linearize import NU, NX, linearize_stage_data_plain


class _StepPtrs(ctypes.Structure):
    """Mirror of `ndp::StepPtrs` (csrc/step_whole.cu)."""

    _fields_ = _cuda.pointers((
        "xb", "ub", "xr", "ur", "fd", "x0", "lu_lo", "lu_up", "lx_lo", "lx_up", "mu", "eq",
    ))


def _lib(lib=None):
    return _cuda.bind("step_whole", _StepPtrs, ("step_whole_launch",), "step_whole_geometry",
                      lib=lib)


def geometry(B: int, n_stages: int, jac_bf16: bool, lib=None) -> dict:
    """The launch geometry the kernel's library computes (a team of lanes a
    scenario, scenarios a block, shared memory a block): held against
    `_cuda.team_geometry` on the card."""
    return _cuda.c_geometry(_lib(lib).step_whole_geometry, B, n_stages, jac_bf16)


def launch_args(xb, ub, xr, ur, fd, x0, lu_lo, lu_up, lx_lo, lx_up, mu, **consts):
    """Check the CUDA tensors of one step and return the arguments of
    `_cuda.launch` after the launcher: (jac_bf16, StepConsts, StepPtrs, B,
    device), and the eq_res tensor the kernel writes."""
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
        _cuda.check(name, t, shape, dev)
    eq = torch.empty(B, dtype=torch.float32, device=dev)
    ptrs = _StepPtrs(
        xb=xb.data_ptr(), ub=ub.data_ptr(), xr=xr.data_ptr(),
        ur=ur.data_ptr(), fd=fd.data_ptr() if with_dist else None,
        x0=x0.data_ptr(), lu_lo=lu_lo.data_ptr(), lu_up=lu_up.data_ptr(),
        lx_lo=lx_lo.data_ptr(), lx_up=lx_up.data_ptr(), mu=mu.data_ptr(),
        eq=eq.data_ptr(),
    )
    jac_bf16 = bool(consts.get("jac_bf16", False))
    return (jac_bf16, _cuda.step_consts(N, consts), ptrs, B, dev), eq


def control_step_whole(xb, ub, xr, ur, fd, x0, lu_lo, lu_up, lx_lo, lx_up, mu, **consts):
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
    _cuda.need_cuda("control_step_whole", xb)
    args, eq = launch_args(xb, ub, xr, ur, fd, x0, lu_lo, lu_up, lx_lo, lx_up, mu, **consts)
    _cuda.launch(_lib().step_whole_launch, *args)
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
    """The same step as the kernel, without updating anything in place:
    `linearize_stage_data_plain`, then `riccati_ipm_whole_plain` with the
    axpy folded.

    Returns (xb_new, ub_new, lu_lo, lu_up, lx_lo, lx_up, mu, eq_res)."""
    *qp, dx0 = linearize_stage_data_plain(
        xb, ub, xr, ur, fd, x0,
        h=h, substeps=substeps, mass=mass, gravity=gravity,
        stage_scale=stage_scale, q_diag=q_diag, r_diag=r_diag,
        u_lo=u_lo, u_hi=u_hi, v_lo=v_lo, v_hi=v_hi, with_dist=with_dist,
        big=big, jac_bf16=jac_bf16,
    )
    return riccati_ipm_whole_plain(
        *qp, wlu_lo, wlu_up, wlx_lo, wlx_up, wmu, dx0, xb, ub,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term,
        rdiag_stage=rdiag_stage, tau=tau, sigma=sigma, mu_init=mu_init,
        s_min=s_min, mu_min=mu_min, num_iters=num_iters,
    )
