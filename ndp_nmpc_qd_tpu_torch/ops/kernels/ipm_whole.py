"""The whole warm-started interior-point solve: CUDA kernel wrapper and
plain version.

Port of `ndp_nmpc_qd_tpu/ops/pallas/ipm_whole.py` (`riccati_ipm_whole`,
`_slack_init_pair` and the algorithm of `_ipm_whole_kernel`, including the
folded SQP axpy). Per scenario: zero-control dynamics-exact start, slack
initialization at the zero iterate, dual warm mixing with the cold sentinel
(`mu < 0`), then `num_iters` x (backward Riccati sweep, forward pass A:
rollout, step ratios and complementarity partials; pass B: primal, slack and
dual update; barrier update). The final equality residual is
(1 - a_p) * sqrt(res2) of the last iteration.

- `riccati_ipm_whole` is the entry point. For CUDA tensors it launches the
  hand-written kernel (`csrc/ipm_whole.cu`, built at first use) or raises;
  for CPU tensors it runs `riccati_ipm_whole_plain`. Either way the carried
  duals and mu (and, with xb/ub, the iterates) update IN PLACE, as the TPU
  kernel's aliased outputs do. It counts its launches in
  `riccati_ipm_whole.launches`.
- `ipm_whole` is the algorithm on a `StagePayload`, every element a (B,)
  tensor held in Python lists indexed [stage][element]; the Pallas kernel
  keeps the same arrays in VMEM scratch and the CUDA kernel
  (`csrc/ndp_team.cuh:team_ipm`, a team of lanes a scenario) in shared
  memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .linearize import NU, NX, stack_rows, tsum
from .riccati_sparse import (
    StagePayload,
    backward_sweep,
    dyn_step,
    forward_pass,
    glue_pair,
    glue_rows,
    load_blocks,
)


def slack_init_pair(lo, hi, v, s_min):
    """Slack start of one two-sided bound row (`qp_ipm.ipm_slack_init`)."""
    rng = hi - lo
    floor = torch.minimum(s_min * torch.clamp(rng, max=1e3), 0.5 * rng)
    return (
        torch.maximum(torch.abs(v - lo), floor),
        torch.maximum(torch.abs(hi - v), floor),
    )


def ipm_whole(
    qp: StagePayload, wlu_lo, wlu_up, wlx_lo, wlx_up, wmu,
    *, h, diag6_stage, diag6_term, rdiag_stage,
    tau, sigma, mu_init, s_min, mu_min, num_iters,
    xb=None, ub=None,
):
    """The whole IPM over one stage payload.

    Carried duals wlu_* (N, 4, B), wlx_* (N+1, 3, B) and wmu (B,) (< 0 =
    cold) in kernel layout. With xb (N+1, 10, B) / ub (N, 4, B) the SQP
    axpy is folded and the first two outputs are the updated iterates.
    Returns (zx, zu, lu_lo, lu_up, lx_lo, lx_up) as [stage][element] lists,
    then mu (B,) and eq_res (B,)."""
    N = len(qp.r)
    mu0 = mu_init
    cold = wmu < 0.0
    n_cons = 2 * N * NU + 2 * (N + 1) * 3
    dx0 = qp.dx0

    def mix_lam(carried, s):
        return torch.where(cold, mu0 / s, torch.clamp(carried, min=1e-12))

    blocks = [load_blocks(qp.a[k], qp.b[k], qp.bc[k]) for k in range(N)]
    zx = [None] * (N + 1)
    zu = [None] * N
    sul = [[None] * NU for _ in range(N)]
    suu = [[None] * NU for _ in range(N)]
    sxl = [[None] * 3 for _ in range(N + 1)]
    sxu = [[None] * 3 for _ in range(N + 1)]
    lul = [[None] * NU for _ in range(N)]
    luu = [[None] * NU for _ in range(N)]
    lxl = [[None] * 3 for _ in range(N + 1)]
    lxu = [[None] * 3 for _ in range(N + 1)]

    def init_x_node(k, z, c0):
        for i in range(3):
            s_lo, s_up = slack_init_pair(qp.lxb[k][i], qp.uxb[k][i], z[3 + i], s_min)
            sxl[k][i], sxu[k][i] = s_lo, s_up
            lxl[k][i] = mix_lam(wlx_lo[k, i], s_lo)
            lxu[k][i] = mix_lam(wlx_up[k, i], s_up)
            c0 = c0 + s_lo * lxl[k][i] + s_up * lxu[k][i]
        return c0

    # zero-control dynamics-exact start, slacks at the zero iterate, dual
    # warm mixing, complementarity-derived barrier start
    z = list(dx0)
    zero = torch.zeros_like(z[0])
    c0 = zero
    for k in range(N):
        for l in range(NU):
            s_lo, s_up = slack_init_pair(qp.lub[k][l], qp.uub[k][l], zero, s_min)
            sul[k][l], suu[k][l] = s_lo, s_up
            lul[k][l] = mix_lam(wlu_lo[k, l], s_lo)
            luu[k][l] = mix_lam(wlu_up[k, l], s_up)
            c0 = c0 + s_lo * lul[k][l] + s_up * luu[k][l]
        zu[k] = [zero] * NU
        zx[k] = z
        c0 = init_x_node(k, z, c0)
        z = dyn_step(*blocks[k], qp.r[k], h, z, None)
    zx[N] = z
    c0 = init_x_node(N, z, c0)
    mu = torch.where(
        cold, torch.full_like(wmu, mu0),
        torch.clamp(sigma * c0 / n_cons, min=mu_min, max=mu0),
    )

    res2 = ap = None
    bd = (sul, suu, sxl, sxu, lul, luu, lxl, lxu)
    for _ in range(num_iters):
        K, kf, rh, r2 = backward_sweep(
            qp, blocks, zx, zu, glue_rows(qp, bd, mu),
            h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
        )
        dx0_res = [dx0[i] - zx[0][i] for i in range(NX)]
        r2 = r2 + tsum(v * v for v in dx0_res)

        # pass A: rollout, fraction-to-boundary and complementarity partials
        dxs, dus, _, (ap, ad, c1, c2, c3, c4) = forward_pass(
            qp, blocks, K, kf, rh, zx, zu, bd, mu, dx0_res, h=h, tau=tau
        )
        ap = torch.clamp(ap, max=1.0)
        ad = torch.clamp(ad, max=1.0)

        # pass B: recover the slack/dual directions (same formulas, same
        # inputs as pass A) and apply the step
        def update_row(v, d, lo, hi, s_lo, s_up, l_lo, l_up):
            _, _, r_lo, r_up, rc_lo, rc_up = glue_pair(
                v, lo, hi, s_lo, s_up, l_lo, l_up, mu
            )
            ds_lo = d + r_lo
            ds_up = -d + r_up
            return (
                s_lo + ap * ds_lo,
                s_up + ap * ds_up,
                l_lo + ad * (-(rc_lo + l_lo * ds_lo) / s_lo),
                l_up + ad * (-(rc_up + l_up * ds_up) / s_up),
            )

        def update_x_node(k):
            for i in range(3):
                sxl[k][i], sxu[k][i], lxl[k][i], lxu[k][i] = update_row(
                    zx[k][3 + i], dxs[k][3 + i], qp.lxb[k][i], qp.uxb[k][i],
                    sxl[k][i], sxu[k][i], lxl[k][i], lxu[k][i],
                )
            zx[k] = [zx[k][i] + ap * dxs[k][i] for i in range(NX)]

        for k in range(N):
            for l in range(NU):
                sul[k][l], suu[k][l], lul[k][l], luu[k][l] = update_row(
                    zu[k][l], dus[k][l], qp.lub[k][l], qp.uub[k][l],
                    sul[k][l], suu[k][l], lul[k][l], luu[k][l],
                )
            zu[k] = [zu[k][l] + ap * dus[k][l] for l in range(NU)]
            update_x_node(k)
        update_x_node(N)

        comp = (c1 + ap * c2 + ad * c3 + ap * ad * c4) / n_cons
        mu = torch.clamp(sigma * comp, min=mu_min)
        res2 = r2

    eq = (1.0 - ap) * torch.sqrt(res2)
    if xb is not None:
        zx = [[zx[k][i] + xb[k, i] for i in range(NX)] for k in range(N + 1)]
        zu = [[zu[k][l] + ub[k, l] for l in range(NU)] for k in range(N)]
    return zx, zu, lul, luu, lxl, lxu, mu, eq


def riccati_ipm_whole_plain(
    hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb,
    wlu_lo, wlu_up, wlx_lo, wlx_up, wmu, dx0, xb=None, ub=None,
    *, h, diag6_stage, diag6_term, rdiag_stage,
    tau, sigma, mu_init, s_min, mu_min, num_iters,
):
    """The same function as the kernel, without updating anything in place.

    The payload as `linearize_stage_data` returns it (hq/a/b may be bf16,
    read back to the compute dtype of gx). Returns (zx (N+1,10,B) or the
    updated xb, zu (N,4,B) or the updated ub, lu_lo, lu_up (N,4,B),
    lx_lo, lx_up (N+1,3,B), mu (B,), eq_res (B,))."""
    dt = gx.dtype
    qp = StagePayload(hq.to(dt), gx, gu, a.to(dt), b.to(dt), bc, r, lub, uub, lxb, uxb, dx0[0])
    zx, zu, lul, luu, lxl, lxu, mu, eq = ipm_whole(
        qp, wlu_lo, wlu_up, wlx_lo, wlx_up, wmu,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term,
        rdiag_stage=rdiag_stage, tau=tau, sigma=sigma, mu_init=mu_init,
        s_min=s_min, mu_min=mu_min, num_iters=num_iters, xb=xb, ub=ub,
    )
    return tuple(stack_rows(t) for t in (zx, zu, lul, luu, lxl, lxu)) + (mu, eq)


class _IpmPtrs(ctypes.Structure):
    """Mirror of `ndp::IpmPtrs` (csrc/ipm_whole.cu)."""

    _fields_ = [("q", _cuda.QpPtrs)] + _cuda.pointers((
        "lu_lo", "lu_up", "lx_lo", "lx_up", "mu", "xb", "ub", "zx", "zu", "eq",
    ))


def _lib(lib=None):
    return _cuda.bind("ipm_whole", _IpmPtrs, ("ipm_whole_launch",), "ipm_whole_geometry",
                      lib=lib)


def geometry(B: int, n_stages: int, jac_bf16: bool, lib=None) -> dict:
    """The launch geometry the kernel's library computes (K1's)."""
    return _cuda.c_geometry(_lib(lib).ipm_whole_geometry, B, n_stages, jac_bf16)


def launch_args(
    hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb,
    wlu_lo, wlu_up, wlx_lo, wlx_up, wmu, dx0, xb=None, ub=None, **consts,
):
    """Check the CUDA tensors of one solve and return the arguments of
    `_cuda.launch` after the launcher: (jac_bf16, StepConsts, IpmPtrs, B,
    device), and (zx or xb, zu or ub, eq_res) as the kernel leaves them."""
    fold = xb is not None
    Np1, _, B = gx.shape
    N = Np1 - 1
    dev = gx.device
    jac_bf16 = hq.dtype == torch.bfloat16
    q = _cuda.qp_ptrs(
        dict(hq=hq, gx=gx, gu=gu, a=a, b=b, bc=bc, r=r, lub=lub, uub=uub, lxb=lxb,
             uxb=uxb, dx0=dx0), N, B, jac_bf16, dev,
    )
    zs = (xb, ub) if fold else (
        torch.empty((Np1, NX, B), dtype=torch.float32, device=dev),
        torch.empty((N, NU, B), dtype=torch.float32, device=dev),
    )
    for name, t, shape in (
        ("lu_lo", wlu_lo, (N, NU, B)), ("lu_up", wlu_up, (N, NU, B)),
        ("lx_lo", wlx_lo, (Np1, 3, B)), ("lx_up", wlx_up, (Np1, 3, B)),
        ("mu", wmu, (B,)), ("xb", zs[0], (Np1, NX, B)), ("ub", zs[1], (N, NU, B)),
    ):
        _cuda.check(name, t, shape, dev)
    eq = torch.empty(B, dtype=torch.float32, device=dev)
    ptrs = _IpmPtrs(
        q=q, lu_lo=wlu_lo.data_ptr(), lu_up=wlu_up.data_ptr(),
        lx_lo=wlx_lo.data_ptr(), lx_up=wlx_up.data_ptr(), mu=wmu.data_ptr(),
        xb=_cuda.ptr(xb), ub=_cuda.ptr(ub),
        zx=None if fold else zs[0].data_ptr(), zu=None if fold else zs[1].data_ptr(),
        eq=eq.data_ptr(),
    )
    return (jac_bf16, _cuda.step_consts(N, consts), ptrs, B, dev), zs + (eq,)


def riccati_ipm_whole(
    hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb,
    wlu_lo, wlu_up, wlx_lo, wlx_up, wmu, dx0, xb=None, ub=None, **consts,
):
    """The whole IPM solve in one kernel launch.

    Payload (N+1 or N, d, B) as `linearize_stage_data` returns it; carried
    duals wlu_* (N, 4, B), wlx_* (N+1, 3, B) and wmu (B,) (< 0 = cold),
    which update IN PLACE; dx0 (1, 10, B). With xb (N+1, 10, B) / ub
    (N, 4, B) the SQP axpy is folded into them, in place, and they are the
    first two results; without them the first two results are new tensors
    holding the primal deltas zx, zu. `consts` are the keywords of
    `riccati_ipm_whole_plain`. Returns (zx or xb, zu or ub, wlu_lo, wlu_up,
    wlx_lo, wlx_up, wmu, eq_res (B,)).

    Counts its kernel launches in `riccati_ipm_whole.launches`.
    """
    duals = (wlu_lo, wlu_up, wlx_lo, wlx_up, wmu)
    fold = xb is not None
    if gx.device.type == "cpu":
        outs = riccati_ipm_whole_plain(
            hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb, *duals, dx0, xb, ub, **consts
        )
        for dst, src in zip(duals, outs[2:7]):
            dst.copy_(src)
        if fold:
            xb.copy_(outs[0])
            ub.copy_(outs[1])
        return ((xb, ub) if fold else outs[:2]) + duals + (outs[7],)
    _cuda.need_cuda("riccati_ipm_whole", gx)
    args, (zx, zu, eq) = launch_args(
        hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb, *duals, dx0, xb, ub, **consts)
    _cuda.launch(_lib().ipm_whole_launch, *args)
    riccati_ipm_whole.launches += 1
    return (zx, zu) + duals + (eq,)


riccati_ipm_whole.launches = 0
