"""Interior-point QP over the structure-sparse payload.

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm_sparse.py`: the dual warm-start state
(`IpmWarm`), the zero-control rollout and the defect in kernel layout, and
`ipm_sparse` on the whole-IPM kernel (K2) or on one glue-fused iteration
(K4 + K5) per IPM iteration. Everything here outside the kernels is plain
torch, as it is jnp outside the Pallas kernels in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.kernels.ipm_whole import riccati_ipm_whole
from ..ops.kernels.linearize import NU, tsum
from ..ops.kernels.riccati_sparse import riccati_iter_fused
from .ocp_sparse import SparseQp, SparseQpConsts
from .qp_ipm import ipm_slack_init


class IpmWarm(NamedTuple):
    """QP multipliers and barrier weight carried across control ticks
    (kernel layout, batch innermost).

    Slacks are not carried: they are re-derived from the current tick's
    bounds at the zero primal iterate, which is always feasible. `mu < 0` is
    the cold sentinel (fresh reset): that scenario falls back to the classic
    lambda = mu0 / s initialization.
    """

    lu_lo: torch.Tensor  # (N, nu, B)
    lu_up: torch.Tensor
    lx_lo: torch.Tensor  # (N+1, 3, B)
    lx_up: torch.Tensor
    mu: torch.Tensor  # (B,); < 0 => cold


def cold_warm(n_stages: int, B: int, dtype, device) -> IpmWarm:
    """Fresh duals with every scenario marked cold."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return IpmWarm(
        z(n_stages, 4, B), z(n_stages, 4, B),
        z(n_stages + 1, 3, B), z(n_stages + 1, 3, B),
        torch.full((B,), -1.0, dtype=dtype, device=device),
    )


def _a_blocks(p: SparseQp):
    """(apq (N,3,4,B), avq (N,3,4,B), aqq (N,4,4,B)) in the compute dtype."""
    N, _, B = p.a.shape
    a = p.a.to(p.gx.dtype)
    return (a[:, 0:12].reshape(N, 3, 4, B), a[:, 12:24].reshape(N, 3, 4, B),
            a[:, 24:40].reshape(N, 4, 4, B))


def sparse_defect(p: SparseQp, consts: SparseQpConsts, zx, zu):
    """A zx + B zu + r - zx' in kernel layout: zx (N+1, 10, B), zu (N, 4, B)
    -> (N, 10, B)."""
    N, _, B = p.r.shape
    h = consts.h
    apq, avq, aqq = _a_blocks(p)
    b = p.b.to(p.bc.dtype)
    bp = torch.cat([b[:, 0:9].reshape(N, 3, 3, B), p.bc[:, 0:3, None]], dim=2)
    bv = torch.cat([b[:, 9:18].reshape(N, 3, 3, B), p.bc[:, 3:6, None]], dim=2)
    bq = b[:, 18:30].reshape(N, 4, 3, B)
    zq = zx[:N, 6:10]
    zw = zu[:, 0:3]
    out_p = (
        zx[:N, 0:3] + h * zx[:N, 3:6]
        + torch.sum(apq * zq[:, None], dim=2)
        + torch.sum(bp * zu[:, None], dim=2)
    )
    out_v = (
        zx[:N, 3:6]
        + torch.sum(avq * zq[:, None], dim=2)
        + torch.sum(bv * zu[:, None], dim=2)
    )
    out_q = torch.sum(aqq * zq[:, None], dim=2) + torch.sum(bq * zw[:, None], dim=2)
    return torch.cat([out_p, out_v, out_q], dim=1) + p.r - zx[1:]


def sparse_rollout_zero_u(p: SparseQp, consts: SparseQpConsts, dx0_p):
    """Zero-control rollout in kernel layout: zx[0] = dx0, zx[k+1] =
    A_k zx[k] + r_k; dynamics-exact and strictly inside the control box.
    dx0_p (1, 10, B) -> (N+1, 10, B)."""
    h = consts.h
    apq, avq, aqq = _a_blocks(p)
    zs = [dx0_p[0]]
    for k in range(p.r.shape[0]):
        dx = zs[-1]
        zq = dx[6:10]
        out_p = dx[0:3] + h * dx[3:6] + torch.sum(apq[k] * zq[None], dim=1)
        out_v = dx[3:6] + torch.sum(avq[k] * zq[None], dim=1)
        out_q = torch.sum(aqq[k] * zq[None], dim=1)
        zs.append(torch.cat([out_p, out_v, out_q], dim=0) + p.r[k])
    return torch.stack(zs)


def ipm_start(p: SparseQp, consts: SparseQpConsts, dx0_p, warm, *, sigma, mu_init, s_min,
              mu_min):
    """The per-iteration path's start (`lqr_start=False`): the zero-control
    rollout, slacks at that iterate, cold duals mu0/s where warm is None or
    warm.mu < 0 and the carried ones (floored at 1e-12) elsewhere, and the
    barrier weight (mu0 cold, else sigma times the mean complementarity
    clamped to [mu_min, mu0]). Returns (zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, mu) in kernel layout."""
    N, _, B = p.gu.shape
    dt, dev = p.gx.dtype, p.gx.device
    zx = sparse_rollout_zero_u(p, consts, dx0_p)
    zu = torch.zeros((N, NU, B), dtype=dt, device=dev)
    su_lo, su_up = ipm_slack_init(p.lu, p.uu, zu, s_min)
    sx_lo, sx_up = ipm_slack_init(p.lx, p.ux, zx[:, 3:6], s_min)
    slacks = (su_lo, su_up, sx_lo, sx_up)
    if warm is None:
        lam = tuple(mu_init / s for s in slacks)
        mu = torch.full((B,), mu_init, dtype=dt, device=dev)
    else:
        cold = warm.mu < 0
        lam = tuple(
            torch.where(cold, mu_init / s, torch.clamp(l_carried, min=1e-12))
            for l_carried, s in zip(warm[:4], slacks)
        )
        n_cons = 2 * N * NU + 2 * (N + 1) * 3
        comp0 = tsum(torch.sum(s * l, dim=(0, 1)) for s, l in zip(slacks, lam)) / n_cons
        mu = torch.where(
            cold, torch.full_like(warm.mu, mu_init),
            torch.clamp(sigma * comp0, min=mu_min, max=mu_init),
        )
    return (zx, zu) + slacks + lam + (mu,)


def ipm_sparse(
    p: SparseQp,
    consts: SparseQpConsts,
    dx0_p: torch.Tensor,
    *,
    num_iters: int = 12,
    sigma: float = 0.1,
    tau: float = 0.95,
    mu_init: float = 1.0,
    s_min: float = 1e-3,
    mu_min: float = 1e-12,
    warm: IpmWarm | None = None,
    lqr_start: bool = True,
    fuse_glue: bool = True,
    whole_kernel: bool = False,
    xu_bar: tuple | None = None,
    workspace=None,
):
    """The interior-point QP over a SparseQp payload in kernel layout.

    Returns (zx (N+1, 10, B), zu (N, 4, B), mu (B,), eq_res (B,),
    new_warm: IpmWarm), as the JAX version does.

    - `whole_kernel=True`: the whole solve in one K2 launch
      (`riccati_ipm_whole`): zero-control start, `lqr_start` ignored, the
      res2-based residual; warm=None runs every scenario cold. `warm`'s
      tensors update in place and are returned as new_warm; `workspace` is
      the K2 scratch (`ops/kernels/ipm_whole.make_workspace`), allocated per
      call without it.
    - otherwise one `riccati_iter_fused` (K4 + K5) per iteration with the
      axpys in torch, from the zero-control start (`lqr_start=False`).
      warm=None: cold duals and the defect-based residual; with `warm`: the
      carried duals mixed in (cold where warm.mu < 0) and the res2-based
      residual. `warm` is not modified.
    - `xu_bar=(x_bar, u_bar)` (kernel layout): the first two results are
      the updated iterates x_bar + zx, u_bar + zu, written into xu_bar's
      tensors in place.

    `lqr_start=True` and `fuse_glue=False` (the clipped-LQR start sweep and
    the unfused glue, both over `riccati_sweep_sparse`) are not ported yet:
    they raise.
    """
    Np1, _, B = p.gx.shape
    N = Np1 - 1
    dt = p.gx.dtype
    dev = p.gx.device
    kern = dict(h=consts.h, diag6_stage=consts.diag6_stage,
                diag6_term=consts.diag6_term, rdiag_stage=consts.rdiag_stage)

    if whole_kernel:
        if warm is None:
            warm = cold_warm(N, B, dt, dev)
        xb, ub = xu_bar if xu_bar is not None else (None, None)
        zx, zu, *duals, eq = riccati_ipm_whole(
            p.hq, p.gx, p.gu, p.a, p.b, p.bc, p.r, p.lu, p.uu, p.lx, p.ux,
            *warm, dx0_p, xb, ub, workspace=workspace, **kern,
            tau=tau, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
            num_iters=num_iters,
        )
        new_warm = IpmWarm(*duals)
        return zx, zu, new_warm.mu, eq, new_warm

    if lqr_start or not fuse_glue:
        raise NotImplementedError(
            "ipm_sparse: lqr_start=True and fuse_glue=False run the Newton sweep "
            "riccati_sweep_sparse, not ported yet (ROADMAP Queue 2 K6+K7)"
        )
    n_cons = 2 * N * NU + 2 * Np1 * 3
    zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up, mu = ipm_start(
        p, consts, dx0_p, warm, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
    )

    res2 = a_p = None
    for _ in range(num_iters):
        dx0_res = dx0_p - zx[:1]
        (d_zx, d_zu, dsu_lo, dsu_up, dlu_lo, dlu_up, dsx_lo, dsx_up, dlx_lo, dlx_up,
         a_p, a_d, comp4, res2_r) = riccati_iter_fused(
            p.hq, p.gx, p.gu, p.a, p.b, p.bc, p.r, zx, zu,
            su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up,
            p.lu, p.uu, p.lx, p.ux, mu, dx0_res, **kern, tau=tau,
        )
        zx = zx + a_p * d_zx
        zu = zu + a_p * d_zu
        su_lo = su_lo + a_p * dsu_lo
        su_up = su_up + a_p * dsu_up
        sx_lo = sx_lo + a_p * dsx_lo
        sx_up = sx_up + a_p * dsx_up
        lu_lo = lu_lo + a_d * dlu_lo
        lu_up = lu_up + a_d * dlu_up
        lx_lo = lx_lo + a_d * dlx_lo
        lx_up = lx_up + a_d * dlx_up
        comp = (comp4[0] + a_p * comp4[1] + a_d * comp4[2] + a_p * a_d * comp4[3]) / n_cons
        mu = torch.clamp(sigma * comp, min=mu_min)
        res2 = res2_r + torch.sum(dx0_res * dx0_res, dim=(0, 1))

    if warm is None or num_iters == 0:
        eq = sparse_defect(p, consts, zx, zu)
        eq_res = torch.sqrt(
            torch.sum(eq * eq, dim=(0, 1)) + torch.sum((dx0_p - zx[:1]) ** 2, dim=(0, 1))
        )
    else:
        eq_res = (1.0 - a_p) * torch.sqrt(res2)
    new_warm = IpmWarm(lu_lo, lu_up, lx_lo, lx_up, mu)
    if xu_bar is not None:
        zx = xu_bar[0].add_(zx)
        zu = xu_bar[1].add_(zu)
    return zx, zu, mu, eq_res, new_warm
