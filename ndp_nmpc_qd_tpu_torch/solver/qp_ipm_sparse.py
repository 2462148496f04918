"""Interior-point QP over the structure-sparse payload.

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm_sparse.py`: the dual warm-start state
(`IpmWarm`), the zero-control rollout and the defect in kernel layout, and
`ipm_sparse` on the whole-IPM kernel (K2), or per IPM iteration on one
glue-fused iteration (K4 + K5) or on one Newton sweep (K6 + K7) with the
glue in torch, from the zero-control start or the clipped-LQR start (one
more K6 + K7 sweep). Everything here outside the kernels is plain torch, as
it is jnp outside the Pallas kernels in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.kernels.ipm_whole import riccati_ipm_whole
from ..ops.kernels.linearize import NU, NX, tsum
from ..ops.kernels.riccati_sparse import riccati_iter_fused, riccati_sweep_sparse
from .ocp_sparse import SparseQp, SparseQpConsts
from .qp_ipm import ipm_corr_terms, ipm_max_step, ipm_slack_init


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


def lqr_start_point(p: SparseQp, consts: SparseQpConsts, dx0_p):
    """The clipped-LQR primal start: one Newton sweep at the zero iterate
    with zero barrier terms, its controls clipped into the box with a margin
    of 1e-3 of its range, and the zero-control rollout in the same forward
    pass (K6 + K7 on CUDA tensors). Where a scenario's clipped rollout plans
    velocities outside their box (the far regime) that scenario starts from
    the zero-control rollout instead: dynamics-exact and strictly inside the
    control box. Returns (zx (N+1, 10, B), zu (N, 4, B), v_feasible (B,))."""
    Np1, _, B = p.gx.shape
    N = Np1 - 1
    z = lambda *s: torch.zeros(s, dtype=p.gx.dtype, device=p.gx.device)
    zeros_su, zeros_s3 = z(N, NU, B), z(Np1, 3, B)
    margin = 1e-3 * (p.uu - p.lu)
    zx, zu, _, zx_hold = riccati_sweep_sparse(
        p.hq, p.gx, p.gu, p.a, p.b, p.bc, p.r,
        z(Np1, NX, B), zeros_su, zeros_su, zeros_s3, zeros_su, zeros_s3, dx0_p,
        p.lu + margin, p.uu - margin,
        h=consts.h, diag6_stage=consts.diag6_stage, diag6_term=consts.diag6_term,
        rdiag_stage=consts.rdiag_stage, with_hold=True,
    )
    v = zx[:, 3:6]
    v_feasible = ((v >= p.lx) & (v <= p.ux)).all(dim=1).all(dim=0)
    zx = torch.where(v_feasible, zx, zx_hold)
    zu = torch.where(v_feasible, zu, torch.zeros_like(zu))
    return zx, zu, v_feasible


def ipm_start(p: SparseQp, consts: SparseQpConsts, dx0_p, warm, *, sigma, mu_init, s_min,
              mu_min, lqr_start=False):
    """The per-iteration path's start: the zero-control rollout
    (`lqr_start=False`) or the clipped-LQR start (`lqr_start_point`), slacks
    at that iterate, cold duals mu0/s where warm is None or warm.mu < 0 and
    the carried ones (floored at 1e-12) elsewhere, and the barrier weight
    (mu0 cold, else sigma times the mean complementarity clamped to
    [mu_min, mu0]). Returns (zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo,
    lu_up, lx_lo, lx_up, mu) in kernel layout."""
    N, _, B = p.gu.shape
    dt, dev = p.gx.dtype, p.gx.device
    if lqr_start:
        zx, zu, _ = lqr_start_point(p, consts, dx0_p)
    else:
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


def _fused_iteration(p, kern, tau, dx0_res, state):
    """One IPM iteration on the glue-fused kernels (K4 + K5): the slack
    elimination, direction recovery, step ratios and complementarity
    partials ride the launches. Returns (directions in the order of
    `state[:10]`, a_p, a_d, comp4, the sum of rhat^2 over the stages)."""
    zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up, mu = state
    (d_zx, d_zu, dsu_lo, dsu_up, dlu_lo, dlu_up, dsx_lo, dsx_up, dlx_lo, dlx_up,
     a_p, a_d, comp4, res2_r) = riccati_iter_fused(
        p.hq, p.gx, p.gu, p.a, p.b, p.bc, p.r, zx, zu,
        su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up,
        p.lu, p.uu, p.lx, p.ux, mu, dx0_res, **kern, tau=tau,
    )
    dirs = (d_zx, d_zu, dsu_lo, dsu_up, dsx_lo, dsx_up, dlu_lo, dlu_up, dlx_lo, dlx_up)
    return dirs, a_p, a_d, comp4, res2_r


def _unfused_iteration(p, kern, tau, dx0_res, state):
    """One IPM iteration with the glue in torch around one Newton sweep
    (K6 + K7), as the JAX `ipm_sparse(fuse_glue=False)`: `ipm_corr_terms`
    on both bounds, the sweep, the slack/dual direction recovery and the
    fraction-to-boundary reductions. Returns what `_fused_iteration` does,
    with comp4 None (the caller sums the updated complementarity)."""
    zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up, mu = state
    sig_u, corr_u, ru_lo, ru_up, rcu_lo, rcu_up = ipm_corr_terms(
        zu, p.lu, p.uu, su_lo, su_up, lu_lo, lu_up, mu)
    sig_x, corr_x, rx_lo, rx_up, rcx_lo, rcx_up = ipm_corr_terms(
        zx[:, 3:6], p.lx, p.ux, sx_lo, sx_up, lx_lo, lx_up, mu)
    d_zx, d_zu, rhat = riccati_sweep_sparse(
        p.hq, p.gx, p.gu, p.a, p.b, p.bc, p.r, zx, zu, sig_u, sig_x, corr_u, corr_x,
        dx0_res, **kern,
    )
    d_vx = d_zx[:, 3:6]
    dsu_lo = d_zu + ru_lo
    dsu_up = -d_zu + ru_up
    dsx_lo = d_vx + rx_lo
    dsx_up = -d_vx + rx_up
    dlu_lo = -(rcu_lo + lu_lo * dsu_lo) / su_lo
    dlu_up = -(rcu_up + lu_up * dsu_up) / su_up
    dlx_lo = -(rcx_lo + lx_lo * dsx_lo) / sx_lo
    dlx_up = -(rcx_up + lx_up * dsx_up) / sx_up
    step = lambda v, dv: ipm_max_step(v, dv, tau, dims=(0, 1))
    a_p = torch.minimum(torch.minimum(step(su_lo, dsu_lo), step(su_up, dsu_up)),
                        torch.minimum(step(sx_lo, dsx_lo), step(sx_up, dsx_up)))
    a_d = torch.minimum(torch.minimum(step(lu_lo, dlu_lo), step(lu_up, dlu_up)),
                        torch.minimum(step(lx_lo, dlx_lo), step(lx_up, dlx_up)))
    dirs = (d_zx, d_zu, dsu_lo, dsu_up, dsx_lo, dsx_up, dlu_lo, dlu_up, dlx_lo, dlx_up)
    return dirs, a_p, a_d, None, torch.sum(rhat * rhat, dim=(0, 1))


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
):
    """The interior-point QP over a SparseQp payload in kernel layout.

    Returns (zx (N+1, 10, B), zu (N, 4, B), mu (B,), eq_res (B,),
    new_warm: IpmWarm), as the JAX version does.

    - `whole_kernel=True`: the whole solve in one K2 launch
      (`riccati_ipm_whole`): zero-control start, `lqr_start` ignored, the
      res2-based residual; warm=None runs every scenario cold. `warm`'s
      tensors update in place and are returned as new_warm.
    - otherwise, per iteration, one `riccati_iter_fused` (K4 + K5,
      `fuse_glue=True`) or one `riccati_sweep_sparse` (K6 + K7) with the
      glue in torch (`fuse_glue=False`), and the axpys in torch; from the
      clipped-LQR start (`lqr_start=True`: one more K6 + K7 sweep, see
      `lqr_start_point`) or from the zero-control rollout. warm=None: cold
      duals and the defect-based residual; with `warm`: the carried duals
      mixed in (cold where warm.mu < 0) and the res2-based residual. `warm`
      is not modified.
    - `xu_bar=(x_bar, u_bar)` (kernel layout): the first two results are
      the updated iterates x_bar + zx, u_bar + zu, written into xu_bar's
      tensors in place.
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
            *warm, dx0_p, xb, ub, **kern,
            tau=tau, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
            num_iters=num_iters,
        )
        new_warm = IpmWarm(*duals)
        return zx, zu, new_warm.mu, eq, new_warm

    n_cons = 2 * N * NU + 2 * Np1 * 3
    state = ipm_start(
        p, consts, dx0_p, warm, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
        lqr_start=lqr_start,
    )
    iteration = _fused_iteration if fuse_glue else _unfused_iteration

    res2 = a_p = None
    for _ in range(num_iters):
        dx0_res = dx0_p - state[0][:1]
        dirs, a_p, a_d, comp4, res2_r = iteration(p, kern, tau, dx0_res, state)
        steps = (a_p,) * 6 + (a_d,) * 4
        state = tuple(v + a * d for v, a, d in zip(state[:10], steps, dirs))
        zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up = state
        if comp4 is None:
            comp = (
                torch.sum(su_lo * lu_lo, dim=(0, 1)) + torch.sum(su_up * lu_up, dim=(0, 1))
                + torch.sum(sx_lo * lx_lo, dim=(0, 1)) + torch.sum(sx_up * lx_up, dim=(0, 1))
            ) / n_cons
        else:
            comp = (comp4[0] + a_p * comp4[1] + a_d * comp4[2] + a_p * a_d * comp4[3]) / n_cons
        state += (torch.clamp(sigma * comp, min=mu_min),)
        res2 = res2_r + torch.sum(dx0_res * dx0_res, dim=(0, 1))
    zx, zu, _, _, _, _, lu_lo, lu_up, lx_lo, lx_up, mu = state

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
