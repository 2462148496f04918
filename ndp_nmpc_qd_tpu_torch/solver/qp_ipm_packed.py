"""Batched box-constrained OCP QP solve in kernel layout, on the dense
Riccati sweep (K8 + K9).

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm_packed.py` (`_matvec`,
`solve_qp_packed`, `ipm_packed`; `pack_qp` lives in `ocp_packed.py`, beside
the layout it makes): the interior-point method of `qp_ipm.solve_qp` with
every scenario's Newton direction from
`ops/kernels/riccati.riccati_sweep_packed` and the per-bound elementwise
updates as tensor ops in the same (stage, element, B) layout. Unlike
`solve_qp` it has no far-regime zero-control fallback (its start is the
clipped-LQR rollout for every scenario) and its barrier diagonal `sig_x` is
the full 10-wide state diagonal, zero off the velocity components: it
mirrors the JAX `ipm_packed`, not the scan path. B is not padded.

Requires Hxu == 0 (true for this OCP).
"""

from __future__ import annotations

import torch

from ..ops.kernels.riccati import riccati_sweep_packed
from ..ops.layout import pack, unpack
from .ocp import BX, QpData
from .ocp_packed import PackedQp, pack_qp
from .qp_ipm import QpSolution, ipm_corr_terms, ipm_max_step, ipm_slack_init


def _matvec(h, z, n, m):
    """y[s, i] = sum_j H[s, i*m + j] z[s, j]: h (S, n*m, B), z (S, m, B)
    -> (S, n, B)."""
    S, _, B = h.shape
    return (h.reshape(S, n, m, B) * z[:, None]).sum(dim=2)


def solve_qp_packed(
    qp: QpData, dx0: torch.Tensor, *, num_iters: int = 12, sigma: float = 0.1,
    tau: float = 0.95, mu_init: float = 1.0, s_min: float = 1e-3, mu_min: float = 1e-12,
) -> QpSolution:
    """Batched solve; qp batch-first (B, ...), dx0 (B, nx). Returns a
    QpSolution with batch-first (B, ...) arrays, mu and eq_res (B,)."""
    nx, nu = qp.gx.shape[2], qp.gu.shape[2]
    zx, zu, mu, eq_res = ipm_packed(
        pack_qp(qp), pack(dx0[:, None, :]), num_iters=num_iters, sigma=sigma, tau=tau,
        mu_init=mu_init, s_min=s_min, mu_min=mu_min,
    )
    return QpSolution(unpack(zx, (nx,)), unpack(zu, (nu,)), mu, eq_res)


def ipm_packed(
    p: PackedQp, dx0_p: torch.Tensor, *, num_iters: int = 12, sigma: float = 0.1,
    tau: float = 0.95, mu_init: float = 1.0, s_min: float = 1e-3, mu_min: float = 1e-12,
):
    """The interior-point loop in kernel layout: 1 + num_iters sweeps (K8 +
    K9 each on CUDA tensors). Returns (zx (N+1,nx,B), zu (N,nu,B), mu (B,),
    eq_res (B,))."""
    Np1, nx, B = p.gx.shape
    N, nu = Np1 - 1, p.gu.shape[1]
    dt, dev = p.gx.dtype, p.gx.device
    sweep = riccati_sweep_packed

    # clipped-LQR start (control box with interior margin)
    margin = 1e-3 * (p.uu - p.lu)
    zx, zu = sweep(
        p.hxx, torch.zeros_like(p.gx), p.huu, torch.zeros_like(p.gu), p.gx, p.gu, p.a, p.b,
        p.r, dx0_p, clip_lo=p.lu + margin, clip_hi=p.uu - margin,
    )
    su_lo, su_up = ipm_slack_init(p.lu, p.uu, zu, s_min)
    sx_lo, sx_up = ipm_slack_init(p.lx, p.ux, zx[:, BX], s_min)
    lu_lo, lu_up = mu_init / su_lo, mu_init / su_up
    lx_lo, lx_up = mu_init / sx_lo, mu_init / sx_up
    mu = torch.full((B,), mu_init, dtype=dt, device=dev)
    n_cons = 2 * N * nu + 2 * (N + 1) * 3
    zeros_x = torch.zeros_like(zx)

    def max_step(v, dv):
        return ipm_max_step(v, dv, tau, dims=(0, 1))

    for _ in range(num_iters):
        vx = zx[:, BX]
        sig_u, corr_u, ru_lo, ru_up, rcu_lo, rcu_up = ipm_corr_terms(
            zu, p.lu, p.uu, su_lo, su_up, lu_lo, lu_up, mu)
        sig_x3, corr_x, rx_lo, rx_up, rcx_lo, rcx_up = ipm_corr_terms(
            vx, p.lx, p.ux, sx_lo, sx_up, lx_lo, lx_up, mu)
        sig_x = torch.cat([zeros_x[:, :3], sig_x3, zeros_x[:, 6:]], dim=1)
        gx_lin = p.gx + _matvec(p.hxx, zx, nx, nx)
        ghat_x = torch.cat([gx_lin[:, :3], gx_lin[:, BX] + corr_x, gx_lin[:, 6:]], dim=1)
        ghat_u = p.gu + _matvec(p.huu, zu, nu, nu) + corr_u
        rhat = _matvec(p.a, zx[:N], nx, nx) + _matvec(p.b, zu, nx, nu) + p.r - zx[1:]
        dx0_res = dx0_p - zx[:1]

        # the Newton direction: the exact equality-constrained solve, which
        # integrates the defects rhat from the initial-stage residual
        d_zx, d_zu = sweep(p.hxx, sig_x, p.huu, sig_u, ghat_x, ghat_u, p.a, p.b, rhat, dx0_res)

        d_vx = d_zx[:, BX]
        dsu_lo, dsu_up = d_zu + ru_lo, -d_zu + ru_up
        dsx_lo, dsx_up = d_vx + rx_lo, -d_vx + rx_up
        dlu_lo = -(rcu_lo + lu_lo * dsu_lo) / su_lo
        dlu_up = -(rcu_up + lu_up * dsu_up) / su_up
        dlx_lo = -(rcx_lo + lx_lo * dsx_lo) / sx_lo
        dlx_up = -(rcx_up + lx_up * dsx_up) / sx_up
        a_p = torch.minimum(
            torch.minimum(max_step(su_lo, dsu_lo), max_step(su_up, dsu_up)),
            torch.minimum(max_step(sx_lo, dsx_lo), max_step(sx_up, dsx_up)),
        )
        a_d = torch.minimum(
            torch.minimum(max_step(lu_lo, dlu_lo), max_step(lu_up, dlu_up)),
            torch.minimum(max_step(lx_lo, dlx_lo), max_step(lx_up, dlx_up)),
        )
        zx, zu = zx + a_p * d_zx, zu + a_p * d_zu
        su_lo, su_up = su_lo + a_p * dsu_lo, su_up + a_p * dsu_up
        sx_lo, sx_up = sx_lo + a_p * dsx_lo, sx_up + a_p * dsx_up
        lu_lo, lu_up = lu_lo + a_d * dlu_lo, lu_up + a_d * dlu_up
        lx_lo, lx_up = lx_lo + a_d * dlx_lo, lx_up + a_d * dlx_up
        comp = (
            (su_lo * lu_lo).sum(dim=(0, 1)) + (su_up * lu_up).sum(dim=(0, 1))
            + (sx_lo * lx_lo).sum(dim=(0, 1)) + (sx_up * lx_up).sum(dim=(0, 1))
        ) / n_cons
        mu = torch.clamp(sigma * comp, min=mu_min)

    eq = _matvec(p.a, zx[:N], nx, nx) + _matvec(p.b, zu, nx, nu) + p.r - zx[1:]
    eq_res = torch.sqrt((eq * eq).sum(dim=(0, 1)) + ((dx0_p - zx[:1]) ** 2).sum(dim=(0, 1)))
    return zx, zu, mu, eq_res
