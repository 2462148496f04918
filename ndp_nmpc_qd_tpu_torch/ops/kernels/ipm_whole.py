"""The whole warm-started interior-point solve: plain PyTorch version.

Port of `ndp_nmpc_qd_tpu/ops/pallas/ipm_whole.py:55-402` (`_slack_init_pair`,
`_load_blocks_at` and the algorithm of `_ipm_whole_kernel`, including the
folded SQP axpy). Per scenario: zero-control dynamics-exact start, slack
initialization at the zero iterate, dual warm mixing with the cold sentinel
(`mu < 0`), then `num_iters` x (backward Riccati sweep, forward pass A:
rollout, step ratios and complementarity partials; pass B: primal, slack and
dual update; barrier update). The final equality residual is
(1 - a_p) * sqrt(res2) of the last iteration.

Everything is a (B,) tensor per element, held in Python lists indexed
[stage][element]; the Pallas kernel keeps the same arrays in VMEM scratch and
the CUDA kernel (`csrc/step_whole.cuh:ipm_whole`) in a global workspace.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linearize import NU, NX, tsum
from .riccati_sparse import (
    bound_steps,
    dyn_step,
    glue_pair,
    load_blocks,
    riccati_stage_core,
    terminal_init_core,
)


class StagePayload(NamedTuple):
    """One QP's stage data, [stage][element] lists of (B,) tensors in the
    compute dtype (curvature entries already rounded to the jac dtype)."""

    hq: list  # N+1 x 16
    gx: list  # N+1 x 10
    gu: list  # N x 4
    a: list  # N x 40
    b: list  # N x 30
    bc: list  # N x 6
    r: list  # N x 10
    lub: list  # N x 4
    uub: list  # N x 4
    lxb: list  # N+1 x 3
    uxb: list  # N+1 x 3
    dx0: list  # 10


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
    for _ in range(num_iters):
        # backward Riccati sweep, stages N-1..0
        sigT, corrT = [], []
        for i in range(3):
            sg, co, *_ = glue_pair(
                zx[N][3 + i], qp.lxb[N][i], qp.uxb[N][i],
                sxl[N][i], sxu[N][i], lxl[N][i], lxu[N][i], mu,
            )
            sigT.append(sg)
            corrT.append(co)
        P, p = terminal_init_core(
            qp.hq[N], qp.gx[N], zx[N], sigT, corrT, diag6_term=diag6_term
        )
        K = [None] * N
        kf = [None] * N
        rh = [None] * N
        r2 = torch.zeros_like(mu)
        for k in reversed(range(N)):
            Hq = [[qp.hq[k][i * 4 + j] for j in range(4)] for i in range(4)]
            sig_u, corr_u = [], []
            for l in range(NU):
                sg, co, *_ = glue_pair(
                    zu[k][l], qp.lub[k][l], qp.uub[k][l],
                    sul[k][l], suu[k][l], lul[k][l], luu[k][l], mu,
                )
                sig_u.append(sg)
                corr_u.append(co)
            sig_x, corr_x = [], []
            for i in range(3):
                sg, co, *_ = glue_pair(
                    zx[k][3 + i], qp.lxb[k][i], qp.uxb[k][i],
                    sxl[k][i], sxu[k][i], lxl[k][i], lxu[k][i], mu,
                )
                sig_x.append(sg)
                corr_x.append(co)
            K[k], kf[k], rh[k], P, p = riccati_stage_core(
                P, p, Hq, qp.gx[k], qp.gu[k], *blocks[k], qp.r[k],
                zx[k], zx[k + 1], zu[k], sig_u, sig_x, corr_u, corr_x,
                h=h, diag6_stage=diag6_stage, rdiag_stage=rdiag_stage,
            )
            r2 = r2 + tsum(rh[k][i] * rh[k][i] for i in range(NX))
        dx0_res = [dx0[i] - zx[0][i] for i in range(NX)]
        r2 = r2 + tsum(v * v for v in dx0_res)

        # pass A: rollout, fraction-to-boundary and complementarity partials
        two = torch.full_like(mu, 2.0)
        zero = torch.zeros_like(mu)
        ap, ad, c1, c2, c3, c4 = two, two, zero, zero, zero, zero
        dxs = [None] * (N + 1)
        dus = [None] * N

        def rows(v, d, lo, hi, s_lo, s_up, l_lo, l_up, acc):
            ap, ad, c1, c2, c3, c4 = acc
            _, _, r_lo, r_up, rc_lo, rc_up = glue_pair(
                v, lo, hi, s_lo, s_up, l_lo, l_up, mu
            )
            ds_lo, ds_up, dl_lo, dl_up, ap_i, ad_i = bound_steps(
                d, r_lo, r_up, rc_lo, rc_up, s_lo, s_up, l_lo, l_up, tau
            )
            return (
                torch.minimum(ap, ap_i),
                torch.minimum(ad, ad_i),
                c1 + s_lo * l_lo + s_up * l_up,
                c2 + ds_lo * l_lo + ds_up * l_up,
                c3 + s_lo * dl_lo + s_up * dl_up,
                c4 + ds_lo * dl_lo + ds_up * dl_up,
            )

        def x_rows(k, dx, acc):
            for i in range(3):
                acc = rows(
                    zx[k][3 + i], dx[3 + i], qp.lxb[k][i], qp.uxb[k][i],
                    sxl[k][i], sxu[k][i], lxl[k][i], lxu[k][i], acc,
                )
            return acc

        acc = (ap, ad, c1, c2, c3, c4)
        dx = dx0_res
        for k in range(N):
            du = [
                tsum(K[k][l][j] * dx[j] for j in range(NX)) + kf[k][l]
                for l in range(NU)
            ]
            dxs[k], dus[k] = dx, du
            for l in range(NU):
                acc = rows(
                    zu[k][l], du[l], qp.lub[k][l], qp.uub[k][l],
                    sul[k][l], suu[k][l], lul[k][l], luu[k][l], acc,
                )
            acc = x_rows(k, dx, acc)
            dx = dyn_step(*blocks[k], rh[k], h, dx, du)
        dxs[N] = dx
        ap, ad, c1, c2, c3, c4 = x_rows(N, dx, acc)
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
