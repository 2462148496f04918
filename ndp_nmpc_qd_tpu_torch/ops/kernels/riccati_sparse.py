"""Structure-sparse Riccati sweeps: CUDA kernel wrappers and plain versions.

Port of `ndp_nmpc_qd_tpu/ops/pallas/riccati_sparse.py` (`riccati_iter_fused`,
`riccati_sweep_sparse` and their per-stage helpers `_bt_dot`, `_glue_pair`,
`_terminal_init_core`, `_riccati_stage_core`, `_dyn_step`, `_ratio`,
`_bound_steps`). The 4x4 Cholesky helpers (`chol4`, `chol4_solve`) come
from `riccati.py`, as the JAX module takes `riccati._chol4`.

- `riccati_iter_fused` is one glue-fused IPM iteration in two launches:
  `riccati_backward_glue` (K4, the TPU's `_backward_kernel_glue`) and
  `riccati_forward_glue` (K5, `_forward_kernel_glue`), CUDA in
  `csrc/riccati_iter.cu`.
- `riccati_sweep_sparse` is one Newton sweep with the box rows' terms given
  (the clipped-LQR start and the unfused glue of the IPM) in two launches:
  `riccati_sweep_backward` (K6, `_backward_kernel`) and
  `riccati_sweep_forward` (K7, `_forward_kernel`: optional clip and
  zero-control hold rollout), CUDA in `csrc/riccati_sweep.cu`.
- For CUDA tensors each wrapper launches its hand-written kernel (built at
  first use) or raises, and counts its launches in `.launches`; for CPU
  tensors each runs its plain version.
- The helpers take (B,) tensors or nested lists (or tensors) of them, one
  per matrix element, as the Pallas helpers take one (SUB, 128) tile per
  element; the CUDA device functions of the same names (`csrc/ndp.cuh`) do
  the same arithmetic for one scenario per thread.

The stage structure (see `solver/ocp_sparse.py` of the JAX package):
A = [[I, h I, Apq], [0, I, Avq], [0, 0, Aqq]], B has no quaternion <-
collective column, Hxx = diag6 (+) Hq and Huu is a constant diagonal.

The Pallas versions write the new cost-to-go into VMEM scratch; these return
it instead.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from .linearize import NU, NX, stack_rows, tsum
from .riccati import chol4, chol4_solve


class StagePayload(NamedTuple):
    """One QP's stage data indexed [stage][element] -> (B,) tensor: nested
    lists, or (stage, element, B) tensors, in the compute dtype (curvature
    entries already rounded to the jac dtype and read back)."""

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


def load_blocks(a40, b30, bc6):
    """Unpack one stage's sparse A/B payload into its blocks."""
    apq = [[a40[i * 4 + j] for j in range(4)] for i in range(3)]
    avq = [[a40[12 + i * 4 + j] for j in range(4)] for i in range(3)]
    aqq = [[a40[24 + i * 4 + j] for j in range(4)] for i in range(4)]
    bp = [[b30[i * 3 + l] for l in range(3)] + [bc6[i]] for i in range(3)]
    bv = [[b30[9 + i * 3 + l] for l in range(3)] + [bc6[3 + i]] for i in range(3)]
    bq = [[b30[18 + i * 3 + l] for l in range(3)] for i in range(4)]
    return apq, avq, aqq, bp, bv, bq


def bt_dot(bp, bv, bq, vec, l):
    """(B^T vec)[l] for a 10-vector; bq lacks the collective column."""
    s = tsum(bp[t][l] * vec[t] for t in range(3))
    s = s + tsum(bv[t][l] * vec[3 + t] for t in range(3))
    if l < 3:
        s = s + tsum(bq[t][l] * vec[6 + t] for t in range(4))
    return s


def glue_pair(v, lo, hi, s_lo, s_up, l_lo, l_up, mu):
    """Slack elimination of one two-sided bound row.

    Returns (sig, corr, r_lo, r_up, rc_lo, rc_up)."""
    r_lo = v - lo - s_lo
    r_up = hi - v - s_up
    rc_lo = s_lo * l_lo - mu
    rc_up = s_up * l_up - mu
    rs_lo = 1.0 / s_lo
    rs_up = 1.0 / s_up
    sig = l_lo * rs_lo + l_up * rs_up
    corr = (
        -l_lo + l_up
        + (rc_lo + l_lo * r_lo) * rs_lo
        - (rc_up + l_up * r_up) * rs_up
    )
    return sig, corr, r_lo, r_up, rc_lo, rc_up


def terminal_init_core(hqT, gxT, zxT, sigT, corrT, *, diag6_term):
    """Terminal Riccati init: P = diag6_term (+) HqT + diag(sigT on v),
    p = ghat_N. Returns (P as 10x10 lists, p as a 10-list)."""
    zero = torch.zeros_like(zxT[0])
    P = [[zero for _ in range(NX)] for _ in range(NX)]
    p = [None] * NX
    for i in range(6):
        P[i][i] = diag6_term[i] + zero
        p[i] = gxT[i] + diag6_term[i] * zxT[i]
    for i in range(3):
        P[3 + i][3 + i] = P[3 + i][3 + i] + sigT[i]
        p[3 + i] = p[3 + i] + corrT[i]
    for i in range(4):
        for j in range(4):
            P[6 + i][6 + j] = hqT[i * 4 + j].to(zxT[0].dtype)
        p[6 + i] = gxT[6 + i] + tsum(hqT[i * 4 + j] * zxT[6 + j] for j in range(4))
    return P, p


def riccati_stage_core(
    P, p, Hq, gx, gu, apq, avq, aqq, bp, bv, bq, r,
    zx, zx1, zu, sig_u, sig_x, corr_u, corr_x,
    *, h, diag6_stage, rdiag_stage,
):
    """One backward Riccati stage: fused ghat/rhat assembly, structured
    products, Cholesky gain solve and the cost-to-go update.

    Returns (K 4x10, kf 4, rh 10, P_new 10x10, p_new 10)."""
    zq = zx[6:10]

    ghx = [gx[i] + diag6_stage[i] * zx[i] for i in range(6)]
    for i in range(3):
        ghx[3 + i] = ghx[3 + i] + corr_x[i]
    ghx = ghx + [
        gx[6 + i] + tsum(Hq[i][j] * zq[j] for j in range(4)) for i in range(4)
    ]
    ghu = [gu[l] + rdiag_stage[l] * zu[l] + corr_u[l] for l in range(NU)]

    rh = [None] * NX
    for i in range(3):
        rh[i] = (
            zx[i] + h * zx[3 + i]
            + tsum(apq[i][j] * zq[j] for j in range(4))
            + tsum(bp[i][l] * zu[l] for l in range(4))
            + r[i] - zx1[i]
        )
        rh[3 + i] = (
            zx[3 + i]
            + tsum(avq[i][j] * zq[j] for j in range(4))
            + tsum(bv[i][l] * zu[l] for l in range(4))
            + r[3 + i] - zx1[3 + i]
        )
    for i in range(4):
        rh[6 + i] = (
            tsum(aqq[i][j] * zq[j] for j in range(4))
            + tsum(bq[i][l] * zu[l] for l in range(3))
            + r[6 + i] - zx1[6 + i]
        )

    Prp = [tsum(P[i][j] * rh[j] for j in range(NX)) + p[i] for i in range(NX)]

    # PA columns: p-cols copy, v-cols h-shift, q-cols one 10x4 contraction
    PA = [[None] * NX for _ in range(NX)]
    for i in range(NX):
        for j in range(3):
            PA[i][j] = P[i][j]
            PA[i][3 + j] = h * P[i][j] + P[i][3 + j]
        for j in range(4):
            PA[i][6 + j] = (
                tsum(P[i][t] * apq[t][j] for t in range(3))
                + tsum(P[i][3 + t] * avq[t][j] for t in range(3))
                + tsum(P[i][6 + t] * aqq[t][j] for t in range(4))
            )
    PB = [[None] * NU for _ in range(NX)]
    for i in range(NX):
        for l in range(NU):
            s = tsum(P[i][t] * bp[t][l] for t in range(3)) + tsum(
                P[i][3 + t] * bv[t][l] for t in range(3)
            )
            if l < 3:
                s = s + tsum(P[i][6 + t] * bq[t][l] for t in range(4))
            PB[i][l] = s

    # Qh = Hxx + diag(sig) + A^T P A: q-rows on/above the diagonal only,
    # mirrored below (A^T P A is symmetric because P is kept symmetric)
    Qh = [[None] * NX for _ in range(NX)]
    for j in range(NX):
        for i in range(3):
            Qh[i][j] = PA[i][j]
            Qh[3 + i][j] = h * PA[i][j] + PA[3 + i][j]
    for i in range(4):
        for j in range(6 + i):
            Qh[6 + i][j] = Qh[j][6 + i]
        for j in range(6 + i, NX):
            Qh[6 + i][j] = (
                tsum(apq[t][i] * PA[t][j] for t in range(3))
                + tsum(avq[t][i] * PA[3 + t][j] for t in range(3))
                + tsum(aqq[t][i] * PA[6 + t][j] for t in range(4))
            )
    for i in range(6):
        Qh[i][i] = Qh[i][i] + diag6_stage[i]
    for i in range(3):
        Qh[3 + i][3 + i] = Qh[3 + i][3 + i] + sig_x[i]
    for i in range(4):
        for j in range(4):
            Qh[6 + i][6 + j] = Qh[6 + i][6 + j] + Hq[i][j]

    # S = B^T PA (4x10); Rh = diag + sig_u + B^T PB (upper, mirrored)
    S = [
        [bt_dot(bp, bv, bq, [PA[t][j] for t in range(NX)], l) for j in range(NX)]
        for l in range(NU)
    ]
    Rh = [[None] * NU for _ in range(NU)]
    for l in range(NU):
        for m in range(l, NU):
            Rh[l][m] = bt_dot(bp, bv, bq, [PB[t][m] for t in range(NX)], l)
            if m > l:
                Rh[m][l] = Rh[l][m]
    for l in range(NU):
        Rh[l][l] = Rh[l][l] + (rdiag_stage[l] + sig_u[l])

    qv = [None] * NX
    for i in range(3):
        qv[i] = ghx[i] + Prp[i]
        qv[3 + i] = ghx[3 + i] + h * Prp[i] + Prp[3 + i]
    for i in range(4):
        qv[6 + i] = ghx[6 + i] + (
            tsum(apq[t][i] * Prp[t] for t in range(3))
            + tsum(avq[t][i] * Prp[3 + t] for t in range(3))
            + tsum(aqq[t][i] * Prp[6 + t] for t in range(4))
        )
    rv = [ghu[l] + bt_dot(bp, bv, bq, Prp, l) for l in range(NU)]

    L = chol4(Rh)
    cols = [[S[l][k] for l in range(NU)] for k in range(NX)] + [rv]
    sols = chol4_solve(L, cols)
    K = [[-sols[k][l] for k in range(NX)] for l in range(NU)]
    kf = [-sols[NX][l] for l in range(NU)]

    # P_new = Qh + S^T K, upper triangle computed and mirrored
    Pn = [[None] * NX for _ in range(NX)]
    for i in range(NX):
        for j in range(i, NX):
            Pn[i][j] = Qh[i][j] + tsum(S[l][i] * K[l][j] for l in range(NU))
            Pn[j][i] = Pn[i][j]
    pn = [qv[i] + tsum(S[l][i] * kf[l] for l in range(NU)) for i in range(NX)]
    return K, kf, rh, Pn, pn


def dyn_step(apq, avq, aqq, bp, bv, bq, rh, h, dxv, duv):
    """dx_{k+1} = A dx_k + B du_k + rh in the sparse block structure
    (duv=None: zero-control rollout)."""
    dq = dxv[6:10]
    nxt = [None] * NX
    for i in range(3):
        nxt[i] = dxv[i] + h * dxv[3 + i] + tsum(apq[i][j] * dq[j] for j in range(4))
        nxt[3 + i] = dxv[3 + i] + tsum(avq[i][j] * dq[j] for j in range(4))
        if duv is not None:
            nxt[i] = nxt[i] + tsum(bp[i][l] * duv[l] for l in range(4))
            nxt[3 + i] = nxt[3 + i] + tsum(bv[i][l] * duv[l] for l in range(4))
        nxt[i] = nxt[i] + rh[i]
        nxt[3 + i] = nxt[3 + i] + rh[3 + i]
    for i in range(4):
        nxt[6 + i] = tsum(aqq[i][j] * dq[j] for j in range(4))
        if duv is not None:
            nxt[6 + i] = nxt[6 + i] + tsum(bq[i][l] * duv[l] for l in range(3))
        nxt[6 + i] = nxt[6 + i] + rh[6 + i]
    return nxt


def ratio(v, dv, tau):
    """Fraction-to-boundary ratio: largest a with v + a dv >= (1-tau) v;
    2.0 where dv >= 0 (callers clamp at 1.0)."""
    neg = dv < 0
    return torch.where(
        neg, -tau * v / torch.where(neg, dv, torch.full_like(dv, -1.0)),
        torch.full_like(dv, 2.0),
    )


def bound_steps(d, r_lo, r_up, rc_lo, rc_up, s_lo, s_up, l_lo, l_up, tau):
    """Slack/dual direction recovery for one bound row and its step ratios.
    Returns (ds_lo, ds_up, dl_lo, dl_up, ap, ad)."""
    ds_lo = d + r_lo
    ds_up = -d + r_up
    dl_lo = -(rc_lo + l_lo * ds_lo) / s_lo
    dl_up = -(rc_up + l_up * ds_up) / s_up
    ap = torch.minimum(ratio(s_lo, ds_lo, tau), ratio(s_up, ds_up, tau))
    ad = torch.minimum(ratio(l_lo, dl_lo, tau), ratio(l_up, dl_up, tau))
    return ds_lo, ds_up, dl_lo, dl_up, ap, ad


# ---- one IPM iteration: the sweeps over all stages ----


def glue_rows(qp: StagePayload, bd, mu):
    """The box rows' (sig, corr) by the slack elimination (`glue_pair`) of
    the slacks and duals bd = (su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up,
    lx_lo, lx_up) at barrier weight mu, as `_backward_kernel_glue` forms
    them: (u_rows(k, zu_k), x_rows(k, zx_k)), each returning (sig, corr)
    lists."""
    sul, suu, sxl, sxu, lul, luu, lxl, lxu = bd

    def u_rows(k, zu):
        terms = [glue_pair(zu[l], qp.lub[k][l], qp.uub[k][l], sul[k][l], suu[k][l],
                           lul[k][l], luu[k][l], mu)[:2] for l in range(NU)]
        return [t[0] for t in terms], [t[1] for t in terms]

    def x_rows(k, zx):
        terms = [glue_pair(zx[3 + i], qp.lxb[k][i], qp.uxb[k][i], sxl[k][i], sxu[k][i],
                           lxl[k][i], lxu[k][i], mu)[:2] for i in range(3)]
        return [t[0] for t in terms], [t[1] for t in terms]

    return u_rows, x_rows


def given_rows(sig_u, sig_x, corr_u, corr_x):
    """The box rows' (sig, corr) given as (N, 4, B) / (N+1, 3, B) tensors
    (`_backward_kernel`): the same (u_rows, x_rows) pair as `glue_rows`."""
    return (lambda k, zu: (sig_u[k], corr_u[k])), (lambda k, zx: (sig_x[k], corr_x[k]))


def backward_sweep(
    qp: StagePayload, blocks, zx, zu, rows,
    *, h, diag6_stage, diag6_term, rdiag_stage,
):
    """Backward Riccati sweep at the iterate (zx, zu), stages N-1..0, with
    the box rows' terms from rows = (u_rows, x_rows) (`glue_rows` or
    `given_rows`); blocks[k] = `load_blocks` of stage k. Returns
    (K [k][l][j], kf [k][l], rh [k][i], r2), r2 the sum of rh^2 over the
    stages in loop order."""
    u_rows, x_rows = rows
    N = len(blocks)
    sigT, corrT = x_rows(N, zx[N])
    P, p = terminal_init_core(qp.hq[N], qp.gx[N], zx[N], sigT, corrT, diag6_term=diag6_term)
    K = [None] * N
    kf = [None] * N
    rh = [None] * N
    r2 = None
    for k in reversed(range(N)):
        Hq = [[qp.hq[k][i * 4 + j] for j in range(4)] for i in range(4)]
        sig_u, corr_u = u_rows(k, zu[k])
        sig_x, corr_x = x_rows(k, zx[k])
        K[k], kf[k], rh[k], P, p = riccati_stage_core(
            P, p, Hq, qp.gx[k], qp.gu[k], *blocks[k], qp.r[k],
            zx[k], zx[k + 1], zu[k], sig_u, sig_x, corr_u, corr_x,
            h=h, diag6_stage=diag6_stage, rdiag_stage=rdiag_stage,
        )
        sq = tsum(rh[k][i] * rh[k][i] for i in range(NX))
        r2 = sq if r2 is None else r2 + sq
    return K, kf, rh, r2


def forward_pass(qp: StagePayload, blocks, K, kf, rh, zx, zu, bd, mu, dx, *, h, tau):
    """Forward rollout from dx (the dx0 residual) with the gains of
    `backward_sweep`, plus the direction recovery, fraction-to-boundary
    ratios and complementarity partials of every box row
    (`_forward_kernel_glue`).

    Returns (dx [N+1][10], du [N][4], dirs, acc): dirs = (dsu_lo, dsu_up,
    dlu_lo, dlu_up [N][4], dsx_lo, dsx_up, dlx_lo, dlx_up [N+1][3]) and
    acc = (ap, ad, c1, c2, c3, c4) summed over all rows in loop order, ap/ad
    with the 2.0 sentinel and not yet clamped at 1."""
    sul, suu, sxl, sxu, lul, luu, lxl, lxu = bd
    N = len(blocks)
    two = torch.full_like(mu, 2.0)
    zero = torch.zeros_like(mu)
    acc = [two, two, zero, zero, zero, zero]
    u_dirs = [[[None] * NU for _ in range(N)] for _ in range(4)]
    x_dirs = [[[None] * 3 for _ in range(N + 1)] for _ in range(4)]

    def row(v, d, lo, hi, s_lo, s_up, l_lo, l_up):
        _, _, r_lo, r_up, rc_lo, rc_up = glue_pair(v, lo, hi, s_lo, s_up, l_lo, l_up, mu)
        ds_lo, ds_up, dl_lo, dl_up, ap_i, ad_i = bound_steps(
            d, r_lo, r_up, rc_lo, rc_up, s_lo, s_up, l_lo, l_up, tau
        )
        ap, ad, c1, c2, c3, c4 = acc
        acc[:] = (
            torch.minimum(ap, ap_i),
            torch.minimum(ad, ad_i),
            c1 + s_lo * l_lo + s_up * l_up,
            c2 + ds_lo * l_lo + ds_up * l_up,
            c3 + s_lo * dl_lo + s_up * dl_up,
            c4 + ds_lo * dl_lo + ds_up * dl_up,
        )
        return ds_lo, ds_up, dl_lo, dl_up

    def x_rows(k, dx):
        for i in range(3):
            st = row(
                zx[k][3 + i], dx[3 + i], qp.lxb[k][i], qp.uxb[k][i],
                sxl[k][i], sxu[k][i], lxl[k][i], lxu[k][i],
            )
            for out, v in zip(x_dirs, st):
                out[k][i] = v

    dxs = [None] * (N + 1)
    dus = [None] * N
    for k in range(N):
        du = [tsum(K[k][l][j] * dx[j] for j in range(NX)) + kf[k][l] for l in range(NU)]
        dxs[k], dus[k] = dx, du
        for l in range(NU):
            st = row(
                zu[k][l], du[l], qp.lub[k][l], qp.uub[k][l],
                sul[k][l], suu[k][l], lul[k][l], luu[k][l],
            )
            for out, v in zip(u_dirs, st):
                out[k][l] = v
        x_rows(k, dx)
        dx = dyn_step(*blocks[k], rh[k], h, dx, du)
    dxs[N] = dx
    x_rows(N, dx)
    return dxs, dus, tuple(u_dirs + x_dirs), tuple(acc)


def _stage_blocks(a, b, bc, dt):
    a, b = a.to(dt), b.to(dt)
    return [load_blocks(a[k], b[k], bc[k]) for k in range(a.shape[0])]


def riccati_backward_glue_plain(
    hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu,
    *, h, diag6_stage, diag6_term, rdiag_stage,
):
    """The same function as the backward kernel. hq/a/b may be bf16 (read
    back to the compute dtype of gx). Returns (K (N,40,B), kf (N,4,B),
    rhat (N,10,B), res2 (B,))."""
    dt = gx.dtype
    qp = StagePayload(hq.to(dt), gx, gu, None, None, None, r, lub, uub, lxb, uxb, None)
    bd = (su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up)
    K, kf, rh, r2 = backward_sweep(
        qp, _stage_blocks(a, b, bc, dt), zx, zu, glue_rows(qp, bd, mu),
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
    )
    K40 = [[K[k][l][j] for l in range(NU) for j in range(NX)] for k in range(len(K))]
    return stack_rows(K40), stack_rows(kf), stack_rows(rh), r2


def riccati_forward_glue_plain(
    a, b, bc, rhat, K, kf, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, dx0_res, *, h, tau,
):
    """The same function as the forward kernel. Returns (dx (N+1,10,B),
    du (N,4,B), dsu_lo, dsu_up, dlu_lo, dlu_up (N,4,B), dsx_lo, dsx_up,
    dlx_lo, dlx_up (N+1,3,B), ap, ad (B,) clamped at 1, comp4 (4,B))."""
    N = K.shape[0]
    qp = StagePayload(None, None, None, None, None, None, None, lub, uub, lxb, uxb, None)
    bd = (su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up)
    dxs, dus, dirs, acc = forward_pass(
        qp, _stage_blocks(a, b, bc, bc.dtype), K.reshape(N, NU, NX, -1), kf, rhat,
        zx, zu, bd, mu, list(dx0_res[0]), h=h, tau=tau,
    )
    ap, ad, *comp = acc
    return (
        stack_rows(dxs), stack_rows(dus), *(stack_rows(d) for d in dirs),
        torch.clamp(ap, max=1.0), torch.clamp(ad, max=1.0), torch.stack(comp),
    )


def riccati_iter_fused_plain(
    hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, dx0_res,
    *, h, diag6_stage, diag6_term, rdiag_stage, tau,
):
    """Both plain halves of `riccati_iter_fused`, same outputs."""
    state = (zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up,
             lub, uub, lxb, uxb, mu)
    K, kf, rhat, res2 = riccati_backward_glue_plain(
        hq, gx, gu, a, b, bc, r, *state,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
    )
    outs = riccati_forward_glue_plain(a, b, bc, rhat, K, kf, *state, dx0_res, h=h, tau=tau)
    return outs + (res2,)


# ---- the kernels ----

_STATE = ("zx", "zu", "su_lo", "su_up", "sx_lo", "sx_up", "lu_lo", "lu_up", "lx_lo", "lx_up")
_OUT_FWD = ("dx", "du", "dsu_lo", "dsu_up", "dlu_lo", "dlu_up",
            "dsx_lo", "dsx_up", "dlx_lo", "dlx_up", "ap", "ad", "comp4")


class _IterPtrs(ctypes.Structure):
    """Mirror of `ndp::IterPtrs` (csrc/riccati_iter.cu)."""

    _fields_ = [("q", _cuda.QpPtrs)] + _cuda.pointers(
        _STATE + ("mu", "dx0_res", "K", "kf", "rh", "res2") + _OUT_FWD
    )


def _lib(lib=None):
    return _cuda.bind(
        "riccati_iter", _IterPtrs, ("riccati_backward_launch", "riccati_forward_launch"),
        "riccati_backward_geometry", lib=lib,
    )


def geometry(B: int, jac_bf16: bool, lib=None) -> dict:
    """K4's launch geometry as its library computes it (mirrored by
    `_cuda.sweep_geometry("glue", B, jac_bf16)`)."""
    return _cuda.c_geometry(_lib(lib).riccati_backward_geometry, B, 0, jac_bf16)


ROUTES = ("one-thread sweep", "tensor copies")  # K4's and K6's kernel, by the C route code


def last_route(lib=None) -> str:
    """Which kernel K4's last launch from `lib` (None: the default build)
    ran: "tensor copies" (the teams fed by tensor copies: B a multiple of 8,
    every tensor on 16 bytes) or "one-thread sweep"."""
    code = _lib(lib).riccati_backward_route()
    return ROUTES[code] if code >= 0 else "none"


def _state_shapes(N, B):
    return dict(
        zx=(N + 1, NX, B), zu=(N, NU, B), su_lo=(N, NU, B), su_up=(N, NU, B),
        sx_lo=(N + 1, 3, B), sx_up=(N + 1, 3, B), lu_lo=(N, NU, B), lu_up=(N, NU, B),
        lx_lo=(N + 1, 3, B), lx_up=(N + 1, 3, B), mu=(B,), dx0_res=(1, NX, B),
        K=(N, NU * NX, B), kf=(N, NU, B), rh=(N, NX, B), res2=(B,),
        dx=(N + 1, NX, B), du=(N, NU, B), dsu_lo=(N, NU, B), dsu_up=(N, NU, B),
        dlu_lo=(N, NU, B), dlu_up=(N, NU, B), dsx_lo=(N + 1, 3, B),
        dsx_up=(N + 1, 3, B), dlx_lo=(N + 1, 3, B), dlx_up=(N + 1, 3, B),
        ap=(B,), ad=(B,), comp4=(4, B),
    )


def _ptrs(qp: dict, tensors: dict, a):
    """Check every tensor and build the pointer struct; returns it with the
    batch and device."""
    _cuda.need_cuda("riccati_iter_fused", a)
    N, _, B = a.shape
    dev = a.device
    shapes = _state_shapes(N, B)
    for name, t in tensors.items():
        _cuda.check(name, t, shapes[name], dev)
    q = _cuda.qp_ptrs(qp, N, B, a.dtype == torch.bfloat16, dev)
    return _IterPtrs(q=q, **{n: _cuda.ptr(t) for n, t in tensors.items()}), N, B, dev


def riccati_backward_glue(
    hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, **consts,
):
    """Backward sweep of one IPM iteration, one kernel launch; arguments and
    results as `riccati_backward_glue_plain`. Counts its launches in
    `riccati_backward_glue.launches`."""
    args = (hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
            lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu)
    if a.device.type == "cpu":
        return riccati_backward_glue_plain(*args, **consts)
    out = backward_glue_launch(*args, **consts)
    riccati_backward_glue.launches += 1
    return out


def backward_glue_launch(
    hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, lib=None, **consts,
):
    """Launch K4 from `lib` (a build of csrc/riccati_iter.cu, such as a
    variant of `_build.load`; None: the default build) on CUDA tensors and
    return (K, kf, rhat, res2); counts nothing."""
    N, _, B = a.shape
    out = {n: torch.empty(s, dtype=torch.float32, device=a.device)
           for n, s in _state_shapes(N, B).items() if n in ("K", "kf", "rh", "res2")}
    state = dict(zip(_STATE, (zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up)))
    ptrs, N, B, dev = _ptrs(
        dict(hq=hq, gx=gx, gu=gu, a=a, b=b, bc=bc, r=r, lub=lub, uub=uub, lxb=lxb, uxb=uxb),
        dict(state, mu=mu, **out), a,
    )
    _cuda.launch(_lib(lib).riccati_backward_launch, a.dtype == torch.bfloat16,
                 _cuda.step_consts(N, consts), ptrs, B, dev)
    return out["K"], out["kf"], out["rh"], out["res2"]


def riccati_forward_glue(
    a, b, bc, rhat, K, kf, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, dx0_res, **consts,
):
    """Forward rollout of one IPM iteration, one kernel launch; arguments
    and results as `riccati_forward_glue_plain`. Counts its launches in
    `riccati_forward_glue.launches`."""
    if a.device.type == "cpu":
        return riccati_forward_glue_plain(
            a, b, bc, rhat, K, kf, zx, zu, su_lo, su_up, sx_lo, sx_up,
            lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, dx0_res, **consts,
        )
    N, _, B = a.shape
    out = {n: torch.empty(s, dtype=torch.float32, device=a.device)
           for n, s in _state_shapes(N, B).items() if n in _OUT_FWD}
    state = dict(zip(_STATE, (zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up)))
    ptrs, N, B, dev = _ptrs(
        dict(a=a, b=b, bc=bc, lub=lub, uub=uub, lxb=lxb, uxb=uxb),
        dict(state, mu=mu, dx0_res=dx0_res, K=K, kf=kf, rh=rhat, **out), a,
    )
    _cuda.launch(_lib().riccati_forward_launch, a.dtype == torch.bfloat16,
                 _cuda.step_consts(N, consts), ptrs, B, dev)
    riccati_forward_glue.launches += 1
    return tuple(out[n] for n in _OUT_FWD)


riccati_backward_glue.launches = 0
riccati_forward_glue.launches = 0


def riccati_iter_fused(
    hq, gx, gu, a, b, bc, r, zx, zu, su_lo, su_up, sx_lo, sx_up,
    lu_lo, lu_up, lx_lo, lx_up, lub, uub, lxb, uxb, mu, dx0_res,
    *, h, diag6_stage, diag6_term, rdiag_stage, tau,
):
    """One complete glue-fused IPM iteration's device work: the backward
    sweep with the slack elimination, then the forward rollout with the
    slack/dual direction recovery, the fraction-to-boundary step sizes and
    the complementarity partials (two launches on CUDA tensors).

    Payload (N+1 or N, d, B) as `linearize_stage_data` returns it; the
    iterate zx (N+1,10,B), zu (N,4,B), the slacks and duals su/lu (N,4,B),
    sx/lx (N+1,3,B), mu (B,) and dx0_res (1,10,B). Returns (dx (N+1,10,B),
    du (N,4,B), dsu_lo, dsu_up, dlu_lo, dlu_up (N,4,B), dsx_lo, dsx_up,
    dlx_lo, dlx_up (N+1,3,B), ap, ad (B,) reduced and clamped at 1, comp4
    (4,B) = [sum s*l, sum ds*l, sum s*dl, sum ds*dl] over all box rows,
    res2 (B,) = sum of rhat^2 over the stages (add the dx0 residual
    outside)), as the TPU version does."""
    state = (zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up,
             lub, uub, lxb, uxb, mu)
    K, kf, rhat, res2 = riccati_backward_glue(
        hq, gx, gu, a, b, bc, r, *state,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
    )
    outs = riccati_forward_glue(a, b, bc, rhat, K, kf, *state, dx0_res, h=h, tau=tau)
    return outs + (res2,)


# ---- one Newton sweep with the row terms given (riccati_sweep_sparse) ----


def riccati_sweep_backward_plain(
    hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x,
    *, h, diag6_stage, diag6_term, rdiag_stage,
):
    """The same function as the K6 kernel (`_backward_kernel`): the
    backward sweep at the iterate (zx, zu) with sig/corr given. hq/a/b may
    be bf16 (read back to the compute dtype of gx). Returns (K (N,40,B),
    kf (N,4,B), rhat (N,10,B))."""
    dt = gx.dtype
    qp = StagePayload(hq.to(dt), gx, gu, None, None, None, r, None, None, None, None, None)
    K, kf, rh, _ = backward_sweep(
        qp, _stage_blocks(a, b, bc, dt), zx, zu, given_rows(sig_u, sig_x, corr_u, corr_x),
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
    )
    K40 = [[K[k][l][j] for l in range(NU) for j in range(NX)] for k in range(len(K))]
    return stack_rows(K40), stack_rows(kf), stack_rows(rh)


def riccati_sweep_forward_plain(
    a, b, bc, rhat, K, kf, dx0_res, clip_lo=None, clip_hi=None, *, h, with_hold=False,
):
    """The same function as the K7 kernel (`_forward_kernel`): du = K dx +
    kf, clipped to [clip_lo, clip_hi] (N,4,B) where given (NaN propagates),
    then dx' = A dx + B du + rhat; with `with_hold` also the zero-control
    rollout dx_hold' = A dx_hold + rhat from the same dx0_res (1,10,B).
    Returns (dx (N+1,10,B), du (N,4,B)) and with `with_hold` dx_hold
    (N+1,10,B)."""
    N = K.shape[0]
    blocks = _stage_blocks(a, b, bc, bc.dtype)
    Kl = K.reshape(N, NU, NX, -1)
    dx = list(dx0_res[0])
    dxh = list(dx)
    dxs, dus, dxhs = [], [], []
    for k in range(N):
        du = [tsum(Kl[k][l][j] * dx[j] for j in range(NX)) + kf[k][l] for l in range(NU)]
        if clip_lo is not None:
            du = [torch.minimum(torch.maximum(du[l], clip_lo[k][l]), clip_hi[k][l])
                  for l in range(NU)]
        dxs.append(dx)
        dus.append(du)
        dx = dyn_step(*blocks[k], rhat[k], h, dx, du)
        if with_hold:
            dxhs.append(dxh)
            dxh = dyn_step(*blocks[k], rhat[k], h, dxh, None)
    dxs.append(dx)
    out = (stack_rows(dxs), stack_rows(dus))
    if with_hold:
        dxhs.append(dxh)
        out += (stack_rows(dxhs),)
    return out


class _SweepPtrs(ctypes.Structure):
    """Mirror of `ndp::SweepPtrs` (csrc/riccati_sweep.cu)."""

    _fields_ = [("q", _cuda.QpPtrs)] + _cuda.pointers((
        "zx", "zu", "sig_u", "sig_x", "corr_u", "corr_x", "K", "kf", "rh", "dx0_res",
        "clip_lo", "clip_hi", "dx", "du", "dx_hold",
    ))


def _sweep_lib(lib=None):
    return _cuda.bind(
        "riccati_sweep", _SweepPtrs,
        ("riccati_sweep_backward_launch", "riccati_sweep_forward_launch"),
        "riccati_sweep_backward_geometry", lib=lib,
    )


def sweep_geometry(B: int, jac_bf16: bool, lib=None) -> dict:
    """K6's launch geometry as its library computes it (mirrored by
    `_cuda.sweep_geometry("given", B, jac_bf16)`)."""
    return _cuda.c_geometry(_sweep_lib(lib).riccati_sweep_backward_geometry, B, 0, jac_bf16)


def last_sweep_route(lib=None) -> str:
    """Which kernel K6's last launch from `lib` (None: the default build)
    ran: "tensor copies" (the teams fed by tensor copies: B a multiple of 8,
    every tensor on 16 bytes) or "one-thread sweep"."""
    code = _sweep_lib(lib).riccati_sweep_backward_route()
    return ROUTES[code] if code >= 0 else "none"


def _sweep_ptrs(qp: dict, tensors: dict, a):
    """Check every tensor and build the pointer struct; returns it with the
    stage count, batch and device."""
    _cuda.need_cuda("riccati_sweep_sparse", a)
    N, _, B = a.shape
    shapes = dict(
        zx=(N + 1, NX, B), zu=(N, NU, B), sig_u=(N, NU, B), sig_x=(N + 1, 3, B),
        corr_u=(N, NU, B), corr_x=(N + 1, 3, B), K=(N, NU * NX, B), kf=(N, NU, B),
        rh=(N, NX, B), dx0_res=(1, NX, B), clip_lo=(N, NU, B), clip_hi=(N, NU, B),
        dx=(N + 1, NX, B), du=(N, NU, B), dx_hold=(N + 1, NX, B),
    )
    for name, t in tensors.items():
        if t is not None:
            _cuda.check(name, t, shapes[name], a.device)
    q = _cuda.qp_ptrs(qp, N, B, a.dtype == torch.bfloat16, a.device)
    return _SweepPtrs(q=q, **{n: _cuda.ptr(t) for n, t in tensors.items()}), N, B


def riccati_sweep_backward(
    hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x, **consts,
):
    """K6, the backward sweep with the row terms given, one kernel launch;
    arguments and results as `riccati_sweep_backward_plain`. Counts its
    launches in `riccati_sweep_backward.launches`."""
    args = (hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x)
    if a.device.type == "cpu":
        return riccati_sweep_backward_plain(*args, **consts)
    out = sweep_backward_launch(*args, **consts)
    riccati_sweep_backward.launches += 1
    return out


def sweep_backward_launch(
    hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x, lib=None, **consts,
):
    """Launch K6 from `lib` (a build of csrc/riccati_sweep.cu, such as a
    variant of `_build.load`; None: the default build) on CUDA tensors and
    return (K, kf, rhat); counts nothing."""
    N, _, B = a.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=a.device)
    out = dict(K=new(N, NU * NX, B), kf=new(N, NU, B), rh=new(N, NX, B))
    ptrs, N, B = _sweep_ptrs(
        dict(hq=hq, gx=gx, gu=gu, a=a, b=b, bc=bc, r=r),
        dict(zx=zx, zu=zu, sig_u=sig_u, sig_x=sig_x, corr_u=corr_u, corr_x=corr_x, **out), a,
    )
    _cuda.launch(_sweep_lib(lib).riccati_sweep_backward_launch, a.dtype == torch.bfloat16,
                 _cuda.step_consts(N, consts), ptrs, B, a.device)
    return out["K"], out["kf"], out["rh"]


def riccati_sweep_forward(
    a, b, bc, rhat, K, kf, dx0_res, clip_lo=None, clip_hi=None, *, h, with_hold=False,
):
    """K7, the forward rollout (optional clip, optional zero-control hold
    rollout), one kernel launch; arguments and results as
    `riccati_sweep_forward_plain`. Without a clip no bound is read (null
    pointers). `with_hold` is meaningful only at the zero iterate, where
    rhat equals the payload's r; that is the caller's to ensure. Counts its
    launches in `riccati_sweep_forward.launches`."""
    if a.device.type == "cpu":
        return riccati_sweep_forward_plain(
            a, b, bc, rhat, K, kf, dx0_res, clip_lo, clip_hi, h=h, with_hold=with_hold,
        )
    if (clip_lo is None) != (clip_hi is None):
        raise ValueError("riccati_sweep_forward: give both clip bounds or neither")
    N, _, B = a.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=a.device)
    out = dict(dx=new(N + 1, NX, B), du=new(N, NU, B),
               dx_hold=new(N + 1, NX, B) if with_hold else None)
    ptrs, N, B = _sweep_ptrs(
        dict(a=a, b=b, bc=bc),
        dict(K=K, kf=kf, rh=rhat, dx0_res=dx0_res, clip_lo=clip_lo, clip_hi=clip_hi, **out), a,
    )
    _cuda.launch(_sweep_lib().riccati_sweep_forward_launch, a.dtype == torch.bfloat16,
                 _cuda.step_consts(N, dict(h=h)), ptrs, B, a.device)
    riccati_sweep_forward.launches += 1
    return (out["dx"], out["du"]) + ((out["dx_hold"],) if with_hold else ())


riccati_sweep_backward.launches = 0
riccati_sweep_forward.launches = 0


def riccati_sweep_sparse(
    hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x, dx0_res,
    clip_lo=None, clip_hi=None, *, h, diag6_stage, diag6_term, rdiag_stage,
    with_hold=False,
):
    """One Newton sweep of the equality-constrained LQR at the iterate
    (zx, zu), gradients ghat = g + H z + corr and defects rhat = A zx + B zu
    + r - zx' assembled in the backward sweep (two launches on CUDA tensors:
    K6, K7). Shapes: payload as `linearize_stage_data` returns it, zx
    (N+1,10,B), zu (N,4,B), sig_u/corr_u (N,4,B), sig_x/corr_x (N+1,3,B),
    dx0_res (1,10,B), clip_lo/hi (N,4,B) or None.

    Returns (dx (N+1,10,B), du (N,4,B), rhat (N,10,B)); with `with_hold`
    also the zero-control rollout dx_hold (N+1,10,B), valid only at the zero
    iterate (zx = zu = 0, where rhat equals r), as the TPU version."""
    K, kf, rhat = riccati_sweep_backward(
        hq, gx, gu, a, b, bc, r, zx, zu, sig_u, sig_x, corr_u, corr_x,
        h=h, diag6_stage=diag6_stage, diag6_term=diag6_term, rdiag_stage=rdiag_stage,
    )
    dx, du, *hold = riccati_sweep_forward(
        a, b, bc, rhat, K, kf, dx0_res, clip_lo, clip_hi, h=h, with_hold=with_hold,
    )
    return (dx, du, rhat, *hold)
