"""Structure-sparse Riccati stage algebra: plain PyTorch versions.

Port of the per-stage helpers of `ndp_nmpc_qd_tpu/ops/pallas/riccati_sparse.py`
(`_bt_dot`, `_glue_pair`, `_terminal_init_core`, `_riccati_stage_core`,
`_dyn_step`, `_ratio`, `_bound_steps`) and of the 4x4 Cholesky helpers of
`ops/pallas/riccati.py` (`_chol4`, `_chol4_solve`). Every argument is a
(B,) tensor or a nested list of them, one per matrix element, as the Pallas
helpers take one (SUB, 128) tile per element; the CUDA device functions of
the same names (`csrc/step_whole.cuh`) do the same arithmetic for one
scenario per thread.

The stage structure (see `solver/ocp_sparse.py` of the JAX package):
A = [[I, h I, Apq], [0, I, Avq], [0, 0, Aqq]], B has no quaternion <-
collective column, Hxx = diag6 (+) Hq and Huu is a constant diagonal.

The Pallas versions write the new cost-to-go into VMEM scratch; these return
it instead.
"""

from __future__ import annotations

import torch

from .linearize import NU, NX, tsum


def chol4(R):
    """Cholesky of a 4x4 SPD matrix; returns (lower L, reciprocal diagonal)."""
    L = [[None] * 4 for _ in range(4)]
    Ld = [None] * 4
    for i in range(4):
        for j in range(i + 1):
            s = R[i][j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            if i == j:
                L[i][j] = torch.sqrt(s)
                Ld[i] = 1.0 / L[i][j]
            else:
                L[i][j] = s * Ld[j]
    return L, Ld


def chol4_solve(L_Ld, rhs_cols):
    """Solve (L L^T) X = rhs for each column (list of 4 elements)."""
    L, Ld = L_Ld
    out = []
    for col in rhs_cols:
        y = [None] * 4
        for i in range(4):
            s = col[i]
            for t in range(i):
                s = s - L[i][t] * y[t]
            y[i] = s * Ld[i]
        x = [None] * 4
        for i in reversed(range(4)):
            s = y[i]
            for t in range(i + 1, 4):
                s = s - L[t][i] * x[t]
            x[i] = s * Ld[i]
        out.append(x)
    return out


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
