"""The one-kernel control step's plain version: a frozen copy of the
port's `ops/kernels/linearize.py` (`linearize_stage_data_plain` and its
tile helpers), `riccati.py` (`chol4`, `chol4_solve`), `riccati_sparse.py`
(the stage helpers, `backward_sweep`, `forward_pass`), `ipm_whole.py`
(`ipm_whole`, `riccati_ipm_whole_plain`) and `step_whole.py`
(`control_step_whole_plain`). Every element is a (B,) tensor; the compute
dtype is the dtype of the iterates. Imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


NX = 10


NU = 4


def tsum(terms):
    """Left-to-right sum of an iterable of tensors (no leading `0 +`)."""
    it = iter(terms)
    s = next(it)
    for t in it:
        s = s + t
    return s


def _tadd(*terms):
    """Sum of tangent terms; None is a structural zero."""
    terms = [t for t in terms if t is not None]
    return tsum(terms) if terms else None


def _tprod(a, ta, b, tb):
    """Tangent of a * b."""
    return _tadd(None if ta is None else ta * b, None if tb is None else a * tb)


def _tscale(c, t):
    return None if t is None else c * t


def f_cont(x, u, fd, *, mass, gravity):
    """Continuous dynamics on element tuples (`models/quadrotor.py`)."""
    vx, vy, vz = x[3], x[4], x[5]
    qw, qx, qy, qz = x[6], x[7], x[8], x[9]
    wx, wy, wz, c = u
    ax = 2.0 * (qx * qz + qw * qy) * c
    ay = 2.0 * (qy * qz - qw * qx) * c
    az = (1.0 - 2.0 * qx * qx - 2.0 * qy * qy) * c - gravity
    if fd is not None:
        ax = ax + fd[0] * (1.0 / mass)
        ay = ay + fd[1] * (1.0 / mass)
        az = az + fd[2] * (1.0 / mass)
    dqw = (-wx * qx - wy * qy - wz * qz) * 0.5
    dqx = (wx * qw + wz * qy - wy * qz) * 0.5
    dqy = (wy * qw - wz * qx + wx * qz) * 0.5
    dqz = (wz * qw + wy * qx - wx * qy) * 0.5
    return (vx, vy, vz, ax, ay, az, dqw, dqx, dqy, dqz)


def f_cont_jvp(x, u, tx, tu):
    """Directional derivative of `f_cont` at (x, u) along (tx, tu).

    The disturbance force is a constant input, so it has no tangent."""
    qw, qx, qy, qz = x[6], x[7], x[8], x[9]
    wx, wy, wz, c = u
    tqw, tqx, tqy, tqz = tx[6], tx[7], tx[8], tx[9]
    twx, twy, twz, tc = tu

    s_ax = qx * qz + qw * qy
    t_ax = _tadd(_tprod(qx, tqx, qz, tqz), _tprod(qw, tqw, qy, tqy))
    s_ay = qy * qz - qw * qx
    t_m = _tprod(qw, tqw, qx, tqx)
    t_ay = _tadd(_tprod(qy, tqy, qz, tqz), _tscale(-1.0, t_m))
    s_az = 1.0 - 2.0 * qx * qx - 2.0 * qy * qy
    t_az = _tadd(_tscale(-4.0 * qx, tqx), _tscale(-4.0 * qy, tqy))
    dax = _tprod(2.0 * s_ax, _tscale(2.0, t_ax), c, tc)
    day = _tprod(2.0 * s_ay, _tscale(2.0, t_ay), c, tc)
    daz = _tprod(s_az, t_az, c, tc)

    def half(*terms):
        return _tscale(0.5, _tadd(*terms))

    def neg(t):
        return _tscale(-1.0, t)

    ddqw = half(
        neg(_tprod(wx, twx, qx, tqx)), neg(_tprod(wy, twy, qy, tqy)),
        neg(_tprod(wz, twz, qz, tqz)),
    )
    ddqx = half(
        _tprod(wx, twx, qw, tqw), _tprod(wz, twz, qy, tqy),
        neg(_tprod(wy, twy, qz, tqz)),
    )
    ddqy = half(
        _tprod(wy, twy, qw, tqw), neg(_tprod(wz, twz, qx, tqx)),
        _tprod(wx, twx, qz, tqz),
    )
    ddqz = half(
        _tprod(wz, twz, qw, tqw), _tprod(wy, twy, qx, tqx),
        neg(_tprod(wx, twx, qy, tqy)),
    )
    return (tx[3], tx[4], tx[5], dax, day, daz, ddqw, ddqx, ddqy, ddqz)


def rk4(x, u, fd, *, h, substeps, mass, gravity):
    """Classic RK4 on element tuples. Returns (x_next, points), where
    points holds each substep's four evaluation states for `rk4_jvp`."""
    hh = h / substeps
    points = []
    for _ in range(substeps):
        k1 = f_cont(x, u, fd, mass=mass, gravity=gravity)
        x2 = tuple(x[i] + (0.5 * hh) * k1[i] for i in range(NX))
        k2 = f_cont(x2, u, fd, mass=mass, gravity=gravity)
        x3 = tuple(x[i] + (0.5 * hh) * k2[i] for i in range(NX))
        k3 = f_cont(x3, u, fd, mass=mass, gravity=gravity)
        x4 = tuple(x[i] + hh * k3[i] for i in range(NX))
        k4 = f_cont(x4, u, fd, mass=mass, gravity=gravity)
        points.append((x, x2, x3, x4))
        x = tuple(
            x[i] + (hh / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(NX)
        )
    return x, points


def rk4_jvp(points, u, tx, tu, *, h, substeps):
    """Tangent of the RK4 step along (tx, tu), replayed on the primal
    evaluation states `points` from `rk4` (what `jax.linearize` does)."""
    hh = h / substeps
    for xs in points:
        t1 = f_cont_jvp(xs[0], u, tx, tu)
        tx2 = tuple(_tadd(tx[i], _tscale(0.5 * hh, t1[i])) for i in range(NX))
        t2 = f_cont_jvp(xs[1], u, tx2, tu)
        tx3 = tuple(_tadd(tx[i], _tscale(0.5 * hh, t2[i])) for i in range(NX))
        t3 = f_cont_jvp(xs[2], u, tx3, tu)
        tx4 = tuple(_tadd(tx[i], _tscale(hh, t3[i])) for i in range(NX))
        t4 = f_cont_jvp(xs[3], u, tx4, tu)
        tx = tuple(
            _tadd(
                tx[i],
                _tscale(
                    hh / 6.0,
                    _tadd(t1[i], _tscale(2.0, t2[i]), _tscale(2.0, t3[i]), t4[i]),
                ),
            )
            for i in range(NX)
        )
    return tx


def qe_tiles(q, q_ref):
    """Quaternion tracking error (`ops/quat.py:error_vector`)."""
    qw, qx, qy, qz = q
    qwr, qxr, qyr, qzr = q_ref
    return (
        qwr * qx - qw * qxr + qyr * qz - qy * qzr,
        qwr * qy - qw * qyr - qxr * qz + qx * qzr,
        qxr * qy - qx * qyr + qwr * qz - qw * qzr,
    )


def hq_gxq_tiles(q_ref, qe, wq):
    """Closed-form Hq = Gq^T diag(wq) Gq (16) and Gq^T (wq * qe) (4)."""
    qw, qx, qy, qz = q_ref
    cols = (
        (-qx, -qy, -qz),
        (qw, qz, -qy),
        (-qz, qw, qx),
        (qy, -qx, qw),
    )
    w1, w2, w3 = wq
    hq = [
        w1 * cols[i][0] * cols[j][0]
        + w2 * cols[i][1] * cols[j][1]
        + w3 * cols[i][2] * cols[j][2]
        for i in range(4)
        for j in range(4)
    ]
    v0, v1, v2 = w1 * qe[0], w2 * qe[1], w3 * qe[2]
    gxq = [cols[i][0] * v0 + cols[i][1] * v1 + cols[i][2] * v2 for i in range(4)]
    return hq, gxq


def lin_stage_terms(
    x, x1, u, xr, ur, fd,
    *, h, substeps, mass, gravity, stage_scale, q_diag, r_diag,
):
    """One shooting stage's QP terms (`linearize._lin_stage_terms`).

    Returns (hq16, gx10, gu4, a40, b30, bc6, r10) as lists of (B,) tensors
    in the compute dtype (callers round the curvature payloads)."""
    wq = q_diag[7:10]
    q_ref = xr[6:10]
    qe = qe_tiles(x[6:10], q_ref)
    hq16, gxq = hq_gxq_tiles(q_ref, qe, wq)
    hq = [stage_scale * t for t in hq16]
    gx = [(stage_scale * q_diag[i]) * (x[i] - xr[i]) for i in range(6)]
    gx += [stage_scale * g for g in gxq]
    gu = [(stage_scale * r_diag[l]) * (u[l] - ur[l]) for l in range(NU)]

    x_next, points = rk4(x, u, fd, h=h, substeps=substeps, mass=mass, gravity=gravity)
    one = x[0].new_ones(())
    zx = (None,) * NX
    zu = (None,) * NU
    a_cols = [
        rk4_jvp(
            points, u, tuple(one if i == 6 + j else None for i in range(NX)), zu,
            h=h, substeps=substeps,
        )
        for j in range(4)
    ]
    b_cols = [
        rk4_jvp(
            points, u, zx, tuple(one if m == l else None for m in range(NU)),
            h=h, substeps=substeps,
        )
        for l in range(NU)
    ]
    a40 = [None] * 40
    for i in range(3):
        for j in range(4):
            a40[i * 4 + j] = a_cols[j][i]  # Apq
            a40[12 + i * 4 + j] = a_cols[j][3 + i]  # Avq
    for i in range(4):
        for j in range(4):
            a40[24 + i * 4 + j] = a_cols[j][6 + i]  # Aqq
    b30 = [None] * 30
    bc6 = [None] * 6
    for i in range(3):
        for l in range(3):
            b30[i * 3 + l] = b_cols[l][i]  # Bp omega cols
            b30[9 + i * 3 + l] = b_cols[l][3 + i]  # Bv omega
        bc6[i] = b_cols[3][i]  # collective cols stay in the compute dtype
        bc6[3 + i] = b_cols[3][3 + i]
    for i in range(4):
        for l in range(3):
            b30[18 + i * 3 + l] = b_cols[l][6 + i]  # Bq
    zero = x[0].new_zeros(())
    a40 = [zero.expand_as(x[0]) if t is None else t for t in a40]
    b30 = [zero.expand_as(x[0]) if t is None else t for t in b30]
    bc6 = [zero.expand_as(x[0]) if t is None else t for t in bc6]
    r = [x_next[i] - x1[i] for i in range(NX)]
    return hq, gx, gu, a40, b30, bc6, r


def lin_terminal_terms(x1, xrT, *, q_diag):
    """Terminal-node GN terms (acados cost_scaling[-1] = 1)."""
    wq = q_diag[7:10]
    q_refT = xrT[6:10]
    qeT = qe_tiles(x1[6:10], q_refT)
    hqT, gxqT = hq_gxq_tiles(q_refT, qeT, wq)
    gxT = [q_diag[i] * (x1[i] - xrT[i]) for i in range(6)] + list(gxqT)
    return hqT, gxT


def stack_rows(rows, dtype=None):
    """[stage][element] lists of (B,) tensors -> one (stage, element, B)."""
    out = torch.stack([torch.stack(row) for row in rows])
    return out if dtype is None else out.to(dtype)


def linearize_stage_data_plain(
    xb, ub, xr, ur, fd, x0,
    *, h, substeps, mass, gravity, stage_scale, q_diag, r_diag,
    u_lo, u_hi, v_lo, v_hi, with_dist, big, jac_bf16=False,
):
    """The same function as the kernel: the SparseQp payload at the
    iterates, in the compute dtype of xb (f32 or f64), the curvature fields
    hq/a/b rounded to bf16 with `jac_bf16`.

    Returns (hq (N+1,16,B), gx (N+1,10,B), gu (N,4,B), a (N,40,B),
    b (N,30,B), bc (N,6,B), r (N,10,B), lu, uu (N,4,B), lx, ux (N+1,3,B),
    dx0 (1,10,B)); the velocity box is active on nodes 1..N-1 only (rows 0
    and N are -+big)."""
    N = xb.shape[0] - 1
    jd = torch.bfloat16 if jac_bf16 else xb.dtype
    hq, gx, gu, a, b, bc, r, lub, uub, lxb, uxb = ([] for _ in range(11))
    for k in range(N):
        x = tuple(xb[k, i] for i in range(NX))
        x1 = tuple(xb[k + 1, i] for i in range(NX))
        u = tuple(ub[k, l] for l in range(NU))
        xr_k = tuple(xr[k, i] for i in range(NX))
        ur_k = tuple(ur[k, l] for l in range(NU))
        fd_k = tuple(fd[k, t] for t in range(3)) if with_dist else None
        terms = lin_stage_terms(
            x, x1, u, xr_k, ur_k, fd_k,
            h=h, substeps=substeps, mass=mass, gravity=gravity,
            stage_scale=stage_scale, q_diag=q_diag, r_diag=r_diag,
        )
        for lst, t in zip((hq, gx, gu, a, b, bc, r), terms):
            lst.append(t)
        lub.append([u_lo[l] - u[l] for l in range(NU)])
        uub.append([u_hi[l] - u[l] for l in range(NU)])
        lxb.append([v_lo[t] - x[3 + t] for t in range(3)])
        uxb.append([v_hi[t] - x[3 + t] for t in range(3)])
    hqT, gxT = lin_terminal_terms(
        tuple(xb[N, i] for i in range(NX)), tuple(xr[N, i] for i in range(NX)),
        q_diag=q_diag,
    )
    hq.append(hqT)
    gx.append(gxT)
    bigt = torch.full_like(xb[0, 0], big)
    lxb[0] = [-bigt] * 3
    uxb[0] = [bigt] * 3
    lxb.append([-bigt] * 3)
    uxb.append([bigt] * 3)
    dx0 = [[x0[0, i] - xb[0, i] for i in range(NX)]]
    return (
        stack_rows(hq, jd), stack_rows(gx), stack_rows(gu), stack_rows(a, jd),
        stack_rows(b, jd), stack_rows(bc), stack_rows(r), stack_rows(lub),
        stack_rows(uub), stack_rows(lxb), stack_rows(uxb), stack_rows(dx0),
    )


def chol4(R):
    """Cholesky of a 4x4 SPD matrix; returns (lower L, reciprocal diagonal).
    R is indexed R[i][j]; its entries may be tensors of any one shape."""
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
    """Solve (L L^T) X = rhs for each column (list of 4 elements; an element
    may carry extra leading dimensions, so one call solves many columns)."""
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
    dx0: list


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
