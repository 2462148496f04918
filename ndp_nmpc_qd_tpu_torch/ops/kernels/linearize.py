"""Stage linearization: CUDA kernel wrapper, plain version, tile helpers.

Port of `ndp_nmpc_qd_tpu/ops/pallas/linearize.py`.

- `linearize_stage_data` is the entry point (the TPU kernel
  `linearize_stage_data`). For CUDA tensors it launches the hand-written
  kernel (`csrc/linearize.cu`, built at first use) or raises; for CPU
  tensors it runs `linearize_stage_data_plain`. It counts its launches in
  `linearize_stage_data.launches`.
- The helpers below work on tuples of (B,) tensors, one per state or
  control element, exactly as the Pallas helpers work on tuples of
  (SUB, 128) tiles; the CUDA device functions of the same names
  (`csrc/ndp.cuh`) do the same arithmetic for one scenario per thread.

Per stage: the RK4 step x_next = Phi(x, u, f_dist), its 8 varying tangent
columns (4 quaternion state columns, 4 control columns; the other columns
are constants, see `solver/ocp_sparse.py`), the Gauss-Newton cost terms
with the closed-form quaternion Hessian block, and the defect. The JAX
package takes the tangents with `jax.linearize`; here they are propagated
by hand in forward mode (`f_cont_jvp`), with `None` standing for a
structural zero so that no work is spent on it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

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


class _LinPtrs(ctypes.Structure):
    """Mirror of `ndp::LinPtrs` (csrc/linearize.cu)."""

    _fields_ = _cuda.pointers(("xb", "ub", "xr", "ur", "fd", "x0")) + [("q", _cuda.QpPtrs)]


def _lib(lib=None):
    return _cuda.bind("linearize", _LinPtrs, ("linearize_launch",), "linearize_geometry", lib=lib)


GEOMETRY_KEYS = ("threads_per_scenario", "scenarios_per_block", "threads_per_block", "blocks",
                 "smem_bytes_per_block")


def geometry(B: int, n_stages: int, lib=None) -> dict:
    """K3's launch geometry as its library computes it (mirrored by
    `_cuda.lin_geometry`): threads a (stage, scenario), scenarios a block,
    threads a block, blocks, shared memory a block."""
    out = (ctypes.c_longlong * len(GEOMETRY_KEYS))()
    _lib(lib).linearize_geometry(n_stages, 0, B, out)
    return dict(zip(GEOMETRY_KEYS, out))


def linearize_stage_data(xb, ub, xr, ur, fd, x0, **consts):
    """The SparseQp payload at the RTI iterates, one kernel launch.

    xb (N+1, 10, B), ub (N, 4, B) are the iterates; xr/ur the references;
    fd (N+1, 3, B) the downwash forecast (None without disturbance); x0
    (1, 10, B). `consts` are the keywords of `linearize_stage_data_plain`
    (`solver/ocp_sparse.lin_consts`). Returns new tensors in the order of
    `linearize_stage_data_plain`.

    Counts its kernel launches in `linearize_stage_data.launches`.
    """
    if xb.device.type == "cpu":
        return linearize_stage_data_plain(xb, ub, xr, ur, fd, x0, **consts)
    _cuda.need_cuda("linearize_stage_data", xb)
    Np1, _, B = xb.shape
    N = Np1 - 1
    dev = xb.device
    with_dist = bool(consts["with_dist"])
    jac_bf16 = bool(consts.get("jac_bf16", False))
    if B < 1:
        raise ValueError("linearize_stage_data: empty batch")
    for name, t, shape in (
        ("xb", xb, (Np1, NX, B)), ("ub", ub, (N, NU, B)),
        ("xr", xr, (Np1, NX, B)), ("ur", ur, (N, NU, B)), ("x0", x0, (1, NX, B)),
    ) + ((("fd", fd, (Np1, 3, B)),) if with_dist else ()):
        _cuda.check(name, t, shape, dev)
    shapes = _cuda.qp_shapes(N, B)
    jd = torch.bfloat16 if jac_bf16 else torch.float32
    out = {
        n: torch.empty(shapes[n], dtype=jd if n in _cuda.JAC_FIELDS else torch.float32,
                       device=dev)
        for n in _cuda.QP_FIELDS
    }
    ptrs = _LinPtrs(
        xb=xb.data_ptr(), ub=ub.data_ptr(), xr=xr.data_ptr(), ur=ur.data_ptr(),
        fd=fd.data_ptr() if with_dist else None, x0=x0.data_ptr(),
        q=_cuda.qp_ptrs(out, N, B, jac_bf16, dev),
    )
    _cuda.launch(_lib().linearize_launch, jac_bf16, _cuda.step_consts(N, consts), ptrs, B, dev)
    linearize_stage_data.launches += 1
    return tuple(out[n] for n in _cuda.QP_FIELDS)


linearize_stage_data.launches = 0
