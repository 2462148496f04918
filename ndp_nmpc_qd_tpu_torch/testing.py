"""Tolerances for holding a CUDA kernel against its plain version.

Used by `chip_smoke.py` and `tests/test_torch_gpu.py`. The kernel and the
plain version compute the same function in the same operation order; they
differ by nvcc's FMA contraction (one f32 rounding per contracted op) and,
for the payload the linearization rounds to bf16, by a bf16 ulp where that
flips an entry.

Each output is held by its kind:
- "primal" (iterates, directions, gains, defects, step sizes, f32
  payload): |got - ref| <= 1e-4 max(1, max|ref|);
- "dual" (duals, their directions, mu, complementarity sums):
  |got - ref| <= 1e-3 (|ref| + max|ref|), i.e. rtol 1e-3 at the tensor's
  own scale, so values near mu ~ 1e-11 are held as tightly as values near 1;
- "resid" (eq_res and res2, the squared defect sum): |got - ref| <= 1e-3
  |ref| + 1e-6. A dynamics-exact iterate has defects at rounding level,
  where the kernel's contracted FMAs and torch's rounded ops each leave
  their own noise (and the plain version often an exact 0), so these are
  held relative to their value above a floor 1e-3 under the health limit
  eq_res < 1e-3;
- "bf16" (curvature payload rounded to bf16): within one bf16 ulp (2^-8) of
  the tensor's largest entry.
"""

from __future__ import annotations

import torch

BF16_ULP = 2.0 ** -8
TOL = {"primal": 1e-4, "dual": 1e-3, "resid": 1e-3, "bf16": BF16_ULP}


def err_of(kind: str, got, ref) -> float:
    """The error of `got` in the measure that `TOL[kind]` bounds."""
    got, ref = got.float(), ref.float()
    if kind == "dual":
        scale = ref.abs().max() + ref.abs()
        return float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
    if kind == "resid":
        return float(((got - ref).abs() / (ref.abs() + 1e-3)).max())
    if kind == "bf16":
        return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1.0))


def compare(named: dict) -> tuple[dict, list]:
    """named: name -> (kind, got, ref). Returns ({name: error} plus
    "max_abs", the largest |got - ref| over every output, and [names out of
    tolerance]); NaN in either side counts as out of tolerance unless both
    are NaN at the same places."""
    errs, bad, max_abs = {}, [], 0.0
    for name, (kind, got, ref) in named.items():
        same_nan = bool((got.isnan() == ref.isnan()).all())
        keep = ~ref.isnan()
        e = err_of(kind, got[keep], ref[keep]) if bool(keep.any()) else 0.0
        if bool(keep.any()):
            max_abs = max(max_abs, float((got[keep].float() - ref[keep].float()).abs().max()))
        errs[name] = e
        if not (same_nan and e <= TOL[kind]):
            bad.append(name)
    errs["max_abs"] = max_abs
    return errs, bad


def describe(errs: dict) -> str:
    return ", ".join(f"{n} {e:.3g}" for n, e in errs.items())


QP_NAMES = ("hq", "gx", "gu", "a", "b", "bc", "r", "lu", "uu", "lx", "ux", "dx0")
DUAL_NAMES = ("lu_lo", "lu_up", "lx_lo", "lx_up", "mu")
FWD_KINDS = (
    ("dx", "primal"), ("du", "primal"), ("dsu_lo", "primal"), ("dsu_up", "primal"),
    ("dlu_lo", "dual"), ("dlu_up", "dual"), ("dsx_lo", "primal"), ("dsx_up", "primal"),
    ("dlx_lo", "dual"), ("dlx_up", "dual"), ("ap", "primal"), ("ad", "primal"),
    ("comp4", "dual"),
)


def kernel_inputs(B, N, device, seed, gravity=9.81):
    """Kernel-layout inputs (xb, ub, xr, ur, fd, x0) of one linearization:
    hover references at the origin, x0 at random offsets in [-1, 1] m, the
    iterates off the reference (positions/velocities by 0.3, quaternions by
    0.1, controls by 0.2, all normal) and a forecast force of scale 0.3."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g)
    xr = torch.zeros(N + 1, 10, B)
    xr[:, 6] = 1.0
    xb = xr.clone()
    xb[:, 0:6] += 0.3 * rand(N + 1, 6, B)
    xb[:, 6:10] += 0.1 * rand(N + 1, 4, B)
    ur = torch.zeros(N, 4, B)
    ur[:, 3] = gravity
    ub = ur + 0.2 * rand(N, 4, B)
    x0 = xr[:1].clone()
    x0[:, 0:3] += 2.0 * torch.rand(1, 3, B, generator=g) - 1.0
    fd = 0.3 * rand(N + 1, 3, B)
    return tuple(t.to(device) for t in (xb, ub, xr, ur, fd, x0))


def iter_args(qp, consts, warm=None, jitter=0.01, seed=0):
    """The 23 arguments of `riccati_iter_fused` at the per-iteration path's
    start over payload qp (the 12 tensors of `linearize_stage_data`), as
    `ipm_sparse(whole_kernel=False, lqr_start=False)` makes them, with the
    primal iterate then moved by `jitter` (normal): the zero-control start
    is dynamics-exact, and this puts the defects, and the slack residuals
    of the box rows, well above rounding level."""
    from .solver.ocp_sparse import SparseQp, SparseQpConsts
    from .solver.qp_ipm_sparse import ipm_start

    p = SparseQp(*qp[:11])
    sc = SparseQpConsts(**{k: consts[k] for k in SparseQpConsts._fields})
    start = ipm_start(p, sc, qp[11], warm, sigma=consts["sigma"],
                      mu_init=consts["mu_init"], s_min=consts["s_min"],
                      mu_min=consts["mu_min"])
    g = torch.Generator().manual_seed(seed)
    zx, zu = (z + jitter * torch.randn(z.shape, generator=g).to(z.device) for z in start[:2])
    return (*qp[:7], zx, zu, *start[2:10], *qp[7:11], start[10], qp[11] - zx[:1])


def check_linearize(ins, consts):
    """K3 on the card against its plain version on the same inputs
    (xb, ub, xr, ur, fd, x0 in kernel layout). Returns (errors, out of
    tolerance, the plain payload)."""
    from .ops.kernels.linearize import linearize_stage_data, linearize_stage_data_plain

    got = linearize_stage_data(*ins, **consts)
    ref = linearize_stage_data_plain(*ins, **consts)
    jac = "bf16" if consts.get("jac_bf16") else "primal"
    return *compare({
        n: (jac if n in ("hq", "a", "b") else "primal", g, r)
        for n, g, r in zip(QP_NAMES, got, ref)
    }), ref


def check_ipm_whole(qp, duals, consts, xu=None, calls=3):
    """K2 on the card against its plain version: `calls` chained solves over
    the same payload (qp: the 12 tensors of `linearize_stage_data`), each
    side carrying its own duals from the same start (with xu = (xb, ub) the
    axpy is folded, each side into its own copy). Every call is checked;
    returns the worst error of each output and the outputs out of tolerance
    in any call."""
    from .ops.kernels.ipm_whole import riccati_ipm_whole, riccati_ipm_whole_plain

    k = [t.clone() for t in duals]
    p = [t.clone() for t in duals]
    xk = [t.clone() for t in xu] if xu is not None else [None, None]
    xp = list(xu) if xu is not None else [None, None]
    worst, bad = {}, set()
    names = ("zx", "zu") + DUAL_NAMES + ("eq",)
    for _ in range(calls):
        got = riccati_ipm_whole(*qp[:11], *k, qp[11], *xk, **consts)
        ref = riccati_ipm_whole_plain(*qp[:11], *p, qp[11], *xp, **consts)
        p = list(ref[2:7])
        if xu is not None:
            xp = list(ref[:2])
        errs, b = compare({
            n: ("primal" if n in ("zx", "zu") else "resid" if n == "eq" else "dual", g, r)
            for n, g, r in zip(names, got, ref)
        })
        bad.update(b)
        for n, e in errs.items():
            worst[n] = max(worst.get(n, 0.0), e)
    return worst, sorted(bad)


def check_iter(args, consts):
    """K4 and K5 on the card against their plain versions on the same
    inputs (the 23 arguments of `riccati_iter_fused`); K5 gets the plain
    backward sweep's gains on both sides, so each kernel is held alone.
    Returns ({name: error} with max_abs_K4/_K5 beside max_abs, out of
    tolerance) over both kernels' outputs."""
    from .ops.kernels import riccati_sparse as rs

    kw = dict(h=consts["h"], diag6_stage=consts["diag6_stage"],
              diag6_term=consts["diag6_term"], rdiag_stage=consts["rdiag_stage"])
    (hq, gx, gu, a, b, bc, r, *state), dx0_res = args[:-1], args[-1]
    got = rs.riccati_backward_glue(hq, gx, gu, a, b, bc, r, *state, **kw)
    ref = rs.riccati_backward_glue_plain(hq, gx, gu, a, b, bc, r, *state, **kw)
    e4, bad4 = compare({n: (kind, g, r_) for (n, kind), g, r_ in zip(
        (("K", "primal"), ("kf", "primal"), ("rhat", "primal"), ("res2", "resid")), got, ref)})
    K, kf, rhat, _ = ref
    fwd = dict(h=consts["h"], tau=consts["tau"])
    got = rs.riccati_forward_glue(a, b, bc, rhat, K, kf, *state, dx0_res, **fwd)
    ref = rs.riccati_forward_glue_plain(a, b, bc, rhat, K, kf, *state, dx0_res, **fwd)
    e5, bad5 = compare({n: (kind, g, r_) for (n, kind), g, r_ in zip(FWD_KINDS, got, ref)})
    errs = {**e4, **e5, "max_abs_K4": e4["max_abs"], "max_abs_K5": e5["max_abs"]}
    errs["max_abs"] = max(e4["max_abs"], e5["max_abs"])
    return errs, bad4 + bad5


def sweep_args(qp, consts, call, seed=0):
    """The 16 arguments of `riccati_sweep_sparse` over payload qp (the 12
    tensors of `linearize_stage_data`) and its `with_hold`, in the two ways
    the IPM calls it: "lqr_start" (the zero iterate, zero sig/corr, the
    controls clipped to the box less a 1e-3 margin, with the hold rollout)
    and "unfused_glue" (`iter_args`' jittered per-iteration start, sig/corr
    from `ipm_corr_terms`, no clip, no hold)."""
    from .solver.qp_ipm import ipm_corr_terms

    N, _, B = qp[2].shape
    if call == "lqr_start":
        z = lambda *s: torch.zeros(s, dtype=qp[1].dtype, device=qp[1].device)
        zu, z3 = z(N, 4, B), z(N + 1, 3, B)
        margin = 1e-3 * (qp[8] - qp[7])
        return (*qp[:7], z(N + 1, 10, B), zu, zu, z3, zu, z3, qp[11],
                qp[7] + margin, qp[8] - margin), True
    args = iter_args(qp, consts, seed=seed)
    zx, zu, su_lo, su_up, sx_lo, sx_up, lu_lo, lu_up, lx_lo, lx_up = args[7:17]
    mu = args[21]
    sig_u, corr_u, *_ = ipm_corr_terms(zu, qp[7], qp[8], su_lo, su_up, lu_lo, lu_up, mu)
    sig_x, corr_x, *_ = ipm_corr_terms(zx[:, 3:6], qp[9], qp[10], sx_lo, sx_up, lx_lo, lx_up, mu)
    return (*qp[:7], zx, zu, sig_u, sig_x, corr_u, corr_x, args[22], None, None), False


def check_sweep(args, hold, consts):
    """K6 and K7 on the card against their plain versions on the same
    inputs (`sweep_args`); K7 gets the plain backward sweep's gains and
    defects on both sides, so each kernel is held alone. Every output is
    "primal". Returns ({name: error} with max_abs_K6/_K7 beside max_abs,
    out of tolerance)."""
    from .ops.kernels import riccati_sparse as rs

    kw = dict(h=consts["h"], diag6_stage=consts["diag6_stage"],
              diag6_term=consts["diag6_term"], rdiag_stage=consts["rdiag_stage"])
    bwd, dx0_res, lo, hi = args[:13], args[13], args[14], args[15]
    got = rs.riccati_sweep_backward(*bwd, **kw)
    ref = rs.riccati_sweep_backward_plain(*bwd, **kw)
    e6, bad6 = compare({n: ("primal", g, r) for n, g, r in zip(("K", "kf", "rhat"), got, ref)})
    K, kf, rhat = ref
    a, b, bc = args[3], args[4], args[5]
    got = rs.riccati_sweep_forward(a, b, bc, rhat, K, kf, dx0_res, lo, hi, h=consts["h"],
                                   with_hold=hold)
    ref = rs.riccati_sweep_forward_plain(a, b, bc, rhat, K, kf, dx0_res, lo, hi, h=consts["h"],
                                         with_hold=hold)
    e7, bad7 = compare({n: ("primal", g, r) for n, g, r in zip(("dx", "du", "dx_hold"), got, ref)})
    errs = {**e6, **e7, "max_abs_K6": e6["max_abs"], "max_abs_K7": e7["max_abs"]}
    errs["max_abs"] = max(e6["max_abs"], e7["max_abs"])
    return errs, bad6 + bad7


def dense_payload(cfg, B, device, seed):
    """The dense payload (`PackedQp`) and dx0 (1,10,B) of `kernel_inputs`'
    linearization point, as the pallas_packed controller's linearizer makes
    them (f32); cfg is an `NdpNmpcConfig`."""
    from .solver.ocp_packed import make_ocp_functions_packed

    lin, _ = make_ocp_functions_packed(cfg.ocp, cfg.vehicle, True)
    xb, ub, xr, ur, fd, x0 = kernel_inputs(B, cfg.ocp.N_node, device, seed,
                                           gravity=cfg.vehicle.gravity)
    bf = lambda t: t.permute(2, 0, 1)  # (s, d, B) -> (B, s, d)
    return lin(bf(xb), bf(ub), bf(xr), bf(ur), bf(fd), bf(x0)[:, 0])


def packed_args(p, dx0_p, call, seed=0, jitter=0.01):
    """The 12 arguments of `riccati_sweep_packed` over the dense payload p
    (a `PackedQp`) and dx0_p (1,10,B), in the two ways `ipm_packed` calls
    it: "lqr_start" (zero sig, the controls clipped to the box less a 1e-3
    margin) and "newton" (its first iteration's Newton system: the
    clipped-LQR start, moved by `jitter` (normal) so that the defects rhat
    are well above rounding level, the slacks and duals of its start, sig
    and the gradient corrections from `ipm_corr_terms`, no clip). The start
    is made with the plain versions, so no kernel launch is counted."""
    from .ops.kernels.riccati import riccati_backward_packed_plain, riccati_forward_packed_plain
    from .solver.qp_ipm import ipm_corr_terms, ipm_slack_init
    from .solver.qp_ipm_packed import _matvec

    N = p.a.shape[0]
    zeros = torch.zeros_like
    margin = 1e-3 * (p.uu - p.lu)
    lqr = (p.hxx, zeros(p.gx), p.huu, zeros(p.gu), p.gx, p.gu, p.a, p.b, p.r, dx0_p,
           p.lu + margin, p.uu - margin)
    if call == "lqr_start":
        return lqr
    K, kf = riccati_backward_packed_plain(*lqr[:9])
    zx, zu = riccati_forward_packed_plain(p.a, p.b, p.r, K, kf, dx0_p, *lqr[10:])
    g = torch.Generator().manual_seed(seed)
    zx, zu = (z + jitter * torch.randn(z.shape, generator=g, dtype=z.dtype).to(z.device)
              for z in (zx, zu))
    su_lo, su_up = ipm_slack_init(p.lu, p.uu, zu, 1e-3)
    sx_lo, sx_up = ipm_slack_init(p.lx, p.ux, zx[:, 3:6], 1e-3)
    mu = torch.ones_like(p.gx[0, 0])
    sig_u, corr_u, *_ = ipm_corr_terms(zu, p.lu, p.uu, su_lo, su_up, 1 / su_lo, 1 / su_up, mu)
    sig_x3, corr_x, *_ = ipm_corr_terms(zx[:, 3:6], p.lx, p.ux, sx_lo, sx_up, 1 / sx_lo,
                                        1 / sx_up, mu)
    sig_x = torch.cat([zeros(zx[:, :3]), sig_x3, zeros(zx[:, 6:])], dim=1)
    gx = p.gx + _matvec(p.hxx, zx, 10, 10)
    ghat_x = torch.cat([gx[:, :3], gx[:, 3:6] + corr_x, gx[:, 6:]], dim=1)
    ghat_u = p.gu + _matvec(p.huu, zu, 4, 4) + corr_u
    rhat = _matvec(p.a, zx[:N], 10, 10) + _matvec(p.b, zu, 10, 4) + p.r - zx[1:]
    return (p.hxx, sig_x, p.huu, sig_u, ghat_x, ghat_u, p.a, p.b, rhat, dx0_p - zx[:1],
            None, None)


def check_packed(args):
    """K8 and K9 on the card against their plain versions on the same
    inputs (`packed_args`); K9 gets the plain backward sweep's gains on both
    sides, so each kernel is held alone. Every output is "primal". Returns
    ({name: error} with max_abs_K8/_K9 beside max_abs, out of tolerance)."""
    from .ops.kernels import riccati as rc

    bwd, dx0, lo, hi = args[:9], args[9], args[10], args[11]
    got = rc.riccati_backward_packed(*bwd)
    ref = rc.riccati_backward_packed_plain(*bwd)
    e8, bad8 = compare({n: ("primal", g, r) for n, g, r in zip(("K", "kf"), got, ref)})
    K, kf = ref
    a, b, r = bwd[6], bwd[7], bwd[8]
    got = rc.riccati_forward_packed(a, b, r, K, kf, dx0, lo, hi)
    ref = rc.riccati_forward_packed_plain(a, b, r, K, kf, dx0, lo, hi)
    e9, bad9 = compare({n: ("primal", g, r_) for n, g, r_ in zip(("dx", "du"), got, ref)})
    errs = {**e8, **e9, "max_abs_K8": e8["max_abs"], "max_abs_K9": e9["max_abs"]}
    errs["max_abs"] = max(e8["max_abs"], e9["max_abs"])
    return errs, bad8 + bad9
