"""Box-constrained time-varying LQR solve: a Riccati recursion inside a
primal-dual interior-point method, and the interior-point helpers the QP
solvers share.

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm.py`:
- the scan path (`QpSolution`, `riccati_solve`, `_IpmState`, `solve_qp`:
  the clipped-LQR start with its per-scenario zero-control fallback, the
  fixed-sigma step and the Mehrotra predictor-corrector). The JAX package
  solves one scenario per call and vmaps; here the scenario batch is a
  leading dimension written out (one scenario without it), every scalar of
  the JAX version is a (B,) tensor, and its `lax.scan`s over the stages and
  the iterations are Python loops. It is plain tensor code, as the JAX scan
  path has no Pallas kernel; the small stage products are batched matmuls
  in full f32 (`torch.backends.cuda.matmul.allow_tf32` stays False);
- the elementwise building blocks (`ipm_slack_init`, `ipm_corr_terms`,
  `ipm_corr_from_rc`, `ipm_max_step`). The slack start is the formula the
  kernels use per element (`ops/kernels/ipm_whole.slack_init_pair`: the
  distance to the bound where feasible, its magnitude where violated,
  floored at a range-scaled minimum); on tensors it applies elementwise.

`ipm_corr_terms` keeps the reference's divides: the unfused IPM
(`ipm_sparse(fuse_glue=False)`) rounds as the JAX version does, where the
kernels' `glue_pair` multiplies by one shared reciprocal per slack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.kernels.ipm_whole import slack_init_pair as ipm_slack_init
from .ocp import BX, QpData

__all__ = [
    "QpSolution", "ipm_corr_from_rc", "ipm_corr_terms", "ipm_max_step", "ipm_slack_init",
    "riccati_solve", "solve_qp",
]


class QpSolution(NamedTuple):
    dx: torch.Tensor  # (B, N+1, nx)
    du: torch.Tensor  # (B, N, nu)
    mu: torch.Tensor  # (B,) final complementarity measure
    eq_res: torch.Tensor  # (B,) final dynamics-defect norm


def _mv(M, v):
    """Batched matrix-vector product: M (..., n, m), v (..., m)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """M^T v: M (..., m, n), v (..., m) -> (..., n)."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _one_scenario(qp: QpData, *tensors):
    """A single scenario's QP and tensors as a batch of one (None stays)."""
    return (QpData(*(t[None] for t in qp)),) + tuple(
        None if t is None else t[None] for t in tensors)


def ipm_corr_terms(v, lo, hi, s_lo, s_up, l_lo, l_up, mu):
    """Newton elimination of a two-sided bound's slacks and duals: returns
    (sig, corr, r_lo, r_up, rc_lo, rc_up), the diagonal Hessian addition,
    the gradient correction and the residuals the direction recovery
    needs."""
    r_lo = v - lo - s_lo
    r_up = hi - v - s_up
    rc_lo = s_lo * l_lo - mu
    rc_up = s_up * l_up - mu
    sig = l_lo / s_lo + l_up / s_up
    corr = ipm_corr_from_rc(rc_lo, rc_up, r_lo, r_up, s_lo, s_up, l_lo, l_up)
    return sig, corr, r_lo, r_up, rc_lo, rc_up


def ipm_corr_from_rc(rc_lo, rc_up, r_lo, r_up, s_lo, s_up, l_lo, l_up):
    """Gradient correction of the slack elimination for given
    complementarity residuals rc."""
    return (
        -l_lo + l_up
        + (rc_lo + l_lo * r_lo) / s_lo
        - (rc_up + l_up * r_up) / s_up
    )


def ipm_max_step(v, dv, tau, dims=None):
    """Largest a in (0, 1] with v + a dv >= (1 - tau) v, reduced over
    `dims` (None: all). NaN propagates."""
    neg = dv < 0
    ratio = torch.where(neg, -tau * v / torch.where(neg, dv, torch.full_like(dv, -1.0)),
                        torch.full_like(dv, float("inf")))
    m = torch.amin(ratio) if dims is None else torch.amin(ratio, dim=dims)
    return torch.clamp(m, max=1.0)


def riccati_solve(
    qp: QpData, sig_u, sig_x_b, ghat_x, ghat_u, rhat, dx0_res, clip_lo=None, clip_hi=None,
):
    """Exact solve of the equality-constrained tv-LQR Newton system.

    Args (batch-first, or one scenario without the leading B):
      qp: stage data (uses Hxx/Hxu/Huu/A/B only).
      sig_u: (B, N, nu) diagonal barrier addition to Huu.
      sig_x_b: (B, N+1, n_bx) diagonal barrier addition to the bounded
        state components (added to Hxx's diagonal at BX_IDX).
      ghat_x/ghat_u: modified gradients.
      rhat: (B, N, nx) dynamics defects at the current IPM iterate.
      dx0_res: (B, nx) initial-state residual.
      clip_lo/clip_hi: optional (B, N, nu) control boxes applied during the
        forward rollout (the clipped-LQR start; NaN propagates). None for
        exact Newton directions.
    Returns (delta_x (B, N+1, nx), delta_u (B, N, nu)).

    The recursion is JAX's, with each stage's products batched: T = P
    [A B r] (its last column plus p is P r + p), then [A B]^T T stacked on
    [[Hxx, Hxu, ghat_x], [Hxu^T, Huu, ghat_u]] gives Qh, S, Rh, qv and rv in
    one block; the 4x4 block Rh is factored by `torch.linalg.cholesky_ex`
    (no host synchronisation) and [S rv] solved by two triangular solves,
    as `cho_solve`; a scenario whose factorization fails anywhere gets NaN
    directions, as the JAX Cholesky's NaN would give it.
    """
    if dx0_res.dim() == 1:
        out = riccati_solve(*_one_scenario(
            qp, sig_u, sig_x_b, ghat_x, ghat_u, rhat, dx0_res, clip_lo, clip_hi))
        return tuple(t[0] for t in out)
    N, nx = qp.A.shape[-3], qp.A.shape[-2]
    nu = qp.B.shape[-1]
    Hxx = qp.Hxx.clone()
    Hxx.diagonal(dim1=-2, dim2=-1)[..., BX] += sig_x_b
    Huu = qp.Huu + torch.diag_embed(sig_u)
    # per stage: [A B r] (nx x (nx + nu + 1)) and [[Hxx Hxu gx] [Hxu^T Huu gu]]
    # ((nx + nu) x (nx + nu + 1)); nx is 10, or 13 for the motor-thrust OCP
    ABr = torch.cat([qp.A, qp.B, rhat[..., None]], dim=-1)
    Hg = torch.cat([
        torch.cat([Hxx[:, :N], qp.Hxu, ghat_x[:, :N, :, None]], dim=-1),
        torch.cat([qp.Hxu.transpose(-1, -2), Huu, ghat_u[..., None]], dim=-1),
    ], dim=-2)

    # ---- backward Riccati sweep ----
    P, p = Hxx[:, N], ghat_x[:, N]
    X = [None] * N  # Rh^-1 [S . rv]: the gains K = -X[:, :, :nx], k = -X[:, :, -1]
    info = [None] * N
    for i in reversed(range(N)):
        T = P @ ABr[:, i]
        T[..., -1].add_(p)  # P r + p
        Z = torch.baddbmm(Hg[:, i], ABr[:, i, :, :nx + nu].transpose(-1, -2), T)
        L, info[i] = torch.linalg.cholesky_ex(Z[:, nx:, nx:nx + nu])
        y = torch.linalg.solve_triangular(L, Z[:, nx:], upper=False)
        X[i] = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        W = torch.baddbmm(Z[:, :nx], Z[:, nx:, :nx].transpose(-1, -2), X[i], alpha=-1.0)
        P = 0.5 * (W[..., :nx] + W[..., :nx].transpose(-1, -2))
        p = W[..., -1]

    # ---- forward rollout ----
    dx = dx0_res
    dxs, dus = [dx], []
    for i in range(N):
        du = torch.baddbmm(X[i][..., -1:], X[i][..., :nx], dx[..., None], alpha=-1.0,
                           beta=-1.0)[..., 0]
        if clip_lo is not None:
            du = torch.minimum(torch.maximum(du, clip_lo[:, i]), clip_hi[:, i])
        dx = torch.baddbmm(torch.baddbmm(rhat[:, i, :, None], qp.A[:, i], dx[..., None]),
                           qp.B[:, i], du[..., None])[..., 0]
        dxs.append(dx)
        dus.append(du)
    dx, du = torch.stack(dxs, dim=1), torch.stack(dus, dim=1)
    nan = torch.full((), float("nan"), dtype=dx.dtype, device=dx.device)
    bad = (torch.stack(info) != 0).any(dim=0)[:, None, None]
    return torch.cat([dx[:, :1], torch.where(bad, nan, dx[:, 1:])], dim=1), torch.where(
        bad, nan, du)


class _IpmState(NamedTuple):
    zx: torch.Tensor  # (B, N+1, nx) primal state deltas
    zu: torch.Tensor  # (B, N, nu) primal control deltas
    su_lo: torch.Tensor
    su_up: torch.Tensor
    sx_lo: torch.Tensor
    sx_up: torch.Tensor
    lu_lo: torch.Tensor
    lu_up: torch.Tensor
    lx_lo: torch.Tensor
    lx_up: torch.Tensor
    mu: torch.Tensor  # (B,)


def _sum(t):
    """Sum over everything but the leading scenario axis."""
    return t.reshape(t.shape[0], -1).sum(dim=1)


def _bc(t):
    """A per-scenario (B,) value broadcast against (B, s, d) tensors."""
    return t[:, None, None]


def solve_qp(
    qp: QpData,
    dx0: torch.Tensor,
    *,
    num_iters: int = 12,
    sigma: float = 0.1,
    tau: float = 0.95,
    mu_init: float = 1.0,
    s_min: float = 1e-3,
    mu_min: float = 1e-12,
    mehrotra: bool = False,
) -> QpSolution:
    """Primal-dual IPM for the box-constrained OCP QP, each scenario of the
    batch on its own (its step lengths, barrier weight and start are its
    own), as the JAX `solve_qp` under vmap.

    Bounds: lu <= zu <= uu per stage; lx <= zx[:, (3,4,5)] <= ux per node
    (masked +-BIG entries are handled naturally: their barrier terms
    vanish). qp batch-first with dx0 (B, nx), or one scenario with dx0
    (nx,).

    The start is the clipped-LQR rollout (one zero-barrier Riccati sweep,
    controls clipped into the box less a 1e-3 margin), dynamics-exact; where
    its velocities leave their box (initial states far from the reference)
    the scenario starts instead from the zero-control rollout, which is
    dynamics-exact and strictly interior in both boxes, so the IPM walks a
    feasible path toward the saturated optimum (the JAX module's far-regime
    note, `qp_ipm.py:255-276`).

    `mehrotra=True` runs each iteration as a predictor-corrector pair (two
    Riccati solves sharing the barrier diagonals): the affine predictor sets
    the centering weight sigma = (mu_aff / mu)^3, the corrector compensates
    the ds*dl term scaled by the realized affine step lengths, and the
    fraction-to-boundary tau adapts in [tau, 0.99].
    """
    if dx0.dim() == 1:
        q1, d1 = _one_scenario(qp, dx0)
        sol = solve_qp(q1, d1, num_iters=num_iters, sigma=sigma, tau=tau, mu_init=mu_init,
                       s_min=s_min, mu_min=mu_min, mehrotra=mehrotra)
        return QpSolution(*(t[0] for t in sol))
    Bsz, N, nu = qp.gu.shape
    nxp1, n_bx = qp.lx.shape[1:]
    dtype, dev = qp.gx.dtype, qp.gx.device
    dx0 = dx0.to(dtype)

    def interior(lo, hi, v):
        return ipm_slack_init(lo, hi, v, s_min)

    # clipped-LQR start, with the per-scenario zero-control fallback
    margin = 1e-3 * (qp.uu - qp.lu)
    zx_lqr, zu_lqr = riccati_solve(
        qp, torch.zeros_like(qp.gu), torch.zeros_like(qp.lx), qp.gx, qp.gu, qp.r, dx0,
        clip_lo=qp.lu + margin, clip_hi=qp.uu - margin,
    )
    z = dx0
    hold = [z]
    for i in range(N):
        z = _mv(qp.A[:, i], z) + qp.r[:, i]
        hold.append(z)
    zx_hold = torch.stack(hold, dim=1)
    v_lqr = zx_lqr[..., BX]
    v_feasible = ((v_lqr >= qp.lx) & (v_lqr <= qp.ux)).reshape(Bsz, -1).all(dim=1)
    zx0 = torch.where(_bc(v_feasible), zx_lqr, zx_hold)
    zu0 = torch.where(_bc(v_feasible), zu_lqr, torch.zeros_like(zu_lqr))
    su_lo0, su_up0 = interior(qp.lu, qp.uu, zu0)
    sx_lo0, sx_up0 = interior(qp.lx, qp.ux, zx0[..., BX])
    mu0 = torch.full((Bsz,), mu_init, dtype=dtype, device=dev)
    st = _IpmState(
        zx0, zu0, su_lo0, su_up0, sx_lo0, sx_up0,
        mu_init / su_lo0, mu_init / su_up0, mu_init / sx_lo0, mu_init / sx_up0, mu0,
    )
    n_cons = 2 * N * nu + 2 * nxp1 * n_bx

    def lin_terms(st: _IpmState):
        """Objective gradient at the iterate and the dynamics defects."""
        gx_lin = qp.gx + _mv(qp.Hxx, st.zx) + torch.cat(
            [_mv(qp.Hxu, st.zu), torch.zeros_like(qp.gx[:, :1])], dim=1)
        gu_lin = qp.gu + _mtv(qp.Hxu, st.zx[:, :N]) + _mv(qp.Huu, st.zu)
        rhat = _mv(qp.A, st.zx[:, :N]) + _mv(qp.B, st.zu) + qp.r - st.zx[:, 1:]
        return gx_lin, gu_lin, rhat, dx0 - st.zx[:, 0]

    def with_v(gx, corr_x):
        """gx with corr_x added to its bounded (velocity) components."""
        return torch.cat([gx[..., :3], gx[..., BX] + corr_x, gx[..., 6:]], dim=-1)

    def directions(st, d_zx, d_zu, ru_lo, ru_up, rx_lo, rx_up, rcu_lo, rcu_up, rcx_lo, rcx_up):
        """Slack/dual Newton directions from the elimination identities."""
        d_vx = d_zx[..., BX]
        dsu_lo, dsu_up = d_zu + ru_lo, -d_zu + ru_up
        dsx_lo, dsx_up = d_vx + rx_lo, -d_vx + rx_up
        dlu_lo = -(rcu_lo + st.lu_lo * dsu_lo) / st.su_lo
        dlu_up = -(rcu_up + st.lu_up * dsu_up) / st.su_up
        dlx_lo = -(rcx_lo + st.lx_lo * dsx_lo) / st.sx_lo
        dlx_up = -(rcx_up + st.lx_up * dsx_up) / st.sx_up
        return (dsu_lo, dsu_up, dsx_lo, dsx_up), (dlu_lo, dlu_up, dlx_lo, dlx_up)

    def max_step(vs, dvs, tau_):
        return torch.stack([ipm_max_step(v, d, tau_, dims=(1, 2))
                            for v, d in zip(vs, dvs)]).amin(dim=0)

    def advance(st, a_p, a_d, d_zx, d_zu, ds, dl):
        a_p, a_d = _bc(a_p), _bc(a_d)
        return _IpmState(
            st.zx + a_p * d_zx, st.zu + a_p * d_zu,
            *(s + a_p * d for s, d in zip(st[2:6], ds)),
            *(l + a_d * d for l, d in zip(st[6:10], dl)),
            st.mu,
        )

    def comp_of(st):
        return sum(_sum(s * l) for s, l in zip(st[2:6], st[6:10])) / n_cons

    def step(st: _IpmState) -> _IpmState:
        mu = _bc(st.mu)
        sig_u, corr_u, ru_lo, ru_up, rcu_lo, rcu_up = ipm_corr_terms(
            st.zu, qp.lu, qp.uu, st.su_lo, st.su_up, st.lu_lo, st.lu_up, mu)
        sig_x, corr_x, rx_lo, rx_up, rcx_lo, rcx_up = ipm_corr_terms(
            st.zx[..., BX], qp.lx, qp.ux, st.sx_lo, st.sx_up, st.lx_lo, st.lx_up, mu)
        gx_lin, gu_lin, rhat, dx0_res = lin_terms(st)
        d_zx, d_zu = riccati_solve(
            qp, sig_u, sig_x, with_v(gx_lin, corr_x), gu_lin + corr_u, rhat, dx0_res)
        ds, dl = directions(st, d_zx, d_zu, ru_lo, ru_up, rx_lo, rx_up,
                            rcu_lo, rcu_up, rcx_lo, rcx_up)
        new = advance(st, max_step(st[2:6], ds, tau), max_step(st[6:10], dl, tau),
                      d_zx, d_zu, ds, dl)
        return new._replace(mu=torch.clamp(sigma * comp_of(new), min=mu_min))

    def step_mehrotra(st: _IpmState) -> _IpmState:
        vx = st.zx[..., BX]
        ru_lo, ru_up = st.zu - qp.lu - st.su_lo, qp.uu - st.zu - st.su_up
        rx_lo, rx_up = vx - qp.lx - st.sx_lo, qp.ux - vx - st.sx_up
        sig_u = st.lu_lo / st.su_lo + st.lu_up / st.su_up
        sig_x = st.lx_lo / st.sx_lo + st.lx_up / st.sx_up
        gx_lin, gu_lin, rhat, dx0_res = lin_terms(st)

        def solve_with_rc(rcu_lo, rcu_up, rcx_lo, rcx_up):
            corr_u = ipm_corr_from_rc(rcu_lo, rcu_up, ru_lo, ru_up, st.su_lo, st.su_up,
                                      st.lu_lo, st.lu_up)
            corr_x = ipm_corr_from_rc(rcx_lo, rcx_up, rx_lo, rx_up, st.sx_lo, st.sx_up,
                                      st.lx_lo, st.lx_up)
            d_zx, d_zu = riccati_solve(
                qp, sig_u, sig_x, with_v(gx_lin, corr_x), gu_lin + corr_u, rhat, dx0_res)
            ds, dl = directions(st, d_zx, d_zu, ru_lo, ru_up, rx_lo, rx_up,
                                rcu_lo, rcu_up, rcx_lo, rcx_up)
            return d_zx, d_zu, ds, dl

        s_all, l_all = st[2:6], st[6:10]
        # affine predictor (pure Newton, mu = 0)
        _, _, ds_a, dl_a = solve_with_rc(*(s * l for s, l in zip(s_all, l_all)))
        a_p_aff = max_step(s_all, ds_a, 1.0)
        a_d_aff = max_step(l_all, dl_a, 1.0)
        comp_now = comp_of(st)
        comp_aff = sum(
            _sum((s + _bc(a_p_aff) * ds) * (l + _bc(a_d_aff) * dl))
            for s, ds, l, dl in zip(s_all, ds_a, l_all, dl_a)
        ) / n_cons
        sig_dyn = torch.clamp((comp_aff / torch.clamp(comp_now, min=mu_min)) ** 3, 0.0, 1.0)
        mu_t = _bc(torch.clamp(sig_dyn * comp_now, min=mu_min))
        # corrector: centering + the second-order term at the realized
        # affine step lengths
        rc_corr = tuple(
            s * l - mu_t + (_bc(a_p_aff) * ds) * (_bc(a_d_aff) * dl)
            for s, l, ds, dl in zip(s_all, l_all, ds_a, dl_a)
        )
        d_zx, d_zu, ds_c, dl_c = solve_with_rc(*rc_corr)
        # adaptive fraction-to-boundary, capped: tau -> 1 crushes slacks to
        # denormals and NaNs the next iteration's l/s diagonals
        tau_k = _bc(torch.clamp(1.0 - comp_now, tau, 0.99))
        new = advance(st, max_step(s_all, ds_c, tau_k), max_step(l_all, dl_c, tau_k),
                      d_zx, d_zu, ds_c, dl_c)
        return new._replace(mu=torch.clamp(comp_of(new), min=mu_min))

    for _ in range(num_iters):
        st = step_mehrotra(st) if mehrotra else step(st)

    eq = _mv(qp.A, st.zx[:, :N]) + _mv(qp.B, st.zu) + qp.r - st.zx[:, 1:]
    eq_res = torch.sqrt(_sum(eq ** 2) + _sum((dx0 - st.zx[:, 0]) ** 2))
    return QpSolution(st.zx, st.zu, st.mu, eq_res)
