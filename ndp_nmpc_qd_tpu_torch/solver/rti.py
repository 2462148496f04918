"""SQP-RTI controller: the scan controller and the controllers on the
port's kernels.

Port of `ndp_nmpc_qd_tpu/solver/rti.py` (`RtiState`, `RtiInfo`,
`RtiController`, `unpack_iterates`, `make_rti_controller` and every backend
of `make_batched_rti_controller`: "jax", the scan controller; "pallas", the
structure-sparse kernels; "pallas_packed", the legacy dense kernels).
Semantics mirror the reference controller (`nmpc_ctl/nmpc_body_rate_ctl.py`):

- `reset(xr, ur)` seeds every shooting-node iterate with the reference and
  marks every scenario's QP duals cold (`mu = -1`), killing warm starts
  across trajectories.
- `update(state, x0, xr, ur, f_dist)` performs ONE real-time iteration per
  scenario: linearize at the iterates, solve the Gauss-Newton QP with the
  initial state pinned to x0, take the full step, return the first control
  clipped to the actuator box plus solver health.

With `packed_state=True` the iterates and carried duals live in kernel
layout (stage, element, B) and are updated IN PLACE by the step: `update`
returns the same tensors in its new state, and the state passed in must not
be used afterwards. `reset` copies the references for that reason, so the
caller's `xr`/`ur` are never written. The batch-first state
(`packed_state=False`) is not updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import const, resolve_device
from ..ops.layout import pack, unpack
from ..params import OcpParams, VehicleParams
from .ocp import make_ocp_functions
from .ocp_packed import make_ocp_functions_packed
from .ocp_sparse import make_linearizer, make_ocp_functions_sparse, make_whole_step
from .qp_ipm import solve_qp
from .qp_ipm_packed import ipm_packed
from .qp_ipm_sparse import IpmWarm, cold_warm, ipm_sparse


class RtiState(NamedTuple):
    """Shooting-node iterates: kernel layout x_bar (N+1, 10, B), u_bar
    (N, 4, B) with `packed_state=True`, batch-first (B, N+1, 10), (B, N, 4)
    otherwise. `ipm` (warm_start=True) carries the QP duals across ticks,
    (lu_lo, lu_up, lx_lo, lx_up, mu) in the same layout ((N, 4, B) or
    (B, N, 4) and so on; mu (B,)); mu < 0 marks a scenario cold."""

    x_bar: torch.Tensor
    u_bar: torch.Tensor
    ipm: tuple | None = None


class RtiInfo(NamedTuple):
    mu: torch.Tensor  # final IPM barrier weight per scenario
    eq_res: torch.Tensor  # final QP equality residual norm
    ok: torch.Tensor  # bool health flag


class RtiController(NamedTuple):
    reset: callable
    update: callable
    ocp: OcpParams
    vehicle: VehicleParams
    with_disturbance: bool
    layout: str = "batch"  # "kernel" with packed_state=True
    device: torch.device | None = None


def unpack_iterates(state: RtiState, B: int):
    """Kernel-layout RtiState -> batch-first (x_bar (B, N+1, 10), u_bar)."""
    return (
        unpack(state.x_bar, (state.x_bar.shape[1],))[:B],
        unpack(state.u_bar, (state.u_bar.shape[1],))[:B],
    )


def first_control_and_health(
    ocp: OcpParams, x_bar, u_bar, eq_res, eq_tol=1e-3, layout="kernel"
):
    """u0 (B, 4) clipped to the actuator box, and the health flag (B,):
    finite residual below eq_tol, the planned controls inside the box
    (tolerance 1e-4 of its range) and the planned velocities of nodes
    1..N-1 inside the v box (tolerance 1e-3 of its range). The iterates
    are in kernel layout, or batch-first with layout="batch"."""
    if layout == "batch":  # (B, s, d) -> (s, d, B) views
        x_bar, u_bar = x_bar.permute(1, 2, 0), u_bar.permute(1, 2, 0)
    dt, dev = u_bar.dtype, u_bar.device
    N = ocp.N_node
    box = lambda v: const(tuple(float(x) for x in v), dt, dev)
    u_lo, u_hi = box(ocp.u_lower()), box(ocp.u_upper())
    u0 = torch.clamp(u_bar[0].T, min=u_lo, max=u_hi)
    bound_tol = 1e-4 * (u_hi - u_lo)
    lo = (u_lo - bound_tol).view(1, 4, 1)
    hi = (u_hi + bound_tol).view(1, 4, 1)
    in_box = ((u_bar >= lo) & (u_bar <= hi)).all(dim=1).all(dim=0)
    v_lo, v_hi = box(ocp.v_lower()), box(ocp.v_upper())
    v_tol = 1e-3 * (v_hi - v_lo)
    v_plan = x_bar[1:N, 3:6]
    in_box &= (
        (v_plan >= (v_lo - v_tol).view(1, 3, 1))
        & (v_plan <= (v_hi + v_tol).view(1, 3, 1))
    ).all(dim=1).all(dim=0)
    return u0, torch.isfinite(eq_res) & (eq_res < eq_tol) & in_box


def _scan_update(ocp: OcpParams, linearize_horizon, qp_iters, eq_tol, mehrotra):
    """One RTI tick of the scan controller on a batch-first state."""

    def update(state: RtiState, x0, xr, ur, f_dist=None):
        qp = linearize_horizon(state.x_bar, state.u_bar, xr, ur, f_dist)
        dx0 = x0.to(state.x_bar.dtype) - state.x_bar[:, 0]
        sol = solve_qp(qp, dx0, num_iters=qp_iters, mehrotra=mehrotra)
        new_state = RtiState(state.x_bar + sol.dx, state.u_bar + sol.du)
        u0, ok = first_control_and_health(
            ocp, new_state.x_bar, new_state.u_bar, sol.eq_res, eq_tol, layout="batch")
        return u0, new_state, RtiInfo(mu=sol.mu, eq_res=sol.eq_res, ok=ok)

    return update


def make_rti_controller(
    ocp: OcpParams,
    vehicle: VehicleParams,
    *,
    with_disturbance: bool = False,
    qp_iters: int = 12,
    eq_tol: float = 1e-3,
    mehrotra: bool = False,
    device=None,
) -> RtiController:
    """The scan controller for one scenario: `reset(xr, ur)` and
    `update(state, x0, xr, ur, f_dist=None)` on unbatched tensors (x_bar
    (N+1, 10), u_bar (N, 4), x0 (10,)), as the JAX `make_rti_controller`.
    Plain tensor code (`ocp.make_ocp_functions`, `qp_ipm.solve_qp`; with
    `mehrotra` the predictor-corrector IPM), in the dtype of the state.
    Runs on `device`, by default the card."""
    dev = resolve_device(device)
    linearize_horizon, _ = make_ocp_functions(ocp, vehicle, with_disturbance)
    batched = _scan_update(ocp, linearize_horizon, qp_iters, eq_tol, mehrotra)

    def reset(xr, ur) -> RtiState:
        return RtiState(torch.as_tensor(xr, device=dev), torch.as_tensor(ur, device=dev))

    def update(state: RtiState, x0, xr, ur, f_dist=None):
        dt = state.x_bar.dtype
        one = lambda a: None if a is None else torch.as_tensor(a, dtype=dt, device=dev)[None]
        u0, st, info = batched(
            RtiState(state.x_bar[None], state.u_bar[None]), one(x0), one(xr), one(ur),
            one(f_dist) if with_disturbance else None,
        )
        return u0[0], RtiState(st.x_bar[0], st.u_bar[0]), RtiInfo(*(t[0] for t in info))

    return RtiController(reset, update, ocp, vehicle, with_disturbance, device=dev)


def make_batched_rti_controller(
    ocp: OcpParams,
    vehicle: VehicleParams,
    *,
    with_disturbance: bool = False,
    qp_iters: int = 12,
    eq_tol: float = 1e-3,
    backend: str = "auto",
    warm_start: bool = False,
    jac_bf16: bool = False,
    fused_lin: bool = True,
    lqr_start: bool = True,
    whole_ipm: bool = False,
    packed_state: bool = False,
    whole_step: bool = False,
    mehrotra: bool = False,
    device=None,
) -> RtiController:
    """Batch-first RTI controller. `backend` names the JAX package's:

    - "jax": the scan controller, `make_rti_controller` over the batch
      (plain tensor code; `mehrotra` selects the predictor-corrector IPM).
      The kernel flags do not apply to it and are ignored, as in JAX.
    - "pallas_packed": the legacy dense path, cold: the dense linearizer
      (`ocp_packed`) and `ipm_packed`, one K8 + K9 sweep for the
      clipped-LQR start and one per IPM iteration; batch-first state. It
      ignores `warm_start`, `jac_bf16`, `lqr_start` and `whole_ipm`, as in
      JAX, and refuses `packed_state`.
    - "pallas" (and "auto", which in the port always means the kernels):
      the structure-sparse kernels, below.

    - `packed_state=True, whole_step=True`: the whole step in one launch
      (K1), which implies the zero-control start, so `lqr_start` and
      `whole_ipm` do not change it.
    - `whole_step=False` (or `packed_state=False`, where the JAX package
      ignores `whole_step` too): the linearization (K3, or with
      `fused_lin=False` the tensor-op linearizer
      `ocp_sparse.make_ocp_functions_sparse`, which needs the batch-first
      state: `packed_state=True` with it raises ValueError), then with
      `whole_ipm=True` the whole IPM in one launch (K2), with the axpy
      folded into it when `packed_state=True`; with `whole_ipm=False` one
      glue-fused iteration (K4 + K5) per IPM iteration, from the clipped-LQR
      start (`lqr_start=True`: one K6 + K7 sweep with the zero-control
      fallback for the far regime) or the zero-control rollout
      (`lqr_start=False`).
    - `packed_state=True` keeps the state in kernel layout, updated in
      place; `packed_state=False` keeps it batch-first and packs the inputs
      and unpacks the deltas every tick. The port does not pad B.

    `warm_start` carries the QP duals across ticks; `jac_bf16` stores the
    curvature payloads in bfloat16.

    Runs on `device`, by default the card; without a card and without an
    explicit device it raises.
    """
    if backend not in ("auto", "pallas", "jax", "pallas_packed"):
        raise ValueError(f"unknown backend {backend!r}")
    if qp_iters < 1:
        raise ValueError(f"qp_iters must be >= 1, got {qp_iters}")
    dev = resolve_device(device)

    def as_input(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def reset_plain(xr, ur) -> RtiState:
        xr = torch.as_tensor(xr, device=dev)
        return RtiState(xr, torch.as_tensor(ur, device=dev).to(xr.dtype))

    if backend == "jax":
        linearize_horizon, _ = make_ocp_functions(ocp, vehicle, with_disturbance)
        scan = _scan_update(ocp, linearize_horizon, qp_iters, eq_tol, mehrotra)

        def update_scan(state: RtiState, x0, xr, ur, f_dist=None):
            dt = state.x_bar.dtype
            f_dist = as_input(f_dist, dt) if with_disturbance and f_dist is not None else None
            return scan(state, as_input(x0, dt), as_input(xr, dt), as_input(ur, dt), f_dist)

        return RtiController(reset_plain, update_scan, ocp, vehicle, with_disturbance,
                             device=dev)

    if backend == "pallas_packed":
        if packed_state:
            raise ValueError("packed_state requires the structure-sparse kernels "
                             "(backend='pallas')")
        linearize_dense, _ = make_ocp_functions_packed(ocp, vehicle, with_disturbance)

        def update_dense(state: RtiState, x0, xr, ur, f_dist=None):
            dt = state.x_bar.dtype
            f_dist = as_input(f_dist, dt) if with_disturbance and f_dist is not None else None
            qp, dx0_p = linearize_dense(state.x_bar, state.u_bar, as_input(xr, dt),
                                        as_input(ur, dt), f_dist, as_input(x0, dt))
            zx, zu, mu, eq = ipm_packed(qp, dx0_p, num_iters=qp_iters)
            new_state = RtiState(state.x_bar + unpack(zx, (zx.shape[1],)),
                                 state.u_bar + unpack(zu, (zu.shape[1],)))
            u0, ok = first_control_and_health(
                ocp, new_state.x_bar, new_state.u_bar, eq, eq_tol, layout="batch")
            return u0, new_state, RtiInfo(mu=mu, eq_res=eq, ok=ok)

        return RtiController(reset_plain, update_dense, ocp, vehicle, with_disturbance,
                             device=dev)

    if packed_state and not fused_lin:
        raise ValueError("packed_state requires the fused linearizer (fused_lin=True)")
    one_kernel = packed_state and whole_step
    N = ocp.N_node

    def reset_packed(xr, ur) -> RtiState:
        xr = torch.as_tensor(xr, device=dev)
        ur = torch.as_tensor(ur, device=dev)
        # `pack` copies, so the in-place steps never write the caller's xr/ur
        ipm0 = tuple(cold_warm(N, xr.shape[0], xr.dtype, dev)) if warm_start else None
        return RtiState(pack(xr), pack(ur.to(xr.dtype)), ipm0)

    if one_kernel:
        step = make_whole_step(
            ocp, vehicle, with_disturbance, jac_bf16=jac_bf16, num_iters=qp_iters
        )

        def update_one_kernel(state: RtiState, x0, xr, ur, f_dist=None):
            dt = state.x_bar.dtype
            x0 = as_input(x0, dt)
            B = x0.shape[0]
            warm = IpmWarm(*state.ipm) if warm_start else cold_warm(N, B, dt, dev)
            fd_p = None
            if with_disturbance:
                if f_dist is None:
                    fd_p = torch.zeros((N + 1, 3, B), dtype=dt, device=dev)
                else:
                    fd_p = pack(as_input(f_dist, dt))
            xb, ub = state.x_bar, state.u_bar
            eq = step(
                xb, ub, pack(as_input(xr, dt)), pack(as_input(ur, dt)), fd_p,
                pack(x0[:, None]), warm,
            )
            new_state = RtiState(xb, ub, tuple(warm) if warm_start else state.ipm)
            u0, ok = first_control_and_health(ocp, xb, ub, eq, eq_tol)
            return u0, new_state, RtiInfo(mu=warm.mu.clone(), eq_res=eq, ok=ok)

        return RtiController(
            reset_packed, update_one_kernel, ocp, vehicle, with_disturbance,
            layout="kernel", device=dev,
        )

    make_lin = make_linearizer if fused_lin else make_ocp_functions_sparse
    linearize, sp_consts = make_lin(ocp, vehicle, with_disturbance, jac_bf16=jac_bf16)[:2]

    def solve(qp, dx0_p, warm, xu_bar=None):
        return ipm_sparse(
            qp, sp_consts, dx0_p, num_iters=qp_iters, warm=warm, lqr_start=lqr_start,
            whole_kernel=whole_ipm, xu_bar=xu_bar,
        )

    def inputs(state, x0, xr, ur, f_dist):
        dt = state.x_bar.dtype
        return (as_input(x0, dt), as_input(xr, dt), as_input(ur, dt),
                as_input(f_dist, dt) if with_disturbance and f_dist is not None else None)

    if packed_state:

        def update_packed(state: RtiState, x0, xr, ur, f_dist=None):
            x0, xr, ur, f_dist = inputs(state, x0, xr, ur, f_dist)
            qp, dx0_p = linearize(state.x_bar, state.u_bar, xr, ur, f_dist, x0, packed_xu=True)
            warm = IpmWarm(*state.ipm) if warm_start else None
            xb, ub, mu, eq, new_warm = solve(qp, dx0_p, warm, xu_bar=(state.x_bar, state.u_bar))
            new_state = RtiState(xb, ub, tuple(new_warm) if warm_start else state.ipm)
            u0, ok = first_control_and_health(ocp, xb, ub, eq, eq_tol)
            return u0, new_state, RtiInfo(mu=mu.clone(), eq_res=eq, ok=ok)

        return RtiController(
            reset_packed, update_packed, ocp, vehicle, with_disturbance,
            layout="kernel", device=dev,
        )

    def reset_batch(xr, ur) -> RtiState:
        xr = torch.as_tensor(xr, device=dev)
        ur = torch.as_tensor(ur, device=dev).to(xr.dtype)
        ipm0 = None
        if warm_start:
            B, dt = xr.shape[0], xr.dtype
            z = lambda *s: torch.zeros(s, dtype=dt, device=dev)
            ipm0 = (z(B, N, 4), z(B, N, 4), z(B, N + 1, 3), z(B, N + 1, 3),
                    torch.full((B,), -1.0, dtype=dt, device=dev))
        return RtiState(xr, ur, ipm0)

    def update_batch(state: RtiState, x0, xr, ur, f_dist=None):
        x0, xr, ur, f_dist = inputs(state, x0, xr, ur, f_dist)
        qp, dx0_p = linearize(state.x_bar, state.u_bar, xr, ur, f_dist, x0)
        warm = None
        if warm_start:
            lul, luu, lxl, lxu, mu_c = state.ipm
            # `pack` copies: the whole-IPM kernel updates the duals in place
            warm = IpmWarm(pack(lul), pack(luu), pack(lxl), pack(lxu), mu_c.clone())
        zx, zu, mu, eq, new_warm = solve(qp, dx0_p, warm)
        ipm_new = state.ipm
        if warm_start:
            ipm_new = (
                unpack(new_warm.lu_lo, (4,)), unpack(new_warm.lu_up, (4,)),
                unpack(new_warm.lx_lo, (3,)), unpack(new_warm.lx_up, (3,)), new_warm.mu,
            )
        new_state = RtiState(
            state.x_bar + unpack(zx, (zx.shape[1],)),
            state.u_bar + unpack(zu, (zu.shape[1],)), ipm_new,
        )
        u0, ok = first_control_and_health(
            ocp, new_state.x_bar, new_state.u_bar, eq, eq_tol, layout="batch"
        )
        return u0, new_state, RtiInfo(mu=mu.clone(), eq_res=eq, ok=ok)

    return RtiController(
        reset_batch, update_batch, ocp, vehicle, with_disturbance, layout="batch",
        device=dev,
    )
