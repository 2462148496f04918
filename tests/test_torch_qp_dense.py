"""PyTorch port vs JAX: the dense QP solvers (`solver/qp_ipm.solve_qp`, the
scan path, and `solver/qp_ipm_packed.solve_qp_packed`, the legacy packed
path on the plain K8/K9), on the CPU.

- `solve_qp` against the vmapped JAX `solve_qp` in f64, plain and
  `mehrotra=True`, on a batch of nominal, active-bound (a setpoint 30 m /
  -25 m away) and far (20-30 m, where the clipped-LQR start leaves the
  velocity box and the per-scenario zero-control start is taken)
  scenarios: the same algorithm, rounded in another order, so rtol 1e-8
  (eq_res, rounding noise at dynamics-exact iterates, above 1e-12).
- `solve_qp` against the independent dense SLSQP solve of
  `tests/helpers_dense_qp.py` at `tests/test_qp.py`'s atol 2e-6 (30
  iterations), one scenario without the batch axis.
- `solve_qp_packed` against the vmapped JAX `solve_qp` in f32 at 1e-4 in
  the nominal regime, `tests/test_pallas_riccati.py`'s own reference and
  tolerance for the packed IPM (which has no far-regime fallback).

The QP data is the port's dense linearization at hover references (itself
held against JAX in `test_torch_ocp_dense.py`), inputs made with numpy from
a seed; both packages get the same arrays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_dense_qp import solve_dense
from ndp_nmpc_qd_tpu.solver.ocp import QpData as JQpData
from ndp_nmpc_qd_tpu.solver.qp_ipm import solve_qp as j_solve_qp
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp import QpData, make_ocp_functions
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm import riccati_solve, solve_qp
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_packed import solve_qp_packed

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hover_qps(kinds, seed, dtype=torch.float64):
    """One QP per kind, linearized at its hover reference (x_bar = xr,
    u_bar = ur): "nominal" (reference at (0, 0, 1), x0 off by 0.3 in
    position/velocity, 0.05 in attitude), "active" (reference moved by
    (30, -25) m, x0 off by 2.0), "far" (x0 20-30 m from the reference
    along x). Returns (QpData (B, ...), dx0 (B, 10))."""
    rng = np.random.default_rng(seed)
    B = len(kinds)
    xr = np.zeros((B, N + 1, 10))
    xr[..., 2] = 1.0
    xr[..., 6] = 1.0
    dx0 = np.zeros((B, 10))
    for i, kind in enumerate(kinds):
        if kind == "far":
            dx0[i, 0] = rng.uniform(20.0, 30.0)
            continue
        if kind == "active":
            xr[i, :, 0] += 30.0
            xr[i, :, 1] -= 25.0
        dx0[i, :6] = rng.standard_normal(6) * (2.0 if kind == "active" else 0.3)
        dx0[i, 6:10] = rng.standard_normal(4) * 0.05
    ur = np.zeros((B, N, 4))
    ur[..., 3] = CFG.vehicle.gravity
    lin, _ = make_ocp_functions(CFG.ocp, CFG.vehicle, False)
    T = lambda a: torch.tensor(a, dtype=dtype)
    return lin(T(xr), T(ur), T(xr), T(ur)), T(dx0)


def jax_qp(qp):
    return JQpData(*(jnp.asarray(t.numpy()) for t in qp))


@pytest.mark.parametrize("mehrotra", [False, True])
def test_solve_qp_matches_jax_f64(mehrotra):
    kinds = ["nominal", "nominal", "active", "active", "far", "far"]
    qp, dx0 = hover_qps(kinds, 0)
    want = jax.jit(jax.vmap(functools.partial(j_solve_qp, num_iters=12, mehrotra=mehrotra)))(
        jax_qp(qp), dx0.numpy())
    got = solve_qp(qp, dx0, num_iters=12, mehrotra=mehrotra)
    for name, g, r in zip(got._fields, got, want):
        r = torch.tensor(np.asarray(r))
        assert g.shape == r.shape, name
        # the iterates are dynamics-exact, so eq_res is rounding noise
        # (1e-16 to 3e-14) in both packages: held above a 1e-12 floor
        scale = max(1.0, float(r.abs().max()))
        atol = {"dx": 1e-10 * scale, "du": 1e-10 * scale, "eq_res": 1e-12}.get(name, 0.0)
        torch.testing.assert_close(g, r, rtol=1e-8, atol=atol, msg=name)
    # the far scenarios are solved from the zero-control start: their
    # clipped-LQR start leaves the velocity box, the nominal ones' does not
    margin = 1e-3 * (qp.uu - qp.lu)
    zx, _ = riccati_solve(qp, torch.zeros_like(qp.gu), torch.zeros_like(qp.lx), qp.gx, qp.gu,
                          qp.r, dx0, clip_lo=qp.lu + margin, clip_hi=qp.uu - margin)
    v = zx[..., 3:6]
    feasible = ((v >= qp.lx) & (v <= qp.ux)).flatten(1).all(dim=1)
    assert feasible[:2].all() and not feasible[4:].any(), feasible
    assert bool(torch.isfinite(got.du).all()) and float(got.eq_res.max()) < 1e-3


def test_solve_qp_matches_dense_reference():
    qp, dx0 = hover_qps(["nominal", "active"], 1)
    for i in range(2):
        one = QpData(*(t[i] for t in qp))
        sol = solve_qp(one, dx0[i], num_iters=30)
        dx_ref, du_ref = solve_dense(one._replace(**{
            f: t.numpy() for f, t in one._asdict().items()}), dx0[i].numpy())
        assert float(sol.eq_res) < 1e-8
        np.testing.assert_allclose(sol.du.numpy(), du_ref, atol=2e-6)
        np.testing.assert_allclose(sol.dx.numpy(), dx_ref, atol=2e-6)


def test_packed_ipm_matches_jax_solve_qp():
    B = 16
    rng = np.random.default_rng(2)
    qp, _ = hover_qps(["nominal"] * B, 2, torch.float32)
    dx0 = np.zeros((B, 10), np.float32)
    dx0[:, 0:3] = rng.uniform(-3.0, 3.0, (B, 3))
    sol = solve_qp_packed(qp, torch.tensor(dx0), num_iters=6)
    want = jax.jit(jax.vmap(functools.partial(j_solve_qp, num_iters=6)))(jax_qp(qp), dx0)
    np.testing.assert_allclose(sol.du.numpy(), np.asarray(want.du), atol=1e-4)
    np.testing.assert_allclose(sol.eq_res.numpy(), np.asarray(want.eq_res), atol=1e-4)
    assert sol.dx.shape == (B, N + 1, 10) and sol.mu.shape == (B,)
