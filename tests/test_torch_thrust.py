"""PyTorch port vs JAX: the motor-thrust NMPC (13 states, 4 rotor thrusts).

Inputs from numpy seeds; f64 throughout, as `test_thrust_model.py` runs.
- The allocation matrix and the hover equilibrium
  (`test_thrust_model.py:36-56`: the wrench at hover thrust m g and zero
  torques at 1e-12; the matrix invertible; a differential pair a pure
  moment), the matrix equal to JAX's.
- `thrust_dynamics`, its closed-form Jacobian and the RK4 step's A and B
  (`ocp.rk4_with_tangents`) against JAX's function and `jax.jacfwd`, at
  rtol 1e-12 / atol 1e-12 on 64 random states and thrusts.
- `linearize_horizon`'s QpData against JAX's, field by field, at rtol 1e-10
  / atol 1e-10 (the GN Hessian's products round in another order).
- The controller tick by tick against JAX over 50 ticks of the hover
  recovery (`test_thrust_model.py:70-90`'s case): u0 and the plant state at
  atol 1e-8, `ok` equal every tick.
The episode and the CLI mission: `test_torch_thrust_episode.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models.quadrotor_thrust import thrust_allocation_matrix as j_alloc
from ndp_nmpc_qd_tpu.models.quadrotor_thrust import thrust_dynamics as j_dyn
from ndp_nmpc_qd_tpu.ops.integrators import make_discrete_dynamics as j_discrete
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.solver.ocp_thrust import make_thrust_ocp_functions as j_ocp
from ndp_nmpc_qd_tpu.solver.ocp_thrust import make_thrust_rti_controller as j_ctl
from ndp_nmpc_qd_tpu_torch.models.quadrotor_thrust import (
    hover_thrust, rotor_thrust_bounds, thrust_allocation_matrix, thrust_dynamics,
    thrust_jacobian,
)
from ndp_nmpc_qd_tpu_torch.ops.integrators import make_discrete_dynamics
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp import rk4_with_tangents
from ndp_nmpc_qd_tpu_torch.solver.ocp_thrust import (
    make_thrust_ocp_functions, make_thrust_rti_controller,
)

CFG = NdpNmpcConfig()
VEH, OCP = CFG.vehicle, CFG.ocp
JCFG = JaxConfig()
N = OCP.N_node


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops at B=1: intra-op threads only add overhead and take the
    CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x13(pos):
    x = np.zeros(13)
    x[0:3], x[6] = pos, 1.0
    return x


def random_states(rng, B):
    """States near hover at random attitudes, velocities and body rates,
    and thrusts around hover (numpy, f64)."""
    x = np.zeros((B, 13))
    x[:, 0:3] = rng.uniform(-2, 2, (B, 3))
    x[:, 3:6] = rng.uniform(-1, 1, (B, 3))
    q = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((B, 4))
    x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 10:13] = rng.uniform(-1, 1, (B, 3))
    u = hover_thrust(VEH) + 0.5 * rng.standard_normal((B, 4))
    f = 0.3 * rng.standard_normal((B, 3))
    return x, u, f


def test_allocation_matrix_physics():
    A = thrust_allocation_matrix(VEH).numpy()
    np.testing.assert_allclose(A, np.asarray(j_alloc(JCFG.vehicle)), rtol=1e-15, atol=0)
    h = hover_thrust(VEH)
    w = A @ np.full(4, h)
    np.testing.assert_allclose(w[0], VEH.mass * VEH.gravity, rtol=1e-12)
    np.testing.assert_allclose(w[1:], 0.0, atol=1e-12)
    assert abs(np.linalg.det(A)) > 1e-12
    dw = A @ np.asarray([1.0, 1.0, -1.0, -1.0])
    assert dw[0] == 0.0 and abs(dw[3]) > 0  # the yaw pair


def test_hover_equilibrium():
    x = torch.as_tensor(x13([0.0, 0.0, 1.0]))
    u = torch.full((4,), hover_thrust(VEH), dtype=torch.float64)
    torch.testing.assert_close(thrust_dynamics(x, u, veh=VEH), torch.zeros(13, dtype=torch.float64),
                               rtol=0, atol=1e-12)


def test_dynamics_and_jacobians_match_jax():
    x, u, f = random_states(np.random.default_rng(3), 64)
    jv = JCFG.vehicle
    tx, tu, tf = (torch.as_tensor(a) for a in (x, u, f))
    close = lambda got, ref: np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                                        rtol=1e-12, atol=1e-12)
    phi = j_discrete(lambda xx, uu, fd: j_dyn(xx, uu, fd, veh=jv), OCP.th_pred,
                     OCP.erk_substeps)

    @jax.jit
    def reference(x, u, f):
        jac = jax.vmap(jax.jacfwd(lambda z, fd: j_dyn(z[:13], z[13:], fd, veh=jv)))(
            jnp.concatenate([x, u], axis=1), f)
        return (j_dyn(x, u, f, veh=jv), jac, jax.vmap(phi)(x, u, f),
                jax.vmap(jax.jacfwd(phi, argnums=0))(x, u, f),
                jax.vmap(jax.jacfwd(phi, argnums=1))(x, u, f))

    xdot, jac, x_next_j, A, Bm = reference(x, u, f)
    close(thrust_dynamics(tx, tu, tf, veh=VEH), xdot)
    close(thrust_jacobian(tx, tu, VEH), jac)
    x_next, A_t, B_t = rk4_with_tangents(
        lambda xx, uu, fd: thrust_dynamics(xx, uu, fd, veh=VEH),
        lambda xx, uu: thrust_jacobian(xx, uu, VEH), tx, tu, tf, OCP.th_pred, OCP.erk_substeps)
    close(x_next, x_next_j)
    close(A_t, A)
    close(B_t, Bm)


def test_linearize_horizon_matches_jax():
    rng = np.random.default_rng(5)
    xb, ub, _ = random_states(rng, N + 1)
    ub = ub[:N]
    xr = np.tile(x13([0.0, 0.0, 1.0]), (N + 1, 1))
    xr[:, 10:13] = 0.2 * rng.standard_normal((N + 1, 3))
    ur = np.full((N, 4), hover_thrust(VEH))
    f = 0.3 * rng.standard_normal((N + 1, 3))
    lin_j, _ = j_ocp(JCFG.ocp, JCFG.vehicle)
    lin_t, _ = make_thrust_ocp_functions(OCP, VEH)
    qj = jax.jit(lin_j)(xb, ub, xr, ur, f)
    qt = lin_t(*(torch.as_tensor(a) for a in (xb, ub, xr, ur, f)))
    for name in qj._fields:
        np.testing.assert_allclose(getattr(qt, name).numpy(), np.asarray(getattr(qj, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


def test_controller_matches_jax_tick_by_tick():
    """The hover recovery from (1, -0.5, 0.4) to (0, 0, 1): both controllers
    and both plants, 50 ticks; the port's thrusts stay inside the rotor
    box, as `test_thrust_model.py:84` asserts."""
    xr = np.tile(x13([0.0, 0.0, 1.0]), (N + 1, 1))
    ur = np.full((N, 4), hover_thrust(VEH))
    j_c = j_ctl(JCFG.ocp, JCFG.vehicle)
    upd = jax.jit(j_c.update)
    j_plant = jax.jit(j_discrete(lambda xx, uu: j_dyn(xx, uu, veh=JCFG.vehicle), OCP.ts_nmpc, 4))
    t_c = make_thrust_rti_controller(OCP, VEH, device="cpu")
    t_plant = make_discrete_dynamics(lambda xx, uu: thrust_dynamics(xx, uu, veh=VEH),
                                     OCP.ts_nmpc, 4)
    f_lo, f_hi = rotor_thrust_bounds(VEH)
    js = j_c.reset(jnp.asarray(xr), jnp.asarray(ur))
    ts = t_c.reset(torch.as_tensor(xr), torch.as_tensor(ur))
    jx = x13([1.0, -0.5, 0.4])
    tx = torch.as_tensor(jx)
    for tick in range(50):
        ju, js, jinfo = upd(js, jx, xr, ur)
        tu, ts, tinfo = t_c.update(ts, tx, xr, ur)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-8,
                                   err_msg=f"tick {tick}")
        assert bool(tinfo.ok) == bool(jinfo.ok), tick
        assert f_lo - 1e-6 <= float(tu.min()) and float(tu.max()) <= f_hi + 1e-6
        jx, tx = j_plant(jx, ju), t_plant(tx, tu)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-8)
    assert bool(tinfo.ok)
    assert float(torch.linalg.norm(tx[0:3] - torch.tensor([0.0, 0.0, 1.0], dtype=tx.dtype))) < 0.5
