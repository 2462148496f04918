"""PyTorch port vs JAX: the far-regime claims of `tests/test_far_regime.py`
on the port's scan controller (`backend="jax"`, float64, on the CPU).

- One RTI update from hover offsets 5 ... 100 m (20 scenarios) at
  qp_iters 12 (`test_far_regime.py:41-58`'s deepest case): every scenario
  healthy, the command inside the actuator box and non-trivial; the same
  `ok` flags as the JAX scan controller on the same sweep, and u0 within
  `test_torch_scan_controller.py`'s float64 tolerance (rtol 1e-8, atol
  1e-10 at the tensor's scale).
- The nominal regime (`test_far_regime.py:61-72`): 12 against 40 QP
  iterations within 1e-4, both healthy.
The closed-loop recovery from 50 m (`test_far_regime.py:74-99`, 500 ticks
of the per-scenario controller) runs on the card, in `chip_smoke.py`'s
envelope phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models.quadrotor import hover_input as j_hover_input
from ndp_nmpc_qd_tpu.models.quadrotor import hover_state as j_hover_state
from ndp_nmpc_qd_tpu.params import OcpParams as JOcp
from ndp_nmpc_qd_tpu.params import VehicleParams as JVeh
from ndp_nmpc_qd_tpu.solver import rti as j_rti
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state
from ndp_nmpc_qd_tpu_torch.params import OcpParams, VehicleParams
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti

OCP, VEH = OcpParams(), VehicleParams()
N = OCP.N_node


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_update(ds, qp_iters):
    """One update of the port's scan controller from hover at (d, 0, 0)."""
    B = len(ds)
    ctl = t_rti.make_batched_rti_controller(OCP, VEH, with_disturbance=True, qp_iters=qp_iters,
                                            backend="jax", device="cpu")
    pos = torch.zeros(B, 3, dtype=torch.float64)
    pos[:, 0] = torch.as_tensor(ds)
    x0 = hover_state(pos)
    xr = hover_state(torch.zeros(B, 3, dtype=torch.float64))[:, None, :].repeat(1, N + 1, 1)
    ur = hover_input(VEH, (B,), torch.float64, "cpu")[:, None, :].repeat(1, N, 1)
    f = torch.zeros(B, N + 1, 3, dtype=torch.float64)
    u0, _, info = ctl.update(ctl.reset(xr, ur), x0, xr, ur, f)
    return u0, info


def jax_update(ds, qp_iters):
    """`test_far_regime.py`'s `_setup` and one jitted update."""
    B = len(ds)
    ocp, veh = JOcp(), JVeh()
    ctl = j_rti.make_batched_rti_controller(ocp, veh, with_disturbance=True, qp_iters=qp_iters,
                                            backend="jax")
    x0 = j_hover_state(jnp.stack([jnp.asarray(ds), jnp.zeros(B), jnp.zeros(B)], axis=-1))
    xr = jnp.tile(j_hover_state(jnp.zeros((B, 3)))[:, None, :], (1, N + 1, 1))
    ur = jnp.tile(j_hover_input(veh, (B,), jnp.float64)[:, None, :], (1, N, 1))
    f = jnp.zeros((B, N + 1, 3))
    u0, _, info = jax.jit(ctl.update)(ctl.reset(xr, ur), x0, xr, ur, f)
    return np.asarray(u0), np.asarray(info.ok)


def test_single_step_envelope_to_100m_matches_jax():
    ds = np.linspace(5.0, 100.0, 20)
    u0, info = port_update(ds, 12)
    assert bool(info.ok.all()), info.ok
    assert u0.dtype == torch.float64
    u = u0.numpy()
    assert np.all(u >= OCP.u_lower() - 1e-9) and np.all(u <= OCP.u_upper() + 1e-9)
    assert float(np.abs(u[-1, :3]).max()) > 0.1
    u_j, ok_j = jax_update(ds, 12)
    np.testing.assert_array_equal(info.ok.numpy(), ok_j)
    scale = max(1.0, float(np.abs(u_j).max()))
    torch.testing.assert_close(u0, torch.tensor(u_j), rtol=1e-8, atol=1e-10 * scale)


def test_nominal_regime_12_against_40_iterations():
    ds = np.array([0.3, 1.0, 2.0, 5.0])
    u12, i12 = port_update(ds, 12)
    u40, i40 = port_update(ds, 40)
    assert bool(i12.ok.all()) and bool(i40.ok.all())
    np.testing.assert_allclose(u12.numpy(), u40.numpy(), atol=1e-4)
