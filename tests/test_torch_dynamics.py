"""PyTorch port vs JAX: quaternion algebra, body-rate dynamics, RK4 and the
hover helpers, on the same f64 inputs (rtol 1e-12: same formulas, same
operation order, so only the last bits may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models import quadrotor as jq
from ndp_nmpc_qd_tpu.ops import integrators as ji
from ndp_nmpc_qd_tpu.ops import quat as jquat
from ndp_nmpc_qd_tpu.params import VehicleParams
from ndp_nmpc_qd_tpu_torch.models import quadrotor as tq
from ndp_nmpc_qd_tpu_torch.ops import integrators as ti
from ndp_nmpc_qd_tpu_torch.ops import quat as tquat


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RTOL = 1e-12
ATOL = 1e-14
VEH = VehicleParams()


def _close(port, ref):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


def _unit_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize(
    "name", ["multiply", "rotate", "error_vector", "conjugate", "normalize",
             "to_rotation_matrix", "from_rotation_matrix", "yaw", "from_yaw"],
)
def test_quat_matches_jax(name, rng):
    q1, q2 = _unit_quats(rng, 16), _unit_quats(rng, 16)
    v = rng.standard_normal((16, 3))
    args = {
        "multiply": (q1, q2), "rotate": (q1, v), "error_vector": (q1, q2),
        "conjugate": (q1,), "normalize": (3.0 * q1,),
        "to_rotation_matrix": (q1,),
        "from_rotation_matrix": (np.array(jquat.to_rotation_matrix(q1)),),
        "yaw": (q1,), "from_yaw": (rng.uniform(-3, 3, 16),),
    }[name]
    ref = getattr(jquat, name)(*(jnp.asarray(a) for a in args))
    port = getattr(tquat, name)(*(torch.as_tensor(a) for a in args))
    _close(port, ref)


@pytest.mark.parametrize("with_fd", [False, True])
def test_body_rate_dynamics_and_rk4_match_jax(with_fd, rng):
    x = rng.standard_normal((32, 10))
    x[:, 6:10] = _unit_quats(rng, 32)
    u = rng.standard_normal((32, 4)) + np.array([0, 0, 0, 9.81])
    fd = rng.standard_normal((32, 3)) if with_fd else None
    kw = dict(mass=VEH.mass, gravity=VEH.gravity)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)
    _close(
        tq.body_rate_dynamics(t(x), t(u), t(fd), **kw),
        jq.body_rate_dynamics(j(x), j(u), j(fd), **kw),
    )
    ref = ji.rk4_step(lambda xx, uu: jq.body_rate_dynamics(xx, uu, j(fd), **kw),
                      j(x), j(u), 0.1, substeps=2)
    port = ti.rk4_step(lambda xx, uu: tq.body_rate_dynamics(xx, uu, t(fd), **kw),
                       t(x), t(u), 0.1, substeps=2)
    _close(port, ref)
    phi_j = ji.make_discrete_dynamics(jq.make_dynamics(VEH), 0.02)
    phi_t = ti.make_discrete_dynamics(tq.make_dynamics(VEH), 0.02)
    if with_fd:
        _close(phi_t(t(x), t(u), t(fd)), phi_j(j(x), j(u), j(fd)))
    else:
        _close(phi_t(t(x), t(u)), phi_j(j(x), j(u)))


def test_hover_helpers_match_jax(rng):
    pos = rng.standard_normal((5, 3))
    _close(tq.hover_state(torch.as_tensor(pos)), jq.hover_state(jnp.asarray(pos)))
    _close(
        tq.hover_input(VEH, (5,), dtype=torch.float64, device="cpu"),
        jq.hover_input(VEH, (5,), dtype=jnp.float64),
    )
    x = tq.hover_state(torch.as_tensor(pos))
    u = tq.hover_input(VEH, (5,), dtype=torch.float64, device="cpu")
    xdot = tq.body_rate_dynamics(x, u, mass=VEH.mass, gravity=VEH.gravity)
    assert float(xdot.abs().max()) < 1e-12
