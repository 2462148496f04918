"""PyTorch port vs JAX: the two-kernel RTI controllers (`whole_step=False`).

`make_batched_rti_controller(backend="pallas", whole_step=False,
lqr_start=False)` with `whole_ipm=True` runs the linearization (K3) and the
whole IPM (K2) each tick; with `whole_ipm=False` K3 and then one
glue-fused iteration (K4+K5) per IPM iteration. The JAX controller runs its
Pallas kernels in interpret mode (its `update` jitted, so that the
per-iteration path compiles once for the 3 ticks); the port runs the plain
versions on the CPU. Case: `test_torch_step_whole.py`'s, B=8, with a
forecast force of scale 0.2 from a numpy seed, qp_iters=3, warm start,
packed state, f32 Jacobians, 3 chained ticks. Tolerances are
`test_packed_state.py:99-115`'s: u0 atol 1e-5, eq_res rtol 1e-4 / atol
1e-6, `ok` identical, iterates atol 2e-5; the carried duals and mu rtol
1e-4 / atol 1e-5, and also at their own scale (atol 1e-4 max|ref|).

The bf16 Jacobians are `test_torch_two_kernel_bf16.py`; the batch-first
layout, the cold start and the one-kernel step `test_torch_two_kernel_layout.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver import rti as j_rti
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti
from test_torch_step_whole import make_case, one_torch_thread  # noqa: F401 (autouse fixture)

B = 8
QP_ITERS = 3


def forecast(B, N, seed=5):
    return (0.2 * np.random.default_rng(seed).standard_normal((B, N + 1, 3))).astype(np.float32)


def jax_controller(cfg, whole_ipm, jac_bf16, packed_state=True, warm_start=True):
    return j_rti.make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=QP_ITERS, backend="pallas",
        interpret=True, warm_start=warm_start, lqr_start=False, whole_ipm=whole_ipm,
        packed_state=packed_state, whole_step=False, jac_bf16=jac_bf16,
    )


def port_controller(whole_ipm, jac_bf16, packed_state=True, warm_start=True, whole_step=False):
    cfg = PortConfig()
    return t_rti.make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=QP_ITERS,
        warm_start=warm_start, lqr_start=False, whole_ipm=whole_ipm,
        packed_state=packed_state, whole_step=whole_step, jac_bf16=jac_bf16, device="cpu",
    )


def run_jax_and_port(whole_ipm, jac_bf16, ticks=3):
    """Yields (tick, JAX (u0, state, info), port (u0, state, info))."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    x0, xr, ur, _ = make_case(B, N)
    f = forecast(B, N)
    ctl_j = jax_controller(cfg, whole_ipm, jac_bf16)
    ctl_t = port_controller(whole_ipm, jac_bf16)
    update_j = jax.jit(ctl_j.update)
    st_j = ctl_j.reset(jnp.asarray(xr), jnp.asarray(ur))
    st_t = ctl_t.reset(xr, ur)
    args_j = tuple(jnp.asarray(a) for a in (x0, xr, ur, f))
    for tick in range(ticks):
        out_j = update_j(st_j, *args_j)
        out_t = ctl_t.update(st_t, x0, xr, ur, f)
        st_j, st_t = out_j[1], out_t[1]
        yield tick, out_j, out_t


def duals_of(st_j):
    return convert.rti_state_from_numpy(
        np.asarray(st_j.x_bar), np.asarray(st_j.u_bar),
        [np.asarray(a) for a in st_j.ipm], B, device="cpu",
    ).ipm


@pytest.mark.parametrize("whole_ipm", [True, False])
def test_two_kernel_controller_matches_jax(whole_ipm):
    for tick, (u_j, st_j, info_j), (u_t, st_t, info_t) in run_jax_and_port(whole_ipm, False):
        msg = f"whole_ipm={whole_ipm}, tick {tick}"
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(info_t.eq_res.numpy(), np.asarray(info_j.eq_res),
                                   rtol=1e-4, atol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(info_t.ok.numpy(), np.asarray(info_j.ok), err_msg=msg)
        for got, ref in zip(t_rti.unpack_iterates(st_t, B), j_rti.unpack_iterates(st_j, B)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, err_msg=msg)
        for got, ref in zip(st_t.ipm, duals_of(st_j)):
            got, ref = got.numpy(), ref.numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=msg)
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=msg)
        np.testing.assert_allclose(info_t.mu.numpy(), np.asarray(info_j.mu),
                                   rtol=1e-4, atol=1e-5, err_msg=msg)
