"""PyTorch port vs JAX: the deployed `jac_bf16=True` whole-step controller.

Same case as `test_torch_step_whole.py`, two ticks, both sides fed the
identical forecast. Tolerance: u0 atol 1e-3 (the `BASELINE.md` golden
control bound), eq_res atol 1e-5, `ok` identical. It is wider than the f32
test's because a 1-ulp f32 difference before the bf16 rounding of a
Jacobian entry can flip one bf16 ulp (2^-8 relative) of that entry.
Tick 2 is also run from the JAX state after tick 1, carried over with
`convert.rti_state_from_numpy`, so that it is compared alone.
"""

import os

import jax.numpy as jnp
import numpy as np

from ndp_nmpc_qd_tpu.models import downwash_mlp as j_mlp
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch import convert
from test_torch_step_whole import (  # noqa: F401 (autouse fixture)
    jax_controller, make_case, one_torch_thread, port_controller,
)

ASSET = os.path.join(
    os.path.dirname(__file__), "..", "assets", "downwash_analytic_sn4.npz"
)


def _check(u_t, info_t, u_j, info_j, msg):
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-3, err_msg=msg)
    np.testing.assert_allclose(
        info_t.eq_res.numpy(), np.asarray(info_j.eq_res), atol=1e-5, err_msg=msg
    )
    np.testing.assert_array_equal(info_t.ok.numpy(), np.asarray(info_j.ok), err_msg=msg)


def test_bf16_whole_step_controller_matches_jax():
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 8
    x0, xr, ur, other = make_case(B, N)
    f = np.array(j_mlp.predict_downwash(
        j_mlp.load_npz(ASSET), jnp.asarray(other), jnp.asarray(xr),
        r_horiz=cfg.downwash.r_horiz, ego_gate_pos=jnp.asarray(x0)[:, 0:3],
    ))

    ctl_j = jax_controller(cfg, 3, jac_bf16=True)
    ctl_t = port_controller(3, jac_bf16=True)
    st_j = ctl_j.reset(jnp.asarray(xr), jnp.asarray(ur))
    st_t = ctl_t.reset(xr, ur)
    args_j = (jnp.asarray(x0), jnp.asarray(xr), jnp.asarray(ur), jnp.asarray(f))

    u_j, st_j, info_j = ctl_j.update(st_j, *args_j)
    u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f)
    _check(u_t, info_t, u_j, info_j, "tick 0")

    carried = convert.rti_state_from_numpy(
        np.asarray(st_j.x_bar), np.asarray(st_j.u_bar),
        [np.asarray(a) for a in st_j.ipm], B, device="cpu",
    )
    u_j, st_j, info_j = ctl_j.update(st_j, *args_j)
    u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f)
    _check(u_t, info_t, u_j, info_j, "tick 1, chained")
    u_c, _, info_c = ctl_t.update(carried, x0, xr, ur, f)
    _check(u_c, info_c, u_j, info_j, "tick 1, from the JAX state")
