"""PyTorch port vs JAX: the deployed `jac_bf16=True` whole-step controller.

Same case as `test_torch_step_whole.py`, two ticks, both sides fed the
identical forecast. Tolerance: u0 atol 1e-3 (the `BASELINE.md` golden
control bound), eq_res atol 1e-5, `ok` identical. It is wider than the f32
test's because a 1-ulp f32 difference before the bf16 rounding of a
Jacobian entry can flip one bf16 ulp (2^-8 relative) of that entry.
Tick 2 is also run from the JAX state after tick 1, carried over with
`convert.rti_state_from_numpy`, so that it is compared alone. The JAX
side is read from its recording, as in `test_torch_step_whole.py`; the
forecast is the JAX package's, computed live.
"""

import numpy as np

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from test_torch_step_whole import (  # noqa: F401 (autouse fixture)
    STATE, jax_forecast, jax_state, make_case, one_torch_thread, port_controller,
)

REF_KEYS = (keys(("bf16",), (), ("x0", "xr", "ur", "f", "qp_iters"))
            + keys(("bf16/tick0", "bf16/tick1"), ("u0", "eq_res", "ok"))
            + keys(("bf16/carried",), STATE))


def _check(u_t, info_t, ref, msg):
    np.testing.assert_allclose(u_t.numpy(), ref("u0"), atol=1e-3, err_msg=msg)
    np.testing.assert_allclose(info_t.eq_res.numpy(), ref("eq_res"), atol=1e-5, err_msg=msg)
    np.testing.assert_array_equal(info_t.ok.numpy(), ref("ok"), err_msg=msg)


def test_bf16_whole_step_controller_matches_jax():
    N, B = PortConfig().ocp.N_node, 8
    x0, xr, ur, other = make_case(B, N)
    f = jax_forecast(x0, xr, other)
    rec = Recording("test_torch_step_whole_bf16")
    rec.check_inputs("bf16", x0=x0, xr=xr, ur=ur, f=f, qp_iters=3)
    tick0 = lambda name: rec("bf16/tick0", name)
    tick1 = lambda name: rec("bf16/tick1", name)

    ctl_t = port_controller(3, jac_bf16=True)
    st_t = ctl_t.reset(xr, ur)
    u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f)
    _check(u_t, info_t, tick0, "tick 0")

    # the JAX state after tick 0, as `convert.rti_state_from_numpy` carries it
    carried = jax_state(lambda name: rec("bf16/carried", name), B)
    u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f)
    _check(u_t, info_t, tick1, "tick 1, chained")
    u_c, _, info_c = ctl_t.update(carried, x0, xr, ur, f)
    _check(u_c, info_c, tick1, "tick 1, from the JAX state")
