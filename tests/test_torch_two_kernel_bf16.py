"""PyTorch port vs JAX: the two-kernel RTI controllers with bf16 Jacobians.

The case and controllers of `test_torch_two_kernel.py` (B=8, qp_iters=3,
warm start, packed state, 3 chained ticks) with `jac_bf16=True`, for both
`whole_ipm` values. Tolerances are the bf16 ones of
`test_torch_step_whole_bf16.py` and `chip_smoke.py`'s `check_pair`: u0
atol 1e-3 (the `BASELINE.md` control bound), eq_res atol 1e-5, `ok`
identical, iterates within 2^-8 of each tensor's largest entry, duals and
mu rtol 2^-8 at their own scale. They are wider than the f32 test's because
a 1-ulp f32 difference before the bf16 rounding of a Jacobian entry can
flip one bf16 ulp (2^-8 relative) of that entry.
"""

import numpy as np
import pytest

from ndp_nmpc_qd_tpu.solver import rti as j_rti
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti
from test_torch_step_whole import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_two_kernel import B, duals_of, run_jax_and_port

BF16_ULP = 2.0 ** -8


def at_own_scale(got, ref):
    return float((np.abs(got - ref) / np.maximum(np.abs(ref).max() + np.abs(ref), 1e-30)).max())


@pytest.mark.parametrize("whole_ipm", [True, False])
def test_bf16_two_kernel_controller_matches_jax(whole_ipm):
    for tick, (u_j, st_j, info_j), (u_t, st_t, info_t) in run_jax_and_port(whole_ipm, True):
        msg = f"whole_ipm={whole_ipm}, tick {tick}"
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-3, err_msg=msg)
        np.testing.assert_allclose(info_t.eq_res.numpy(), np.asarray(info_j.eq_res),
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(info_t.ok.numpy(), np.asarray(info_j.ok), err_msg=msg)
        for got, ref in zip(t_rti.unpack_iterates(st_t, B), j_rti.unpack_iterates(st_j, B)):
            ref = np.asarray(ref)
            err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
            assert err <= BF16_ULP, f"{msg}: iterates off by {err} of their largest entry"
        for got, ref in zip(st_t.ipm + (info_t.mu,), duals_of(st_j) + (info_j.mu,)):
            err = at_own_scale(got.numpy(), np.asarray(ref))
            assert err <= BF16_ULP, f"{msg}: duals off by {err} at their own scale"
