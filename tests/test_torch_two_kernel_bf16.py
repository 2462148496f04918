"""PyTorch port vs JAX: the two-kernel RTI controllers with bf16 Jacobians.

The case and controllers of `test_torch_two_kernel.py` (B=8, qp_iters=3,
warm start, packed state, 3 chained ticks) with `jac_bf16=True`, for both
`whole_ipm` values. Tolerances are the bf16 ones of
`test_torch_step_whole_bf16.py` and `chip_smoke.py`'s `check_pair`: u0
atol 1e-3 (the `BASELINE.md` control bound), eq_res atol 1e-5, `ok`
identical, iterates within 2^-8 of each tensor's largest entry, duals and
mu rtol 2^-8 at their own scale. They are wider than the f32 test's because
a 1-ulp f32 difference before the bf16 rounding of a Jacobian entry can
flip one bf16 ulp (2^-8 relative) of that entry. The JAX side is read
from its recording, as in `test_torch_two_kernel.py`.
"""

import numpy as np
import pytest

from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti
from test_torch_step_whole import jax_state, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_two_kernel import REF_KEYS, B, run_port  # noqa: F401 (the same keys)

BF16_ULP = 2.0 ** -8


def at_own_scale(got, ref):
    return float((np.abs(got - ref) / np.maximum(np.abs(ref).max() + np.abs(ref), 1e-30)).max())


@pytest.mark.parametrize("whole_ipm", [True, False])
def test_bf16_two_kernel_controller_matches_jax(whole_ipm):
    for msg, (u_t, st_t, info_t), ref in run_port("test_torch_two_kernel_bf16", whole_ipm, True):
        np.testing.assert_allclose(u_t.numpy(), ref("u0"), atol=1e-3, err_msg=msg)
        np.testing.assert_allclose(info_t.eq_res.numpy(), ref("eq_res"), atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(info_t.ok.numpy(), ref("ok"), err_msg=msg)
        for got, name in zip(t_rti.unpack_iterates(st_t, B), ("x_bar", "u_bar")):
            want = ref(name)
            err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
            assert err <= BF16_ULP, f"{msg}: iterates off by {err} of their largest entry"
        wants = [w.numpy() for w in jax_state(ref, B).ipm] + [ref("mu")]
        for got, want in zip(st_t.ipm + (info_t.mu,), wants):
            err = at_own_scale(got.numpy(), want)
            assert err <= BF16_ULP, f"{msg}: duals off by {err} at their own scale"
