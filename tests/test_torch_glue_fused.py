"""PyTorch port vs JAX: the per-iteration IPM on the glue-fused kernels
(`ipm_sparse(fuse_glue=True, lqr_start=False)`, K4+K5 once per iteration).

The case is `test_glue_fused.py`'s (B=1024, made from a numpy seed),
linearized once by the JAX package's jnp sparse linearizer; the port gets
the same payload as (stage, element, B) tensors. The port's plain versions
run on the CPU; the JAX side is the recording `tools/record_jax_refs.py`
makes of the kernels in interpret mode (`jax_refs.py`), checked first
against this payload. 4 iterations, cold
(warm=None, the defect-based residual) and then warm (each side carrying
its own duals): `test_glue_fused.py`'s zx/zu atol 2e-5 with rtol 1e-5
beside it, mu rtol 1e-4 / atol 1e-7, eq_res rtol 1e-3 / atol 1e-5, carried
duals rtol 2e-4 / atol 2e-5, and the duals also at their own scale (rtol
1e-4, atol 1e-4 max|ref|). The rtol: `test_glue_fused.py` compares two JAX
paths that share their start and reductions; here the rollout start and
the stage sums are torch's, and on a few controls at the body-rate bound
(|u| ~ 6) the 4 iterations carry that to ~3e-5, a relative 5e-6.
"""

import numpy as np
import pytest

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import sparse_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse as t_ipm
from test_torch_ipm_whole import (  # noqa: F401 (autouse fixture)
    SOLUTION, jax_payload, one_torch_thread, port_payload,
)

SEED = 3
REF_KEYS = keys(("cold", "warm"), SOLUTION, ("payload",))


@pytest.fixture(scope="module")
def qp_case():
    qp, _, dx0 = jax_payload(SEED)
    return port_payload(qp, dx0)


def solve(case, warm_t):
    qp_t, dx0_t = case
    return t_ipm(qp_t, sparse_consts(PortConfig().ocp), dx0_t, num_iters=4, warm=warm_t,
                 lqr_start=False, fuse_glue=True)


def assert_solution(out_t, rec, case):
    zx_t, zu_t, mu_t, eq_t, w_t = out_t
    ref = lambda name: rec(case, name)
    np.testing.assert_allclose(zu_t.numpy(), ref("zu"), rtol=1e-5, atol=2e-5, err_msg=case)
    np.testing.assert_allclose(zx_t.numpy(), ref("zx"), rtol=1e-5, atol=2e-5, err_msg=case)
    np.testing.assert_allclose(mu_t.numpy(), ref("mu"), rtol=1e-4, atol=1e-7, err_msg=case)
    np.testing.assert_allclose(eq_t.numpy(), ref("eq_res"), rtol=1e-3, atol=1e-5, err_msg=case)
    for name, got in zip(IpmWarm._fields, w_t):
        got, want = got.numpy(), ref(f"warm_{name}")
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=f"{case} {name}")
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{case} {name}")


def test_per_iteration_ipm_matches_jax_cold_then_warm(qp_case):
    rec = Recording("test_torch_glue_fused")
    rec.check_inputs("cold", payload=qp_case)
    rec.check_inputs("warm", payload=qp_case)
    out_t = solve(qp_case, None)
    assert_solution(out_t, rec, "cold")
    assert_solution(solve(qp_case, out_t[4]), rec, "warm")
