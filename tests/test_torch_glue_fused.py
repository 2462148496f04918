"""PyTorch port vs JAX: the per-iteration IPM on the glue-fused kernels
(`ipm_sparse(fuse_glue=True, lqr_start=False)`, K4+K5 once per iteration).

The case is `test_glue_fused.py`'s (B=1024, made from a numpy seed),
linearized once by the JAX package's jnp sparse linearizer; the port gets
the same payload as (stage, element, B) tensors. The JAX kernels run in
interpret mode, the port's plain versions on the CPU. 4 iterations, cold
(warm=None, the defect-based residual) and then warm (each side carrying
its own duals): `test_glue_fused.py`'s zx/zu atol 2e-5 with rtol 1e-5
beside it, mu rtol 1e-4 / atol 1e-7, eq_res rtol 1e-3 / atol 1e-5, carried
duals rtol 2e-4 / atol 2e-5, and the duals also at their own scale (rtol
1e-4, atol 1e-4 max|ref|). The rtol: `test_glue_fused.py` compares two JAX
paths that share their start and reductions; here the rollout start and
the stage sums are torch's, and on a few controls at the body-rate bound
(|u| ~ 6) the 4 iterations carry that to ~3e-5, a relative 5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse
from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import ipm_sparse as j_ipm
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import SparseQp, ipm_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse as t_ipm

B = 1024


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version runs many small ops on (B,) tensors; intra-op
    threads only add overhead there and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lanes(a):
    """A JAX array with the (nb, SUB, 128) batch tail as (..., B), f32."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return a.reshape(a.shape[:-3] + (-1,))[..., :B]


@pytest.fixture(scope="module")
def qp_case():
    """`test_glue_fused.py`'s case from a numpy seed: x0 at offsets in
    [-3, 3] m, quaternion iterates off hover by 0.2, controls at hover, a
    forecast force of scale 0.3."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    rng = np.random.default_rng(3)
    hover = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
    x0 = np.tile(hover, (B, 1))
    x0[:, 0:3] = rng.uniform(-3.0, 3.0, (B, 3))
    xr = np.tile(hover, (B, N + 1, 1))
    xb = xr.copy()
    xb[:, :, 6:10] += 0.2 * rng.standard_normal((B, N + 1, 4))
    ur = np.tile(np.array([0, 0, 0, cfg.vehicle.gravity], np.float32), (B, N, 1))
    f = (0.3 * rng.standard_normal((B, N + 1, 3))).astype(np.float32)
    lin_s, consts, _ = make_ocp_functions_sparse(cfg.ocp, cfg.vehicle, True)
    qp, dx0 = lin_s(*(jnp.asarray(a) for a in (xb, ur, xr, ur, f, x0)))
    qp_t = tuple(torch.tensor(lanes(getattr(qp, n))) for n in qp._fields)
    return (qp, consts, dx0), (qp_t, torch.tensor(lanes(dx0)))


def solve_both(case, warm_j, warm_t):
    (qp, consts, dx0), (qp_t, dx0_t) = case
    out_j = j_ipm(qp, consts, dx0, num_iters=4, interpret=True, warm=warm_j,
                  lqr_start=False, fuse_glue=True)
    pc = ipm_consts(PortConfig().ocp)
    sc = type(consts)(**{k: pc[k] for k in consts._fields})
    out_t = t_ipm(SparseQp(*qp_t), sc, dx0_t, num_iters=4, warm=warm_t, lqr_start=False,
                  fuse_glue=True)
    return out_j, out_t


def assert_solution(out_t, out_j, msg):
    zx_j, zu_j, mu_j, eq_j, w_j = out_j
    zx_t, zu_t, mu_t, eq_t, w_t = out_t
    np.testing.assert_allclose(zu_t.numpy(), lanes(zu_j), rtol=1e-5, atol=2e-5, err_msg=msg)
    np.testing.assert_allclose(zx_t.numpy(), lanes(zx_j), rtol=1e-5, atol=2e-5, err_msg=msg)
    np.testing.assert_allclose(mu_t.numpy(), lanes(mu_j), rtol=1e-4, atol=1e-7, err_msg=msg)
    np.testing.assert_allclose(eq_t.numpy(), lanes(eq_j), rtol=1e-3, atol=1e-5, err_msg=msg)
    for name, got, ref in zip(IpmWarm._fields, w_t, w_j):
        got, ref = got.numpy(), lanes(ref)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=f"{msg} {name}")
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=f"{msg} {name}")


def test_per_iteration_ipm_matches_jax_cold_then_warm(qp_case):
    out_j, out_t = solve_both(qp_case, None, None)
    assert_solution(out_t, out_j, "cold")
    out_j, out_t = solve_both(qp_case, out_j[4], out_t[4])
    assert_solution(out_t, out_j, "warm")
