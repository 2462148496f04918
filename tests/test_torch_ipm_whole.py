"""PyTorch port vs JAX: the whole-IPM solve (K2, `riccati_ipm_whole`).

Both sides run `ipm_sparse(whole_kernel=True, lqr_start=False)`, 4
iterations, on the same payload: the case of `test_ipm_whole.py` (B=1024,
made from a numpy seed), linearized once by the JAX package's jnp sparse
linearizer and handed to the port as (stage, element, B) tensors. The JAX
kernel runs in interpret mode, the port's plain version on the CPU. Cold
lanes, warm lanes (each side carrying its own duals from its cold solve),
mixed lanes (every third warm lane reset to the cold sentinel), warm=None,
and the bf16 curvature payload. Tolerances are `test_ipm_whole.py`'s:
zx/zu atol 5e-5, mu rtol 1e-4 / atol 1e-7, eq_res rtol 1e-3 / atol 1e-5, the
carried duals rtol 2e-4 / atol 2e-5; the duals are also held at their own
scale (rtol 1e-4, atol 1e-4 max|ref|), since warm duals sit near mu, far
below that atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse
from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import IpmWarm as JWarm
from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import ipm_sparse as j_ipm
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import SparseQp, sparse_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm, cold_warm
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse as t_ipm

B = 1024
ITERS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version runs many small ops on (B,) tensors; intra-op
    threads only add overhead there and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lanes(a):
    """A JAX kernel-layout array (s, d, nb, SUB, 128) or (nb, SUB, 128) as
    (s, d, B) or (B,), f32 numpy."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    if a.ndim == 3:
        return a.reshape(-1)[:B]
    return a.reshape(a.shape[0], a.shape[1], -1)[..., :B]


@pytest.fixture(scope="module")
def qp_case():
    """`test_ipm_whole.py`'s case from a numpy seed: x0 at offsets in
    [-3, 3] m, quaternion iterates off hover by 0.2, controls at hover, a
    forecast force of scale 0.3."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    rng = np.random.default_rng(7)
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
    qp_t = SparseQp(*(torch.tensor(lanes(getattr(qp, n))) for n in qp._fields))
    return (qp, consts, dx0), (qp_t, sparse_consts(PortConfig().ocp), torch.tensor(lanes(dx0)))


def jax_cold(qp):
    N = qp.gu.shape[0]
    tail = qp.gx.shape[2:]
    z = lambda d, s: jnp.zeros((s, d) + tail, jnp.float32)
    return JWarm(z(4, N), z(4, N), z(3, N + 1), z(3, N + 1), jnp.full(tail, -1.0, jnp.float32))


def solve_both(case, warm_j, warm_t, bf16=False):
    (qp, consts, dx0), (qp_t, consts_t, dx0_t) = case
    if bf16:
        qp = qp._replace(**{n: getattr(qp, n).astype(jnp.bfloat16) for n in ("hq", "a", "b")})
        qp_t = qp_t._replace(**{n: getattr(qp_t, n).to(torch.bfloat16) for n in ("hq", "a", "b")})
    out_j = j_ipm(qp, consts, dx0, num_iters=ITERS, interpret=True, warm=warm_j,
                  lqr_start=False, fuse_glue=True, whole_kernel=True)
    if warm_t is not None:  # the port's kernel path updates the duals in place
        warm_t = IpmWarm(*(t.clone() for t in warm_t))
    out_t = t_ipm(qp_t, consts_t, dx0_t, num_iters=ITERS, warm=warm_t, lqr_start=False,
                  whole_kernel=True)
    return out_j, out_t


def assert_duals(w_t, w_j, msg):
    for name, got, ref in zip(IpmWarm._fields, w_t, w_j):
        got, ref = got.numpy(), lanes(ref)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=f"{msg} {name}")
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=f"{msg} {name}")


def assert_solution(out_t, out_j, msg):
    zx_j, zu_j, mu_j, eq_j, w_j = out_j
    zx_t, zu_t, mu_t, eq_t, w_t = out_t
    np.testing.assert_allclose(zu_t.numpy(), lanes(zu_j), atol=5e-5, err_msg=msg)
    np.testing.assert_allclose(zx_t.numpy(), lanes(zx_j), atol=5e-5, err_msg=msg)
    np.testing.assert_allclose(mu_t.numpy(), lanes(mu_j), rtol=1e-4, atol=1e-7, err_msg=msg)
    np.testing.assert_allclose(eq_t.numpy(), lanes(eq_j), rtol=1e-3, atol=1e-5, err_msg=msg)
    assert_duals(w_t, w_j, msg)


def test_whole_ipm_matches_jax_cold_warm_and_mixed(qp_case):
    qp_t = qp_case[1][0]
    N = qp_t.gu.shape[0]
    out_j, out_t = solve_both(qp_case, jax_cold(qp_case[0][0]), cold_warm(N, B, torch.float32, "cpu"))
    assert_solution(out_t, out_j, "cold")

    w_j, w_t = out_j[4], out_t[4]
    out_j, out_t = solve_both(qp_case, w_j, w_t)
    assert_solution(out_t, out_j, "warm")

    reset = np.arange(B) % 3 == 0
    mu_j = jnp.where(jnp.asarray(reset).reshape(w_j.mu.shape), -1.0, w_j.mu)
    mu_t = torch.where(torch.as_tensor(reset), -1.0, w_t.mu)
    out_j, out_t = solve_both(qp_case, w_j._replace(mu=mu_j), w_t._replace(mu=mu_t))
    assert_solution(out_t, out_j, "mixed")


def test_whole_ipm_warm_none_matches_jax(qp_case):
    out_j, out_t = solve_both(qp_case, None, None)
    assert_solution(out_t, out_j, "warm=None")


def test_whole_ipm_bf16_payload_matches_jax(qp_case):
    qp_t = qp_case[1][0]
    N = qp_t.gu.shape[0]
    out_j, out_t = solve_both(qp_case, jax_cold(qp_case[0][0]),
                              cold_warm(N, B, torch.float32, "cpu"), bf16=True)
    assert_solution(out_t, out_j, "bf16 payload")
