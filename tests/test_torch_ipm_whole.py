"""PyTorch port vs JAX: the whole-IPM solve (K2, `riccati_ipm_whole`).

Both sides run `ipm_sparse(whole_kernel=True, lqr_start=False)`, 4
iterations, on the same payload: the case of `test_ipm_whole.py` (B=1024,
made from a numpy seed), linearized once by the JAX package's jnp sparse
linearizer and handed to the port as (stage, element, B) tensors. The port's plain
version runs on the CPU; the JAX side is the recording
`tools/record_jax_refs.py` makes of the kernel in interpret mode
(`jax_refs.py`), checked first against this payload. Cold
lanes, warm lanes (each side carrying its own duals from its cold solve),
mixed lanes (every third warm lane reset to the cold sentinel), warm=None,
and the bf16 curvature payload. The recording holds the cold, warm and
bf16 solves; the JAX kernel's warm=None solve is its cold one and its mixed
solve is the cold one on the reset lanes and the warm one elsewhere, bitwise
(the recorder asserts both), so the test derives those two references.
Tolerances are `test_ipm_whole.py`'s:
zx/zu atol 5e-5, mu rtol 1e-4 / atol 1e-7, eq_res rtol 1e-3 / atol 1e-5, the
carried duals rtol 2e-4 / atol 2e-5; the duals are also held at their own
scale (rtol 1e-4, atol 1e-4 max|ref|), since warm duals sit near mu, far
below that atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import SparseQp, sparse_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm, cold_warm
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse as t_ipm

B = 1024
ITERS = 4
RESET = np.arange(B) % 3 == 0  # the mixed lanes: warm duals reset to the cold sentinel
# the solution, then the carried duals (`warm_` and the IpmWarm field)
SOLUTION = ("zx", "zu", "mu", "eq_res") + tuple(f"warm_{f}" for f in IpmWarm._fields)
REF_KEYS = (keys(("cold", "warm", "bf16"), SOLUTION, ("payload",))
            + keys(("mixed", "warm_none"), (), ("payload",)) + keys(("mixed",), (), ("reset",)))


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


def jax_payload(seed=7):
    """The case of `test_ipm_whole.py` (seed 7) and of `test_glue_fused.py`
    (seed 3) from a numpy seed: x0 at offsets in [-3, 3] m, quaternion
    iterates off hover by 0.2, controls at hover, a forecast force of scale
    0.3; linearized by the JAX package's jnp sparse linearizer: (SparseQp,
    consts, dx0) in its kernel layout."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    rng = np.random.default_rng(seed)
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
    return qp, consts, dx0


def port_payload(qp, dx0):
    """The JAX payload as the port's (SparseQp, dx0), (s, d, B) tensors."""
    return (SparseQp(*(torch.tensor(lanes(getattr(qp, n))) for n in qp._fields)),
            torch.tensor(lanes(dx0)))


@pytest.fixture(scope="module")
def qp_case():
    qp, _, dx0 = jax_payload()
    qp_t, dx0_t = port_payload(qp, dx0)
    return qp_t, sparse_consts(PortConfig().ocp), dx0_t


def mixed_reference(cold, warm):
    """An array of the mixed solve from the cold and warm ones (the batch
    last): the cold lanes where RESET, the warm ones elsewhere."""
    return np.where(RESET, cold, warm)


class IpmRecording(Recording):
    """The recording, with the warm=None and mixed solves derived."""

    def __call__(self, case, name):
        if case == "mixed":
            return mixed_reference(self("cold", name), self("warm", name))
        return super().__call__("cold" if case == "warm_none" else case, name)


@pytest.fixture(scope="module")
def rec():
    return IpmRecording("test_torch_ipm_whole")


def solve(case, warm_t, bf16=False):
    qp_t, consts_t, dx0_t = case
    if bf16:
        qp_t = qp_t._replace(**{n: getattr(qp_t, n).to(torch.bfloat16) for n in ("hq", "a", "b")})
    if warm_t is not None:  # the port's kernel path updates the duals in place
        warm_t = IpmWarm(*(t.clone() for t in warm_t))
    return t_ipm(qp_t, consts_t, dx0_t, num_iters=ITERS, warm=warm_t, lqr_start=False,
                 whole_kernel=True)


def assert_duals(w_t, rec, case):
    for name, got in zip(IpmWarm._fields, w_t):
        got, ref = got.numpy(), rec(case, f"warm_{name}")
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=f"{case} {name}")
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{case} {name}")


def assert_solution(out_t, rec, case):
    zx_t, zu_t, mu_t, eq_t, w_t = out_t
    np.testing.assert_allclose(zu_t.numpy(), rec(case, "zu"), atol=5e-5, err_msg=case)
    np.testing.assert_allclose(zx_t.numpy(), rec(case, "zx"), atol=5e-5, err_msg=case)
    np.testing.assert_allclose(mu_t.numpy(), rec(case, "mu"), rtol=1e-4, atol=1e-7, err_msg=case)
    np.testing.assert_allclose(eq_t.numpy(), rec(case, "eq_res"), rtol=1e-3, atol=1e-5,
                               err_msg=case)
    assert_duals(w_t, rec, case)


def test_whole_ipm_matches_jax_cold_warm_and_mixed(qp_case, rec):
    payload = (qp_case[0], qp_case[2])
    rec.check_inputs("cold", payload=payload)
    rec.check_inputs("warm", payload=payload)
    rec.check_inputs("mixed", payload=payload, reset=RESET)
    N = qp_case[0].gu.shape[0]
    out_t = solve(qp_case, cold_warm(N, B, torch.float32, "cpu"))
    assert_solution(out_t, rec, "cold")

    w_t = out_t[4]
    assert_solution(solve(qp_case, w_t), rec, "warm")

    mu_t = torch.where(torch.as_tensor(RESET), -1.0, w_t.mu)
    assert_solution(solve(qp_case, w_t._replace(mu=mu_t)), rec, "mixed")


def test_whole_ipm_warm_none_matches_jax(qp_case, rec):
    rec.check_inputs("warm_none", payload=(qp_case[0], qp_case[2]))
    assert_solution(solve(qp_case, None), rec, "warm_none")


def test_whole_ipm_bf16_payload_matches_jax(qp_case, rec):
    rec.check_inputs("bf16", payload=(qp_case[0], qp_case[2]))
    N = qp_case[0].gu.shape[0]
    assert_solution(solve(qp_case, cold_warm(N, B, torch.float32, "cpu"), bf16=True), rec, "bf16")
