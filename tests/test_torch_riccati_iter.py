"""PyTorch port vs JAX: one glue-fused IPM iteration (K4+K5,
`riccati_iter_fused`).

The case is `test_glue_fused.py`'s (B=1024, made from a numpy seed),
linearized once by the JAX package's jnp sparse linearizer; the port gets
the same payload as (stage, element, B) tensors. The JAX kernels run in
interpret mode, the port's plain versions on the CPU. One
`riccati_iter_fused` call on the same inputs: the per-iteration path's
start (zero-control rollout, slacks, cold duals) with the primal iterate
moved by 0.01 (normal), so that defects and slack residuals are not at
rounding level. All 14 outputs: directions, the rollout and step sizes atol
2e-5 of max(1, max|ref|) (`test_glue_fused.py`'s atol); dual directions and
comp4 rtol 1e-4 at their own scale (atol 1e-4 max|ref|); res2 rtol 1e-4.
The 4-iteration IPM on these kernels is `test_torch_glue_fused.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.ops.pallas.riccati_sparse import riccati_iter_fused as j_iter
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse
from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels.riccati_sparse import riccati_iter_fused as t_iter
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts

B = 1024
OUTS = ("dx", "du", "dsu_lo", "dsu_up", "dlu_lo", "dlu_up", "dsx_lo", "dsx_up",
        "dlx_lo", "dlx_up", "ap", "ad", "comp4", "res2")


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


def test_one_iteration_matches_jax(qp_case):
    (qp, consts, _), (qp_t, dx0_t) = qp_case
    ic = ipm_consts(PortConfig().ocp)
    args = testing.iter_args(qp_t + (dx0_t,), ic)
    tail = qp.gx.shape[2:]
    to_j = lambda t: jnp.asarray(t.numpy().reshape(t.shape[:-1] + tail))
    kw = dict(h=ic["h"], diag6_stage=ic["diag6_stage"], diag6_term=ic["diag6_term"],
              rdiag_stage=ic["rdiag_stage"], tau=ic["tau"])
    assert kw["h"] == pytest.approx(consts.h, rel=1e-12)
    got = t_iter(*args, **kw)
    ref = j_iter(*(to_j(t) for t in args), **kw, interpret=True)
    assert len(got) == len(ref) == len(OUTS)
    for name, g, r in zip(OUTS, got, ref):
        g, r = g.numpy(), lanes(r)
        assert g.shape == r.shape, name
        scale = float(np.abs(r).max())
        if name.startswith("dl") or name == "comp4":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
        elif name == "res2":
            assert scale > 1e-6  # the jitter put the defects above rounding level
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=2e-5 * max(1.0, scale), err_msg=name)
