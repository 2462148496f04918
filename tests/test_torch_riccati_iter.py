"""PyTorch port vs JAX: one glue-fused IPM iteration (K4+K5,
`riccati_iter_fused`).

The case is `test_glue_fused.py`'s (B=1024, made from a numpy seed),
linearized once by the JAX package's jnp sparse linearizer; the port gets
the same payload as (stage, element, B) tensors. The port's plain versions
run on the CPU; the JAX side is the recording `tools/record_jax_refs.py`
makes of the kernels in interpret mode (`jax_refs.py`), checked first
against the call's inputs. One `riccati_iter_fused` call on the same
inputs: the per-iteration path's
start (zero-control rollout, slacks, cold duals) with the primal iterate
moved by 0.01 (normal), so that defects and slack residuals are not at
rounding level. All 14 outputs: directions, the rollout and step sizes atol
2e-5 of max(1, max|ref|) (`test_glue_fused.py`'s atol); dual directions and
comp4 rtol 1e-4 at their own scale (atol 1e-4 max|ref|); res2 rtol 1e-4.
The 4-iteration IPM on these kernels is `test_torch_glue_fused.py`.
"""

import numpy as np
import pytest

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels.riccati_sparse import riccati_iter_fused as t_iter
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts
from test_torch_glue_fused import SEED
from test_torch_ipm_whole import (  # noqa: F401 (autouse fixture)
    jax_payload, one_torch_thread, port_payload,
)

OUTS = ("dx", "du", "dsu_lo", "dsu_up", "dlu_lo", "dlu_up", "dsx_lo", "dsx_up",
        "dlx_lo", "dlx_up", "ap", "ad", "comp4", "res2")
REF_KEYS = keys(("iter",), OUTS, computed=("args",))  # the port's start


@pytest.fixture(scope="module")
def qp_case():
    """The payload (12 tensors) and the JAX package's SparseQpConsts."""
    qp, consts, dx0 = jax_payload(SEED)
    qp_t, dx0_t = port_payload(qp, dx0)
    return tuple(qp_t) + (dx0_t,), consts


def test_one_iteration_matches_jax(qp_case):
    qp_t, consts = qp_case
    ic = ipm_consts(PortConfig().ocp)
    args = testing.iter_args(qp_t, ic)
    kw = dict(h=ic["h"], diag6_stage=ic["diag6_stage"], diag6_term=ic["diag6_term"],
              rdiag_stage=ic["rdiag_stage"], tau=ic["tau"])
    assert kw["h"] == pytest.approx(consts.h, rel=1e-12)
    rec = Recording("test_torch_riccati_iter")
    rec.check_inputs("iter", args=args)
    got = t_iter(*args, **kw)
    assert len(got) == len(OUTS)
    for name, g in zip(OUTS, got):
        g, r = g.numpy(), rec("iter", name)
        assert g.shape == r.shape, name
        scale = float(np.abs(r).max())
        if name.startswith("dl") or name == "comp4":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
        elif name == "res2":
            assert scale > 1e-6  # the jitter put the defects above rounding level
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=2e-5 * max(1.0, scale), err_msg=name)
