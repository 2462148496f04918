"""PyTorch port vs JAX: one Newton sweep with the row terms given (K6 + K7,
`riccati_sweep_sparse`) and the per-iteration IPM built on it.

The case is `test_glue_fused.py`'s (B=1024, made from a numpy seed: x0 at
offsets in [-3, 3] m, quaternion iterates off hover by 0.2, controls at
hover, a forecast force of scale 0.3) with its first 64 scenarios moved to
the far regime (offsets of 20-30 m), linearized by the port's plain K3 with
an f32 and with a bf16 curvature payload; both packages get that same
payload. The port's plain versions run on the CPU; the JAX side is the
recording `tools/record_jax_refs.py` makes of its kernels in interpret mode
(`jax_refs.py`), the JAX sweep called exactly as its IPM's clipped-LQR
start calls it. Each test first checks that its inputs are those the
recording was made from.

1. K6 + K7 as the clipped-LQR start calls them, f32: the zero iterate, zero
   sig/corr, the controls clipped to the box less a 1e-3 margin, with the
   zero-control hold rollout. K6 + K7 as the unfused glue calls them, bf16
   payload: the per-iteration start moved by 0.01 (normal), sig and corr
   from the port's `ipm_corr_terms`, no clip, no hold. Directions, defects
   and the hold rollout atol 2e-5 of max(1, max|ref|) (the K4/K5 test's,
   `test_torch_riccati_iter.py`). The card test (`test_torch_gpu.py`) holds
   the kernels against these plain versions in all four combinations.
2. The far scenarios take the zero-control fallback of the start.
3. `ipm_sparse(lqr_start=True)`, 4 iterations: cold on the glue-fused
   kernels (K4 + K5), and warm with the glue unfused around one K6 + K7
   sweep per iteration (`fuse_glue=False`), both sides carrying the same
   duals (the port's cold solve's). Tolerances are
   `test_torch_glue_fused.py`'s: zx/zu atol 2e-5 with rtol 1e-5 beside it,
   eq_res rtol 1e-3 / atol 1e-5, carried duals rtol 2e-4 / atol 2e-5 and at
   their own scale (rtol 1e-4, atol 1e-4 max|ref|), with two exceptions,
   each with its reason:
   - mu rtol 1e-3 (`testing.py`'s dual tolerance) where that test has 1e-4:
     the start is a Riccati solve that each side rounds in its own order,
     and in one of the 1024 scenarios the complementarity after the step
     cancels (mu falls from 0.06 to 6e-4 over iterations 2-4), which takes
     a 1e-6 difference of the step to 6.3e-4 of mu (3.8e-7 absolute);
   - the far scenarios: zx/zu within 1e-4 of max(1, max|ref|) and the
     carried duals rtol 1e-3 at their own scale (`testing.py`'s primal and
     dual tolerances). They start from a rollout 20 m off the reference with
     planned velocities at the 20 m/s box and duals up to 400; after 4
     iterations a control differs by up to 2.1e-4 (of |zu| up to 17) and a
     dual near 200 by 1e-3, where the nominal scenarios agree within 7e-6.
"""

import numpy as np
import pytest
import torch

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels.linearize import linearize_stage_data_plain
from ndp_nmpc_qd_tpu_torch.ops.kernels.riccati_sparse import riccati_sweep_sparse as t_sweep
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import SparseQp, ipm_consts, lin_consts, sparse_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import (
    IpmWarm, lqr_start_point, sparse_rollout_zero_u,
)
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse as t_ipm

B = 1024
N_FAR = 64
SWEEP = ("dx", "du", "rhat", "dx_hold")
# the solution, then the carried duals (`warm_` and the IpmWarm field)
SOLUTION = ("zx", "zu", "mu", "eq_res") + tuple(f"warm_{f}" for f in IpmWarm._fields)
# every input is the port's (its K3's payload, its sweep arguments and
# duals), so the recording holds fingerprints of them
REF_KEYS = (keys(("lqr_sweep",), SWEEP, computed=("payload",))
            + keys(("unfused_sweep_bf16",), SWEEP[:3], computed=("payload", "args"))
            + keys(("ipm_cold",), SOLUTION, computed=("payload",))
            + keys(("ipm_warm",), SOLUTION, computed=("payload", "warm")))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version runs many small ops on (B,) tensors; intra-op
    threads only add overhead there and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rec():
    return Recording("test_torch_riccati_sweep")


def payload(jac_bf16):
    """The case's payload from the port's plain K3: the 12 tensors of
    `linearize_stage_data`, which both packages get."""
    cfg = PortConfig()
    N = cfg.ocp.N_node
    rng = np.random.default_rng(3)
    pos = rng.uniform(-3.0, 3.0, (B, 3))
    far = rng.standard_normal((N_FAR, 3))
    pos[:N_FAR] = far * (rng.uniform(20.0, 30.0, (N_FAR, 1))
                         / np.linalg.norm(far, axis=1, keepdims=True))
    xr = torch.zeros(N + 1, 10, B)
    xr[:, 6] = 1.0
    xb = xr.clone()
    xb[:, 6:10] += torch.tensor(0.2 * rng.standard_normal((N + 1, 4, B)), dtype=torch.float32)
    ur = torch.zeros(N, 4, B)
    ur[:, 3] = cfg.vehicle.gravity
    fd = torch.tensor(0.3 * rng.standard_normal((N + 1, 3, B)), dtype=torch.float32)
    x0 = xr[:1].clone()
    x0[0, 0:3] = torch.tensor(pos.T, dtype=torch.float32)
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
    return linearize_stage_data_plain(xb, ur, xr, ur, fd, x0, **lc)


def port_case(qp_t):
    """A payload as (its 12 tensors, (SparseQp, consts, dx0))."""
    return qp_t, (SparseQp(*qp_t[:11]), sparse_consts(PortConfig().ocp), qp_t[11])


@pytest.fixture(scope="module")
def qp_case():
    """The f32 payload."""
    return port_case(payload(False))


def sweep_kw(ic):
    return dict(h=ic["h"], diag6_stage=ic["diag6_stage"], diag6_term=ic["diag6_term"],
                rdiag_stage=ic["rdiag_stage"])


def assert_sweep(got, rec, case, names):
    assert len(got) == len(names)
    for name, g in zip(names, got):
        g, r = g.numpy(), rec(case, name)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=2e-5 * max(1.0, float(np.abs(r).max())),
                                   err_msg=name)


def test_lqr_start_sweep_matches_jax(qp_case, rec):
    """K6 + K7 at the clipped-LQR start, f32; the JAX sweep called as its
    IPM calls it. The defects at the zero iterate are exactly the payload's
    r, and the clip is active and respected."""
    qp_t, (p_t, sc, dx0_t) = qp_case
    rec.check_inputs("lqr_sweep", payload=qp_t)
    ic = ipm_consts(PortConfig().ocp)
    args, hold = testing.sweep_args(tuple(p_t) + (dx0_t,), ic, "lqr_start")
    got = t_sweep(*args, **sweep_kw(ic), with_hold=hold)
    assert_sweep(got, rec, "lqr_sweep", SWEEP)
    lo, hi, du = args[14].numpy(), args[15].numpy(), got[1].numpy()
    assert (du >= lo).all() and (du <= hi).all()
    assert (du == lo).any() or (du == hi).any()  # the clip is active somewhere
    np.testing.assert_array_equal(got[2].numpy(), p_t.r.numpy())


def test_unfused_sweep_matches_jax_bf16(rec):
    """K6 + K7 as the unfused glue calls them, bf16 curvature payload."""
    qp_t = payload(True)
    assert qp_t[3].dtype == torch.bfloat16
    ic = ipm_consts(PortConfig().ocp)
    args, hold = testing.sweep_args(qp_t, ic, "unfused_glue")
    assert not hold and args[14] is None
    rec.check_inputs("unfused_sweep_bf16", payload=qp_t, args=args[:14])
    got = t_sweep(*args, **sweep_kw(ic))
    assert_sweep(got, rec, "unfused_sweep_bf16", SWEEP[:3])


def test_far_regime_scenarios_take_the_zero_control_start(qp_case):
    _, (p_t, sc, dx0_t) = qp_case
    zx, zu, v_feasible = lqr_start_point(p_t, sc, dx0_t)
    assert not bool(v_feasible[:N_FAR].all()), "no far scenario fell back"
    assert bool(v_feasible[N_FAR:].all())
    fell = ~v_feasible
    assert bool((zu[..., fell] == 0).all())
    # the fallback is the dynamics-exact zero-control rollout
    torch.testing.assert_close(zx[..., fell], sparse_rollout_zero_u(p_t, sc, dx0_t)[..., fell],
                               rtol=0, atol=0)


def solve(case, warm, fuse_glue):
    _, (p_t, sc, dx0_t) = case
    return t_ipm(p_t, sc, dx0_t, num_iters=4, warm=warm, lqr_start=True, fuse_glue=fuse_glue)


def assert_solution(out_t, rec, case):
    """The nominal scenarios at the tolerances above, the far ones at theirs."""
    zx_t, zu_t, mu_t, eq_t, w_t = out_t
    ref_of = lambda name: rec(case, name)
    near, far = (..., slice(N_FAR, None)), (..., slice(0, N_FAR))
    for name, got in (("zu", zu_t.numpy()), ("zx", zx_t.numpy())):
        ref = ref_of(name)
        np.testing.assert_allclose(got[near], ref[near], rtol=1e-5, atol=2e-5,
                                   err_msg=f"{case} {name}")
        np.testing.assert_allclose(got[far], ref[far], atol=1e-4 * max(1.0, float(abs(ref).max())),
                                   err_msg=f"{case} {name}, far")
    np.testing.assert_allclose(mu_t.numpy(), ref_of("mu"), rtol=1e-3, atol=1e-7, err_msg=case)
    np.testing.assert_allclose(eq_t.numpy(), ref_of("eq_res"), rtol=1e-3, atol=1e-5, err_msg=case)
    for name, got in zip(IpmWarm._fields, w_t):
        got, ref = got.numpy(), ref_of(f"warm_{name}")
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got[near], ref[near], rtol=2e-4, atol=2e-5,
                                   err_msg=f"{case} {name}")
        np.testing.assert_allclose(got[near], ref[near], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"{case} {name}")
        np.testing.assert_allclose(got[far], ref[far], rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=f"{case} {name}, far")


def test_lqr_start_ipm_matches_jax_cold(qp_case, rec):
    rec.check_inputs("ipm_cold", payload=qp_case[0])
    assert_solution(solve(qp_case, None, fuse_glue=True), rec, "ipm_cold")


def test_lqr_start_unfused_ipm_matches_jax_warm(qp_case, rec):
    """Both sides carry the same duals: the port's cold solve's."""
    w = solve(qp_case, None, fuse_glue=False)[4]
    rec.check_inputs("ipm_warm", payload=qp_case[0], warm=w)
    assert_solution(solve(qp_case, w, fuse_glue=False), rec, "ipm_warm")
