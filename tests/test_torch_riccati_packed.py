"""PyTorch port vs JAX: the dense Riccati sweep of the legacy packed path
(`ops/kernels/riccati.py`, K8 + K9), on the CPU (the plain versions).

- The clipped form (zero sig, the controls clipped into the box less a 1e-3
  margin, as `ipm_packed` starts) against the JAX Pallas kernels
  `riccati_sweep_packed` in interpret mode at B=1024 (one JAX block), read
  from the recording `tools/record_jax_refs.py` makes of them, at
  `tests/test_pallas_riccati.py`'s atol 5e-5 (both f32; the plain version
  contracts with einsum, the Pallas kernel element by element).
- The Newton form (nonzero sig, defects rhat, no clip) against the vmapped
  JAX scan solve `qp_ipm.riccati_solve`, the JAX package's own reference for
  these kernels: in f64 at rtol 1e-10 (the same algebra, rounded in another
  order) and in f32 at atol 5e-5.
- A NaN in dx0 stays NaN through the clip (NaN-propagating min/max), and
  poisons only its own scenario.

The QP data is the port's dense linearization (`solver/ocp.py`, itself held
against JAX in `test_torch_ocp_dense.py`) at inputs made with numpy from a
seed; both packages get the same arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu.solver import qp_ipm as j_qp
from ndp_nmpc_qd_tpu.solver.ocp import QpData as JQpData
from ndp_nmpc_qd_tpu_torch.ops.kernels import riccati as t_ric
from ndp_nmpc_qd_tpu_torch.ops.layout import pack, unpack
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp import make_ocp_functions
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_packed import pack_qp

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
BLOCK = 1024  # one block of the JAX kernels: 8 sublanes of 128 lanes
REF_KEYS = keys(("clipped",), ("dx", "du"), computed=("args", "clip"))  # the port's QP


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dense_qp(B, seed, dtype):
    """The port's dense QP at a perturbed iterate around hover references,
    with x0 at random offsets in [-3, 3] m; returns (QpData, dx0 (B, 10))."""
    rng = np.random.default_rng(seed)
    xr = np.zeros((B, N + 1, 10))
    xr[..., 6] = 1.0
    xb = xr.copy()
    xb[..., 0:6] += 0.2 * rng.standard_normal((B, N + 1, 6))
    xb[..., 6:10] += 0.05 * rng.standard_normal((B, N + 1, 4))
    ur = np.zeros((B, N, 4))
    ur[..., 3] = CFG.vehicle.gravity
    ub = ur + 0.2 * rng.standard_normal((B, N, 4))
    fd = 0.3 * rng.standard_normal((B, N + 1, 3))
    x0 = xb[:, 0].copy()
    x0[:, 0:3] = rng.uniform(-3.0, 3.0, (B, 3))
    lin, _ = make_ocp_functions(CFG.ocp, CFG.vehicle, True)
    T = lambda a: torch.tensor(a, dtype=dtype)
    return lin(T(xb), T(ub), T(xr), T(ur), T(fd)), T(x0 - xb[:, 0])


def clipped_args(B):
    """The clipped sweep's arguments over the port's f32 QP at seed 0, and
    its clip bounds."""
    qp, dx0 = dense_qp(B, 0, torch.float32)
    p = pack_qp(qp)
    margin = 1e-3 * (p.uu - p.lu)
    args = (p.hxx, torch.zeros_like(p.gx), p.huu, torch.zeros_like(p.gu), p.gx, p.gu, p.a,
            p.b, p.r, pack(dx0[:, None]))
    return args, (p.lu + margin, p.uu - margin)


def test_clipped_sweep_matches_jax_kernel():
    args, (lo, hi) = clipped_args(BLOCK)
    rec = Recording("test_torch_riccati_packed")
    rec.check_inputs("clipped", args=args, clip=(lo, hi))
    dx_t, du_t = t_ric.riccati_sweep_packed(*args, clip_lo=lo, clip_hi=hi)
    np.testing.assert_allclose(du_t.numpy(), rec("clipped", "du"), atol=5e-5)
    np.testing.assert_allclose(dx_t.numpy(), rec("clipped", "dx"), atol=5e-5)
    # the clip is active somewhere, so the test holds K9's clip too
    assert bool(((du_t <= lo + 1e-6) | (du_t >= hi - 1e-6)).any())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 5e-5)])
def test_newton_sweep_matches_jax_riccati_solve(dtype, tol):
    B = 48
    qp, dx0 = dense_qp(B, 1, dtype)
    rng = np.random.default_rng(2)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    sig_u = rng.uniform(0.0, 2.0, (B, N, 4)).astype(np_dt)
    sig_x = rng.uniform(0.0, 2.0, (B, N + 1, 3)).astype(np_dt)
    ghx = rng.standard_normal((B, N + 1, 10)).astype(np_dt)
    ghu = rng.standard_normal((B, N, 4)).astype(np_dt)
    rhat = (0.1 * rng.standard_normal((B, N, 10))).astype(np_dt)
    d0 = dx0.numpy()
    jqp = JQpData(*(jnp.asarray(t.numpy()) for t in qp))
    dx_j, du_j = jax.jit(jax.vmap(j_qp.riccati_solve))(jqp, sig_u, sig_x, ghx, ghu, rhat, d0)

    sx10 = np.zeros((B, N + 1, 10), np_dt)
    sx10[..., 3:6] = sig_x
    p = pack_qp(qp)
    T = lambda a: pack(torch.tensor(a))
    dx_t, du_t = t_ric.riccati_sweep_packed(
        p.hxx, T(sx10), p.huu, T(sig_u), T(ghx), T(ghu), p.a, p.b, T(rhat), pack(dx0[:, None]))
    for got, ref in ((unpack(dx_t, (10,)), dx_j), (unpack(du_t, (4,)), du_j)):
        ref = np.asarray(ref)
        if dtype == torch.float64:
            np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                                       atol=1e-12 * max(1.0, float(np.abs(ref).max())))
        else:
            np.testing.assert_allclose(got.numpy(), ref, atol=tol)


def test_nan_in_dx0_stays_nan_through_the_clip():
    B = 4
    qp, dx0 = dense_qp(B, 3, torch.float32)
    dx0[1, 4] = float("nan")
    p = pack_qp(qp)
    margin = 1e-3 * (p.uu - p.lu)
    dx, du = t_ric.riccati_sweep_packed(
        p.hxx, torch.zeros_like(p.gx), p.huu, torch.zeros_like(p.gu), p.gx, p.gu, p.a, p.b,
        p.r, pack(dx0[:, None]), clip_lo=p.lu + margin, clip_hi=p.uu - margin)
    assert bool(du[..., 1].isnan().all()) and bool(dx[1:, :, 1].isnan().all())
    keep = [0, 2, 3]
    assert bool(torch.isfinite(du[..., keep]).all()) and bool(torch.isfinite(dx[..., keep]).all())
