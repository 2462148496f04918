"""PyTorch port vs JAX: the dense OCP linearizations (`solver/ocp.py`,
`solver/ocp_packed.py`), on the CPU.

- `make_ocp_functions` (the scan controller's batch-first QpData) against
  the vmapped JAX function in f64 at rtol 1e-10: the same residuals and
  Jacobians (JAX's `jacfwd`, the port's closed-form forward-mode tangents),
  rounded in another order. One scenario without the batch axis gives the
  batched result's row.
- `make_ocp_functions_packed` (the legacy dense path's kernel-layout
  payload) against the JAX function at B=1024 (one JAX block) in f32, at
  `tests/test_ocp_packed.py`'s tolerances.
- The GN cross block Hxu is exactly zero (the dense kernels K8/K9 take it
  as zero), and the residuals `stage_output` / `terminal_output` agree at
  rtol 1e-12.

Inputs are made with numpy from a seed; both packages get the same arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.ops.pallas.riccati import BLOCK
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.solver.ocp import make_ocp_functions as j_mof
from ndp_nmpc_qd_tpu.solver.ocp import stage_output as j_so
from ndp_nmpc_qd_tpu.solver.ocp import terminal_output as j_to
from ndp_nmpc_qd_tpu.solver.ocp_packed import make_ocp_functions_packed as j_mofp
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp import make_ocp_functions, stage_output, terminal_output
from ndp_nmpc_qd_tpu_torch.solver.ocp_packed import make_ocp_functions_packed

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def iterates(B, seed, dtype):
    """x0 at offsets in [-2, 2] m; iterates off it by random velocities and
    attitudes, controls off hover by random rates; hover references at the
    origin; forces in [-1, 1] N (as `tests/test_ocp_packed.py`)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 10))
    x0[:, 0:3] = rng.uniform(-2.0, 2.0, (B, 3))
    x0[:, 6] = 1.0
    xb = np.repeat(x0[:, None], N + 1, axis=1)
    xb[..., 3:6] += rng.uniform(-1, 1, (B, N + 1, 3))
    xb[..., 6:10] += rng.uniform(-0.1, 0.1, (B, N + 1, 4))
    ur = np.zeros((B, N, 4))
    ur[..., 3] = CFG.vehicle.gravity
    ub = ur.copy()
    ub[..., 0:3] += rng.uniform(-2, 2, (B, N, 3))
    xr = np.zeros((B, N + 1, 10))
    xr[..., 6] = 1.0
    fd = rng.uniform(-1, 1, (B, N + 1, 3))
    return tuple(a.astype(dtype) for a in (xb, ub, xr, ur, fd, x0))


def test_dense_linearization_matches_jax_f64():
    xb, ub, xr, ur, fd, _ = iterates(8, 0, np.float64)
    lin_j, _ = j_mof(JaxConfig().ocp, JaxConfig().vehicle, True)
    want = jax.jit(jax.vmap(lin_j))(xb, ub, xr, ur, fd)
    lin_t, _ = make_ocp_functions(CFG.ocp, CFG.vehicle, True)
    T = torch.tensor
    got = lin_t(T(xb), T(ub), T(xr), T(ur), T(fd))
    ref = convert.qp_from_numpy(jax.tree.map(np.asarray, want), device="cpu")
    for name, g, r in zip(ref._fields, got, ref):
        assert g.dtype == torch.float64 and g.shape == r.shape, name
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12 * scale, msg=name)
    assert float(got.Hxu.abs().max()) == 0.0
    one = lin_t(T(xb[2]), T(ub[2]), T(xr[2]), T(ur[2]), T(fd[2]))
    for name, g, r in zip(ref._fields, one, got):
        torch.testing.assert_close(g, r[2], rtol=0, atol=0, msg=name)
    # the residuals themselves
    q_ref = xr[:, :N, 6:10]
    for got_y, want_y in (
        (stage_output(T(xb[:, :N]), T(ub), T(q_ref)), j_so(xb[:, :N], ub, q_ref)),
        (terminal_output(T(xb), T(xr[..., 6:10])), j_to(xb, xr[..., 6:10])),
    ):
        torch.testing.assert_close(got_y, torch.tensor(np.asarray(want_y)), rtol=1e-12,
                                   atol=1e-12)


def test_packed_linearization_matches_jax():
    B = BLOCK
    xb, ub, xr, ur, fd, x0 = iterates(B, 1, np.float32)
    lin_j, _ = j_mofp(JaxConfig().ocp, JaxConfig().vehicle, True)
    qp_j, dx0_j = jax.jit(lin_j)(xb, ub, xr, ur, fd, x0)
    ref = convert.packed_qp_from_numpy(jax.tree.map(np.asarray, qp_j), B, device="cpu")
    lin_t, _ = make_ocp_functions_packed(CFG.ocp, CFG.vehicle, True)
    T = torch.tensor
    got, dx0_t = lin_t(T(xb), T(ub), T(xr), T(ur), T(fd), T(x0))
    # tests/test_ocp_packed.py's tolerances (there against the dense path)
    atol = dict(hxx=2e-4, huu=1e-5, gx=2e-4, gu=1e-5, a=1e-5, b=1e-5, r=1e-5, lu=1e-6,
                uu=1e-6, lx=1e-6, ux=1e-6)
    for name, g, r in zip(ref._fields, got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape == (r.shape[0], r.shape[1], B)
        torch.testing.assert_close(g, r, rtol=0, atol=atol[name], msg=name)
    np.testing.assert_allclose(dx0_t.numpy(), np.asarray(dx0_j).reshape(1, 10, B), atol=1e-6)
