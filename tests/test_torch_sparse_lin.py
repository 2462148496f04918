"""PyTorch port vs JAX: the tensor-op sparse linearizer (`fused_lin=False`).

The port's `make_ocp_functions_sparse` is held against the JAX package's at
B=1024 (the JAX BLOCK) on the inputs of `test_lin_kernel.py` (numpy, seed
7), in f64 and f32, with and without the forecast, every SparseQp field and
dx0: err / max(1, max|ref|) < 1e-12 in f64 and < 5e-6 in f32
(`test_lin_kernel.py:67-73`'s bound; the tangents' products round in
another order). Then, within the port:
- the dense A and B rebuilt from the payload (`a_dense_from_sparse`,
  `b_dense_from_sparse`) and the other fields against the dense
  linearizer `ocp.make_ocp_functions`, at `test_sparse_path.py:63-90`'s
  tolerances (inputs of `test_sparse_path.py`'s kind, seed 0), and the
  returned `phi`'s defects with r's;
- `jac_bf16` narrows only hq, a and b (`test_lin_kernel.py:100-112`), to
  the f32 payload rounded to bfloat16;
- K3's plain version (`make_linearizer` on the CPU) against this
  linearizer at `test_lin_kernel.py:55-73`'s bounds;
- one controller update with `fused_lin` True and False
  (`test_lin_kernel.py:76-97`: u0 atol 2e-5, x_bar atol 2e-4, ok equal);
- an odd batch, B=301: its payload equals the first 301 scenarios' of the
  B=1024 run at the f32 bound, and the whole-IPM controller runs healthy;
- `packed_state=True` with `fused_lin=False` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse as jax_sparse
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp import make_ocp_functions
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import (
    a_dense_from_sparse, b_dense_from_sparse, make_linearizer, make_ocp_functions_sparse,
)
from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller

B = 1024
CFG = PortConfig()
N = CFG.ocp.N_node
TOL = {np.float64: 1e-12, np.float32: 5e-6}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops on (B,) tensors: intra-op threads only add overhead
    and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def iterates(seed, dtype, bodyrate_offset=0.3):
    """`test_lin_kernel.py`'s case in numpy: hover references at the origin,
    x0 at offsets in [-3, 3] m, iterates off the reference (quaternions by
    0.2, positions and velocities by 0.5, body rates by +0.3), a forecast
    force of scale 0.5."""
    rng = np.random.default_rng(seed)
    hover = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0], dtype)
    x0 = np.tile(hover, (B, 1))
    x0[:, 0:3] = rng.uniform(-3.0, 3.0, (B, 3))
    xr = np.tile(hover, (B, N + 1, 1))
    xb = xr.copy()
    xb[:, :, 6:10] += 0.2 * rng.standard_normal((B, N + 1, 4))
    xb[:, :, 0:6] += 0.5 * rng.standard_normal((B, N + 1, 6))
    ur = np.tile(np.array([0, 0, 0, CFG.vehicle.gravity], dtype), (B, N, 1))
    ub = ur.copy()
    ub[:, :, 0:3] += bodyrate_offset
    f = (0.5 * rng.standard_normal((B, N + 1, 3))).astype(dtype)
    return xb, ub, xr, ur, f, x0


def torch_in(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def lanes(a):
    """A JAX kernel-layout array (s, d, nb, SUB, 128) as (s, d, B)."""
    a = np.asarray(a.astype(jnp.float64) if a.dtype == jnp.bfloat16 else a)
    return a.reshape(a.shape[0], a.shape[1], -1)[..., :B]


def scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("with_dist", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_payload_matches_jax(dtype, with_dist):
    arrays = list(iterates(7, dtype))
    if not with_dist:
        arrays[4] = None
    jcfg = NdpNmpcConfig()
    lin_j, consts_j, _ = jax_sparse(jcfg.ocp, jcfg.vehicle, with_dist)
    qj, dj = jax.jit(lin_j)(*(None if a is None else jnp.asarray(a) for a in arrays))
    lin_t, consts_t, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, with_dist)
    qt, dt = lin_t(*torch_in(arrays))
    for got, ref in zip(consts_t, consts_j):
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    for name in qj._fields:
        got, ref = getattr(qt, name), lanes(getattr(qj, name))
        assert got.shape == ref.shape, name
        assert got.dtype == getattr(torch, np.dtype(dtype).name), name
        assert scaled(got, ref) < TOL[dtype], (name, scaled(got, ref))
    assert float(np.abs(dt.double().numpy() - lanes(dj)).max()) <= TOL[dtype]


def test_bf16_narrows_only_the_curvature():
    arrays = torch_in(iterates(7, np.float32))
    lin, _, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, True)
    lin16, _, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, True, jac_bf16=True)
    q32, d32 = lin(*arrays)
    q16, d16 = lin16(*arrays)
    for name in q16._fields:
        want = torch.bfloat16 if name in ("hq", "a", "b") else torch.float32
        assert getattr(q16, name).dtype == want, name
        torch.testing.assert_close(getattr(q16, name), getattr(q32, name).to(want),
                                   rtol=0, atol=0)
    torch.testing.assert_close(d16, d32, rtol=0, atol=0)


def test_dense_reconstruction_matches_dense_linearizer():
    """`test_sparse_path.py:63-90`: A, B and r atol 2e-6, the quaternion
    Hessian block atol 1e-3, gx rtol 1e-5 / atol 1e-4, gu rtol 1e-5 / atol
    1e-5, the bounds atol 1e-6; and the parts the payload does not store
    are the claimed constants (`test_sparse_path.py:94-101`)."""
    xb, ub, xr, ur, f, x0 = torch_in(iterates(0, np.float32))
    lin_s, consts, phi = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, True)
    qs, _ = lin_s(xb, ub, xr, ur, f, x0)
    lin_d, _ = make_ocp_functions(CFG.ocp, CFG.vehicle, True)
    qd = lin_d(xb, ub, xr, ur, f)
    un = lambda t, *d: t.permute(2, 0, 1).reshape((B, t.shape[0]) + d)
    A = a_dense_from_sparse(un(qs.a, 40), consts.h)
    Bm = b_dense_from_sparse(un(qs.b, 30), un(qs.bc, 6))
    close = lambda got, ref, **tol: torch.testing.assert_close(got, ref, **tol)
    close(A, qd.A, rtol=0, atol=2e-6)
    close(Bm, qd.B, rtol=0, atol=2e-6)
    close(un(qs.hq, 4, 4), qd.Hxx[..., 6:10, 6:10], rtol=0, atol=1e-3)
    close(un(qs.gx, 10), qd.gx, rtol=1e-5, atol=1e-4)
    close(un(qs.gu, 4), qd.gu, rtol=1e-5, atol=1e-5)
    close(un(qs.r, 10), qd.r, rtol=0, atol=2e-6)
    close(phi(xb[:, :N], ub, f[:, :N]) - xb[:, 1:], qd.r, rtol=0, atol=2e-6)
    for name in ("lu", "uu", "lx", "ux"):
        got = getattr(qs, name)
        close(un(got, got.shape[1]), getattr(qd, name), rtol=0, atol=1e-6)
    eye = torch.eye(3).expand(B, N, 3, 3)
    close(qd.A[..., 0:3, 0:3], eye, rtol=0, atol=1e-6)
    close(qd.A[..., 0:3, 3:6], consts.h * eye, rtol=0, atol=1e-6)
    close(qd.A[..., 3:10, 0:3], torch.zeros(B, N, 7, 3), rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_dist", [True, False])
def test_kernel_plain_version_matches(with_dist):
    """K3's plain version against the tensor-op linearizer,
    `test_lin_kernel.py:55-73`: every field at the scaled 5e-6, dx0 1e-5."""
    arrays = iterates(7, np.float32)
    fd = arrays[4] if with_dist else None
    ins = torch_in(arrays[:4] + (fd, arrays[5]))
    lin_k, consts_k = make_linearizer(CFG.ocp, CFG.vehicle, with_dist)
    lin_j, consts_j, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, with_dist)
    assert consts_k == consts_j
    qk, dk = lin_k(*ins)
    qj, dj = lin_j(*ins)
    for name in qj._fields:
        assert scaled(getattr(qk, name), getattr(qj, name)) < 5e-6, name
    assert float((dk - dj).abs().max()) < 1e-5


def controller_pair(arrays, **flags):
    """One update of the fused-lin and the tensor-op-lin controllers from
    the reference, on the same inputs."""
    xb, ub, xr, ur, f, x0 = torch_in(arrays)
    kw = dict(with_disturbance=True, backend="pallas", device="cpu", **flags)
    out = []
    for fused in (True, False):
        ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, fused_lin=fused, **kw)
        out.append(ctl.update(ctl.reset(xr, ur), x0, xr, ur, f))
    return out


def test_controller_fused_and_tensor_linearizer_agree():
    """`test_lin_kernel.py:76-97`: the per-iteration IPM at 4 iterations from
    the clipped-LQR start."""
    (u_f, st_f, info_f), (u_j, st_j, info_j) = controller_pair(
        iterates(7, np.float32), qp_iters=4)
    torch.testing.assert_close(u_f, u_j, rtol=0, atol=2e-5)
    torch.testing.assert_close(st_f.x_bar, st_j.x_bar, rtol=0, atol=2e-4)
    assert torch.equal(info_f.ok, info_j.ok)


def test_odd_batch():
    """B=301: the payload equals the first 301 scenarios' of the B=1024
    run; the deployed-flag whole-IPM controller (warm@3, bf16) on the
    tensor-op linearizer runs, every scenario finite and healthy."""
    arrays = iterates(7, np.float32)
    lin, _, _ = make_ocp_functions_sparse(CFG.ocp, CFG.vehicle, True)
    q_full, d_full = lin(*torch_in(arrays))
    q_odd, d_odd = lin(*torch_in(a[:301] for a in arrays))
    for name in q_odd._fields:
        got = getattr(q_odd, name)
        assert got.shape[-1] == 301
        assert scaled(got, getattr(q_full, name)[..., :301]) < 5e-6, name
    assert float((d_odd - d_full[..., :301]).abs().max()) < 1e-5

    xb, ub, xr, ur, f, x0 = torch_in(a[:301] for a in iterates(7, np.float32, 0.0))
    x0[:, 0:3] /= 3.0  # offsets within 1 m, the bench's operating point
    ctl = make_batched_rti_controller(
        CFG.ocp, CFG.vehicle, with_disturbance=True, qp_iters=3, warm_start=True,
        jac_bf16=True, whole_ipm=True, fused_lin=False, device="cpu")
    st = ctl.reset(xr, ur)
    for _ in range(3):
        u0, st, info = ctl.update(st, x0, xr, ur, f)
    assert u0.shape == (301, 4) and bool(torch.isfinite(u0).all())
    assert bool(info.ok.all()), int((~info.ok).sum())


def test_packed_state_needs_the_fused_linearizer():
    with pytest.raises(ValueError, match="packed_state requires the fused linearizer"):
        make_batched_rti_controller(CFG.ocp, CFG.vehicle, packed_state=True, whole_step=False,
                                    fused_lin=False, device="cpu")
