"""PyTorch port vs JAX: the stage linearization (K3, `linearize_stage_data`).

The JAX side is `make_linearizer_pallas`, whose Pallas kernel runs in
interpret mode; the port runs `make_linearizer` on the CPU, i.e. the plain
version of its kernel. Same numpy inputs (the case of `test_lin_kernel.py`,
B=1024), with and without the downwash input. Every SparseQp field is held
at `test_lin_kernel.py:67-73`'s bound, err / max(1, max|ref|) < 5e-6, and
dx0 at 1e-5. With bf16 Jacobians the curvature fields hq/a/b are bf16 on
both sides (the dtypes of `test_lin_kernel.py:100-112`) and agree within one
bf16 ulp (2^-8) of max(1, max|ref|), since an f32 difference of an ulp may
flip the rounding; the other fields stay f32 and are held as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_linearizer_pallas
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import make_linearizer

B = 1024
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version runs many small ops on (B,) tensors; intra-op
    threads only add overhead there and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Hover references at the origin, x0 at offsets in [-3, 3] m, iterates
    off the reference (quaternions by 0.2, positions/velocities by 0.5,
    body rates by +0.3), a forecast force of scale 0.5 (numpy, f32)."""
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    rng = np.random.default_rng(7)
    hover = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
    x0 = np.tile(hover, (B, 1))
    x0[:, 0:3] = rng.uniform(-3.0, 3.0, (B, 3))
    xr = np.tile(hover, (B, N + 1, 1))
    xb = xr.copy()
    xb[:, :, 6:10] += 0.2 * rng.standard_normal((B, N + 1, 4))
    xb[:, :, 0:6] += 0.5 * rng.standard_normal((B, N + 1, 6))
    ur = np.tile(np.array([0, 0, 0, cfg.vehicle.gravity], np.float32), (B, N, 1))
    ub = ur.copy()
    ub[:, :, 0:3] += 0.3
    f = (0.5 * rng.standard_normal((B, N + 1, 3))).astype(np.float32)
    return cfg, (xb, ub, xr, ur, f, x0)


def lanes(a):
    """A JAX kernel-layout array (s, d, nb, SUB, 128) as (s, d, B)."""
    a = np.asarray(a.astype(jnp.float32))
    return a.reshape(a.shape[0], a.shape[1], -1)[..., :B]


def run_both(cfg, arrays, with_dist, jac_bf16):
    xb, ub, xr, ur, f, x0 = arrays
    fd = f if with_dist else None
    lin_j, consts_j, _ = make_linearizer_pallas(
        cfg.ocp, cfg.vehicle, with_dist,
        jac_dtype=jnp.bfloat16 if jac_bf16 else None, interpret=True,
    )
    qj, dj = lin_j(*(None if a is None else jnp.asarray(a) for a in (xb, ub, xr, ur, fd, x0)))
    pcfg = PortConfig()
    lin_t, consts_t = make_linearizer(pcfg.ocp, pcfg.vehicle, with_dist, jac_bf16=jac_bf16)
    qt, dt = lin_t(*(None if a is None else torch.as_tensor(a) for a in (xb, ub, xr, ur, fd, x0)))
    assert consts_t.h == pytest.approx(consts_j.h, rel=1e-12)
    for name in ("diag6_stage", "diag6_term", "rdiag_stage"):
        np.testing.assert_allclose(getattr(consts_t, name), getattr(consts_j, name), rtol=1e-12)
    return qj, dj, qt, dt


def held(got, ref, bound):
    err = np.max(np.abs(got.astype(np.float64) - ref))
    return err / max(1.0, float(np.max(np.abs(ref)))) < bound, err


@pytest.mark.parametrize("with_dist", [True, False])
def test_linearization_matches_jax(case, with_dist):
    cfg, arrays = case
    qj, dj, qt, dt = run_both(cfg, arrays, with_dist, jac_bf16=False)
    assert qt._fields == qj._fields
    for name in qj._fields:
        got = getattr(qt, name)
        assert got.dtype == torch.float32, name
        ok, err = held(got.numpy(), lanes(getattr(qj, name)).astype(np.float64), 5e-6)
        assert ok, (name, err)
    assert np.max(np.abs(dt.numpy() - lanes(dj))) < 1e-5


def test_bf16_jacobians_match_jax(case):
    cfg, arrays = case
    qj, dj, qt, dt = run_both(cfg, arrays, True, jac_bf16=True)
    for name in qj._fields:
        bf16 = name in ("hq", "a", "b")
        got = getattr(qt, name)
        assert getattr(qj, name).dtype == (jnp.bfloat16 if bf16 else jnp.float32), name
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        ok, err = held(got.float().numpy(), lanes(getattr(qj, name)).astype(np.float64),
                       BF16_ULP if bf16 else 5e-6)
        assert ok, (name, err)
    assert np.max(np.abs(dt.numpy() - lanes(dj))) < 1e-5
