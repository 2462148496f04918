"""PyTorch port vs JAX: the downwash MLP and its gated forecast."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models import downwash_mlp as j_mlp
from ndp_nmpc_qd_tpu_torch.convert import mlp_from_numpy
from ndp_nmpc_qd_tpu_torch.models import downwash_mlp as t_mlp


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ASSET = os.path.join(
    os.path.dirname(__file__), "..", "assets", "downwash_analytic_sn4.npz"
)


@pytest.fixture(autouse=True)
def _no_tf32():
    # f32 products in full precision (matters on the card; stated for both)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _random_params(rng):
    sizes = t_mlp.LAYER_SIZES
    ws = [rng.uniform(-1, 1, (sizes[i + 1], sizes[i])).astype(np.float32)
          / np.sqrt(sizes[i]) for i in range(len(sizes) - 1)]
    bs = [rng.uniform(-0.1, 0.1, sizes[i + 1]).astype(np.float32)
          for i in range(len(sizes) - 1)]
    return ws, bs


def _pair(ws, bs):
    jp = j_mlp.MlpParams(tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs))
    return jp, mlp_from_numpy(ws, bs, device="cpu")


def test_f32_forward_matches_jax(rng):
    ws, bs = _random_params(rng)
    jp, mlp = _pair(ws, bs)
    x = rng.standard_normal((64, 21, 6)).astype(np.float32)
    with torch.no_grad():
        got = mlp(torch.as_tensor(x)).numpy()
    want = np.asarray(j_mlp.mlp_forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bf16_forward_within_one_percent_of_force_scale(rng):
    """bf16 rounding sits at other places in XLA-CPU and torch-CPU, so the
    two bf16 paths agree to 1% of the force scale, not to the bit."""
    jp = j_mlp.load_npz(ASSET)
    mlp = t_mlp.load_npz(ASSET, device="cpu")
    x = rng.uniform(-1.0, 1.0, (64, 21, 6)).astype(np.float32)
    want = np.asarray(j_mlp.mlp_forward(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = mlp(torch.as_tensor(x), torch.bfloat16)
    assert got.dtype == torch.float32
    scale = np.abs(np.asarray(j_mlp.mlp_forward(jp, jnp.asarray(x)))).max()
    assert np.abs(got.numpy() - want).max() <= 0.01 * scale


def test_load_npz_gives_identical_forward(rng):
    jp = j_mlp.load_npz(ASSET)
    mlp = t_mlp.load_npz(ASSET, device="cpu")
    for w, layer in zip(jp.weights, mlp.layers):
        np.testing.assert_array_equal(layer.weight.detach().numpy(), np.asarray(w))
    x = rng.standard_normal((32, 6)).astype(np.float32)
    with torch.no_grad():
        got = mlp(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_mlp.mlp_forward(jp, jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("offset_x, use_gate_pos", [
    (0.0, False), (5.0, False), (0.0, True), (0.6, True),
])
def test_predict_downwash_gate_matches_jax(offset_x, use_gate_pos, rng):
    """Inside / outside r_horiz, and the ego position vs the default (the ego
    horizon's first node) as the gate's centre."""
    jp = j_mlp.load_npz(ASSET)
    mlp = t_mlp.load_npz(ASSET, device="cpu")
    ego = np.zeros((4, 21, 10), np.float32)
    ego[..., 6] = 1.0
    other = ego.copy()
    other[..., 2] += 1.0
    other[..., 0] += offset_x
    other[1, :, 0] += 3.0  # one scenario always outside
    gate = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32) if use_gate_pos else None
    want = np.asarray(j_mlp.predict_downwash(
        jp, jnp.asarray(other), jnp.asarray(ego), r_horiz=1.0,
        ego_gate_pos=None if gate is None else jnp.asarray(gate),
    ))
    with torch.no_grad():
        got = t_mlp.predict_downwash(
            mlp, torch.as_tensor(other), torch.as_tensor(ego), r_horiz=1.0,
            ego_gate_pos=None if gate is None else torch.as_tensor(gate),
        ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], 0.0)
    if offset_x == 0.0:
        assert np.abs(got[0]).max() > 0
