"""PyTorch port vs JAX: the downwash MLP's trainer (`init_mlp`,
`spectral_normalize`, `make_trainer`, `save_npz`, `load_torch_checkpoint`)
and the port's training tool `tools/train_downwash_torch.py`.

The two trainers start from the same weights (the JAX `init_mlp`'s, carried
across with `from_numpy`) and take full-batch steps on the same numpy data
in f32. optax's `adam` and torch's `Adam` share their defaults, so at the
reference's rate (lr 1e-4, SN 4) weights and biases agree within atol 1e-6
and the loss of every step within rtol 1e-5 over 20 steps. At lr 1e-3 (the
tool's default) Adam scales every component to about +-lr, and the last-ulp
differences of components whose gradient is near zero grow: there only the
losses are held, within rtol 1e-4. Weights near zero make a relative bound
on weights meaningless, so weights are held absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models import downwash_mlp as j_mlp
from ndp_nmpc_qd_tpu_torch.models import downwash_mlp as t_mlp
from test_torch_tools import load_tool


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_of(params):
    return t_mlp.from_numpy([np.asarray(w) for w in params.weights],
                            [np.asarray(b) for b in params.biases], device="cpu")


def toy_data(rng, n=256):
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.stack([x[:, 2] * 0.5, -x[:, 0], x[:, 1] * 0.2], axis=-1).astype(np.float32)
    return x, y


def test_init_mlp_shapes_bounds_and_seed():
    sizes = t_mlp.LAYER_SIZES
    mlp = t_mlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    again = t_mlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    other = t_mlp.init_mlp(torch.Generator().manual_seed(1), device="cpu")
    assert len(mlp.layers) == len(sizes) - 1
    for i, (layer, same, diff) in enumerate(zip(mlp.layers, again.layers, other.layers)):
        assert layer.weight.shape == (sizes[i + 1], sizes[i])
        assert layer.bias.shape == (sizes[i + 1],)
        assert layer.weight.dtype == torch.float32
        bound = 1.0 / np.sqrt(sizes[i])
        for p in (layer.weight.detach(), layer.bias.detach()):
            assert float(p.abs().max()) <= bound
            # a uniform draw fills its interval: the largest |value| is near the bound
            assert float(p.abs().max()) > 0.5 * bound
        torch.testing.assert_close(layer.weight, same.weight, rtol=0, atol=0)
        torch.testing.assert_close(layer.bias, same.bias, rtol=0, atol=0)
        assert not torch.equal(layer.weight, diff.weight)


def test_spectral_normalize_matches_jax():
    params = jax.tree.map(lambda a: a * 10.0, j_mlp.init_mlp(jax.random.PRNGKey(0)))
    want = j_mlp.spectral_normalize(params, 4.0)
    mlp = t_mlp.spectral_normalize(port_of(params), 4.0)
    for layer, w, b in zip(mlp.layers, want.weights, want.biases):
        np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(w), rtol=1e-5)
        np.testing.assert_array_equal(layer.bias.detach().numpy(), np.asarray(b))
        assert float(torch.linalg.matrix_norm(layer.weight.detach(), ord=2)) <= 4.0 + 1e-4
    # sn <= 0 is a no-op; a net inside the ball is left as it is
    same = t_mlp.spectral_normalize(port_of(params), 0.0)
    for layer, w in zip(same.layers, params.weights):
        np.testing.assert_array_equal(layer.weight.detach().numpy(), np.asarray(w))
    small = port_of(j_mlp.init_mlp(jax.random.PRNGKey(0)))
    before = [layer.weight.detach().clone() for layer in small.layers]
    t_mlp.spectral_normalize(small, 4.0)
    for layer, w0 in zip(small.layers, before):
        torch.testing.assert_close(layer.weight.detach(), w0, rtol=0, atol=0)


@pytest.mark.parametrize("lr, hold_weights, loss_rtol", [(1e-4, True, 1e-5), (1e-3, False, 1e-4)])
def test_trainer_matches_jax(lr, hold_weights, loss_rtol, rng):
    x, y = toy_data(rng)
    params = j_mlp.init_mlp(jax.random.PRNGKey(1))
    j_init, j_step, j_loss = j_mlp.make_trainer(sn=4.0, lr=lr)
    t_init, t_step, t_loss = t_mlp.make_trainer(sn=4.0, lr=lr)
    mlp = port_of(params)
    opt_j, opt_t = j_init(params), t_init(mlp)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.as_tensor(x), torch.as_tensor(y)
    with torch.no_grad():
        np.testing.assert_allclose(float(t_loss(mlp, xt, yt)), float(j_loss(params, xj, yj)),
                                   rtol=1e-6)
    for step in range(20):
        params, opt_j, loss_j = j_step(params, opt_j, xj, yj)
        mlp, opt_t, loss_t = t_step(mlp, opt_t, xt, yt)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=loss_rtol,
                                   err_msg=f"step {step}")
    if hold_weights:
        for layer, w, b in zip(mlp.layers, params.weights, params.biases):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    for layer in mlp.layers:
        assert float(torch.linalg.matrix_norm(layer.weight.detach(), ord=2)) <= 4.0 + 1e-4


def test_trainer_fits_toy_function(rng):
    """`tests/test_downwash.py:89-104` on the port: 300 steps at lr 1e-3,
    SN 4; the loss drops below 0.3 of its start and SN holds."""
    mlp = t_mlp.init_mlp(torch.Generator().manual_seed(1), device="cpu")
    init_opt, train_step, loss_fn = t_mlp.make_trainer(sn=4.0, lr=1e-3)
    opt = init_opt(mlp)
    x, y = (torch.as_tensor(a) for a in toy_data(rng))
    with torch.no_grad():
        l0 = float(loss_fn(mlp, x, y))
    for _ in range(300):
        mlp, opt, loss = train_step(mlp, opt, x, y)
    assert float(loss) < 0.3 * l0
    for layer in mlp.layers:
        assert float(torch.linalg.matrix_norm(layer.weight.detach(), ord=2)) <= 4.0 + 1e-3


def test_save_npz_round_trips_through_both_packages(tmp_path):
    mlp = t_mlp.init_mlp(torch.Generator().manual_seed(2), device="cpu")
    path = str(tmp_path / "net.npz")
    t_mlp.save_npz(mlp, path)
    back = t_mlp.load_npz(path, device="cpu")
    jp = j_mlp.load_npz(path)
    for layer, again, w, b in zip(mlp.layers, back.layers, jp.weights, jp.biases):
        torch.testing.assert_close(again.weight, layer.weight, rtol=0, atol=0)
        torch.testing.assert_close(again.bias, layer.bias, rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(w), layer.weight.detach().numpy())
        np.testing.assert_array_equal(np.asarray(b), layer.bias.detach().numpy())


def test_load_torch_checkpoint_reads_a_reference_state_dict(tmp_path, rng):
    """The reference's net is an `nn.Sequential` of Linear and ReLU (keys
    `0.weight` ... `6.bias`); its `state_dict`, saved here, loads into the
    same forward as the Sequential's and as the JAX package's conversion."""
    s = t_mlp.LAYER_SIZES
    with torch.random.fork_rng():
        torch.manual_seed(3)
        ref = torch.nn.Sequential(
            torch.nn.Linear(s[0], s[1]), torch.nn.ReLU(), torch.nn.Linear(s[1], s[2]),
            torch.nn.ReLU(), torch.nn.Linear(s[2], s[3]), torch.nn.ReLU(),
            torch.nn.Linear(s[3], s[4]),
        )
    path = str(tmp_path / "ref.pt")
    torch.save(ref.state_dict(), path)
    mlp = t_mlp.load_torch_checkpoint(path, device="cpu")
    x = torch.as_tensor(rng.standard_normal((32, 6)), dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(mlp(x), ref(x), rtol=0, atol=0)
    want = j_mlp.mlp_forward(j_mlp.load_torch_checkpoint(path), jnp.asarray(x.numpy()))
    with torch.no_grad():
        np.testing.assert_allclose(mlp(x).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_tool_datasets_match_the_jax_tool(tmp_path, rng):
    """`load_csv_dataset` splits the same CSVs row for row as
    `tools/train_downwash.py`'s (`tests/test_downwash.py:107-145`), and
    `sample_dataset` draws the same states, with the truth's forces within
    f32 rounding."""
    td_t, td_j = load_tool("train_downwash_torch"), load_tool("train_downwash")
    n = 100
    np.savetxt(tmp_path / "in.csv", rng.standard_normal((n, 6)), delimiter=",")
    np.savetxt(tmp_path / "out.csv", rng.standard_normal((n, 3)), delimiter=",")
    paths = (str(tmp_path / "in.csv"), str(tmp_path / "out.csv"))
    got, want = td_t.load_csv_dataset(*paths), td_j.load_csv_dataset(*paths)
    assert [a.shape for a in got] == [(75, 6), (75, 3), (25, 6), (25, 3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    (xg, yg), (xw, yw) = td_t.sample_dataset(512, seed=0), td_j.sample_dataset(512, seed=0)
    np.testing.assert_array_equal(xg, xw)
    np.testing.assert_allclose(yg, yw, rtol=1e-5, atol=1e-6)


def test_training_tool_on_the_cpu(tmp_path):
    """`train_downwash_torch.py --cpu` on a small set: it saves a net that
    the port's `load_npz` reads and its loss curves; the CSV route trains
    the same way."""
    td = load_tool("train_downwash_torch")
    out, curves = str(tmp_path / "net.npz"), str(tmp_path / "curves.png")
    td.main(["--cpu", "--epochs", "30", "--n-train", "512", "--out", out, "--curves", curves])
    mlp = t_mlp.load_npz(out, device="cpu")
    for layer in mlp.layers:
        assert float(torch.linalg.matrix_norm(layer.weight.detach(), ord=2)) <= 4.0 + 1e-4
    assert os.path.getsize(curves) > 0
    rng = np.random.default_rng(0)
    np.savetxt(tmp_path / "in.csv", rng.standard_normal((40, 6)), delimiter=",")
    np.savetxt(tmp_path / "out.csv", rng.standard_normal((40, 3)), delimiter=",")
    td.main(["--cpu", "--epochs", "5", "--sn", "0", "--input-csv", str(tmp_path / "in.csv"),
             "--output-csv", str(tmp_path / "out.csv"), "--out", str(tmp_path / "csv.npz")])
    assert os.path.exists(tmp_path / "csv.npz")
