"""PyTorch port vs JAX: the motor-thrust mission.

- `make_thrust_episode` against JAX's over 100 ticks (20 of them hold) on
  `test_thrust_model.py:136-141`'s trajectory, f64: every tick's rotor
  thrusts at atol 1e-8 (JAX's read from the plant's actual thrusts, which
  equal the command without a rotor lag), the metrics at rtol 1e-8.
- The CLI mission, `test_thrust_model.py:144-158`: `mission one_qd
  --controller thrust --cpu --track-secs 4 --hold-ticks 30 --scenario
  hover_step` prints `ok` [true] and pos RMSE < 0.1; the other topologies,
  and a kernel backend, are refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.sim.thrust_loop import make_thrust_episode as j_episode
from ndp_nmpc_qd_tpu.traj.polyopt import fit_waypoints as j_fit
from ndp_nmpc_qd_tpu_torch import cli
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.sim.thrust_loop import make_thrust_episode
from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints

CFG = NdpNmpcConfig()
JCFG = JaxConfig()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops at B=1: intra-op threads only add overhead and take the
    CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_episode_matches_jax():
    t = np.linspace(0, 2 * np.pi, 6)
    wpts = np.stack([np.sin(t), 0.5 * np.sin(2 * t), 1.0 + 0.1 * np.sin(t)], -1)
    j_init, j_step, j_run = j_episode(JCFG, j_fit(wpts, np.full(5, 2.5)), hold_ticks=20)

    def body(st, _):
        new, _ = j_step(st)
        return new, new.plant.f_act

    @jax.jit
    def j_fly(st):
        st, f_act = jax.lax.scan(body, st, None, length=100)
        n = jnp.maximum(st.n_track, 1).astype(st.pos_err2.dtype)
        return f_act, jnp.sqrt(st.pos_err2 / n), jnp.sqrt(st.yaw_err2 / n), st.ok_all

    j_u, j_pos, j_yaw, j_ok = j_fly(j_init(dtype=jnp.float64))
    traj = fit_waypoints(wpts, np.full(5, 2.5), dtype=torch.float64)
    init_fn, _, run_fn = make_thrust_episode(CFG, traj, hold_ticks=20, record_traces=True,
                                             device="cpu")
    _, m, (x, u0) = run_fn(init_fn(dtype=torch.float64), 100)
    assert x.shape == (100, 1, 13) and u0.shape == (100, 1, 4)
    np.testing.assert_allclose(u0.numpy(), np.asarray(j_u), rtol=0, atol=1e-8)
    np.testing.assert_allclose(m.pos_rmse.numpy(), np.asarray(j_pos), rtol=1e-8)
    np.testing.assert_allclose(m.yaw_rmse_deg.numpy(), np.asarray(j_yaw), rtol=1e-8)
    np.testing.assert_allclose(m.form_rmse.numpy(), np.asarray(j_pos), rtol=1e-8)
    assert m.ok.tolist() == np.asarray(j_ok).tolist() == [True]


def test_cli_thrust_mission(capsys):
    cli.main(["mission", "one_qd", "--controller", "thrust", "--cpu", "--track-secs", "4",
              "--hold-ticks", "30", "--scenario", "hover_step"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] == [True]
    assert out["pos_rmse"][0] < 0.1
    assert out["ticks"] == 230 and out["solver"]["backend"] == "jax"
    assert out["solver"]["qp_iters"] == 12 and out["device"] == "cpu"


@pytest.mark.parametrize("argv", [["three_qd"], ["one_qd", "--backend", "pallas"]])
def test_cli_thrust_refuses(argv):
    args = cli.make_parser().parse_args(["mission", *argv, "--controller", "thrust", "--cpu"])
    with pytest.raises(ValueError, match="--controller thrust"):
        cli.run_mission(args)
