"""PyTorch port vs JAX: the closed-loop episode (`sim/closed_loop.make_episode`).

Three drones in the three_qd_ndp topology (leader NDP forecast from the
follower's previous horizon, plant-side downwash, live recovery), the
figure-eight, 2 hold ticks then 2 tracking ticks, traces recorded. The
controller is the per-iteration IPM from the clipped-LQR start with the
dual warm start and 3 QP iterations, batch-first state: K3, K6 + K7, and
K4 + K5 per iteration. The JAX episode runs the pallas backend in interpret
mode (its `run_fn` jitted), read from the recording
`tools/record_jax_refs.py` makes of it (`jax_refs.py`); the port runs its
plain versions on the CPU from the same initial state (carried over with
`convert.episode_state_from_numpy`, after checking that the port's own
`init_fn` builds it, against the JAX `init_fn` run live). f32 throughout,
the trajectory in f64 as the JAX package builds it here. Tolerances: commanded controls u0 atol 1e-4,
throttle atol 1e-5, plant states atol 1e-5 (f32 rounding of two
implementations of the same controller over 4 chained ticks); the
accumulated metrics rtol 1e-4; `ok` and the re-seed count identical; the
final controller iterates atol 2e-5 and carried duals rtol 1e-3 at their
own scale (`testing.py`'s dual tolerance), mu rtol 1e-3.
"""

import os

import jax
import numpy as np
import pytest
import torch

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu import cli as j_cli
from ndp_nmpc_qd_tpu.models.downwash_mlp import load_npz as j_load
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu.sim.closed_loop import make_episode as j_episode
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz as t_load
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode as t_episode

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "downwash_analytic_sn4.npz")
TICKS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many small ops on (3,) tensors; intra-op
    threads only add overhead there and take the CPUs of other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(n_drones=3, use_ndp=True, true_downwash=True, qp_iters=3, record_traces=True,
          hold_ticks=2, recover=True, solver_backend="pallas", solver_warm_start=True,
          solver_lqr_start=True, solver_whole_ipm=False)


RUN_OUT = ("x", "u0", "throttle", "pos_rmse", "yaw_rmse_deg", "form_rmse", "ok", "recovered",
           "tick", "n_track", "plant_x", "est_x", "x_bar", "u_bar") + tuple(
               f"ipm{k}" for k in range(5))
REF_KEYS = keys(("run",), RUN_OUT, ("st0", "traj", "weights", "kw", "ticks"))


def jax_episode():
    """The figure-eight and the JAX package's (init_fn, step_fn, run_fn)."""
    traj_j = j_cli.build_eight()
    return traj_j, j_episode(NdpNmpcConfig(), traj_j, downwash_params=j_load(ASSET), **KW,
                             solver_interpret=True)


def run_inputs(st0, traj_j):
    """What the JAX run is handed: its initial state, the trajectory, the
    weights, the flags and the tick count."""
    return dict(st0=jax.tree.leaves(st0), traj=jax.tree.leaves(jax.tree.map(np.asarray, traj_j)),
                weights=jax.tree.leaves(jax.tree.map(np.asarray, j_load(ASSET))), kw=KW,
                ticks=TICKS)


@pytest.fixture(scope="module")
def episodes():
    traj_j, (init_j, _, _) = jax_episode()
    traj_t = convert.traj_from_numpy(jax.tree.map(np.asarray, traj_j), device="cpu")
    init_t, _, run_t = t_episode(PortConfig(), traj_t, downwash_params=t_load(ASSET, device="cpu"),
                                 **KW, device="cpu")
    st0 = jax.tree.map(np.asarray, init_j())
    out_t = run_t(convert.episode_state_from_numpy(st0, device="cpu"), TICKS)
    return st0, init_t(), run_inputs(st0, traj_j), out_t


def arr(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_port_init_builds_the_jax_initial_state(episodes):
    st0, st_t, _, _ = episodes
    want = convert.episode_state_from_numpy(st0, device="cpu")
    flat = lambda s: [s.plant, s.rti.x_bar, s.rti.u_bar, s.rti.ipm, s.est, s.lpf_offset,
                      s.prev_ref_x, s.prev_ref_u, s.hold_xr, s.hold_ur, s.pos_err2,
                      s.ok_all, s.recovered]
    got_l = jax.tree.leaves([arr(x) for x in jax.tree.leaves(flat(st_t))])
    want_l = jax.tree.leaves([arr(x) for x in jax.tree.leaves(flat(want))])
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert (st_t.tick, st_t.n_track) == (0, 0)


def test_episode_matches_jax(episodes):
    _, _, inputs, (st_t, m_t, tr_t) = episodes
    rec = Recording("test_torch_episode")
    rec.check_inputs("run", **inputs)
    ref = lambda name: rec("run", name)
    x_j, u0_j, thr_j = ref("x"), ref("u0"), ref("throttle")
    x_t, u0_t, thr_t = (arr(a) for a in tr_t)
    assert u0_t.shape == u0_j.shape == (TICKS, 3, 4)
    np.testing.assert_allclose(u0_t, u0_j, atol=1e-4, err_msg="u0")
    np.testing.assert_allclose(thr_t, thr_j, atol=1e-5, err_msg="throttle")
    np.testing.assert_allclose(x_t, x_j, atol=1e-5, err_msg="plant x")
    assert bool(np.abs(u0_t[2:, 0] - u0_t[2:, 1]).max() > 0)  # tracking started

    for name in ("pos_rmse", "yaw_rmse_deg", "form_rmse"):
        np.testing.assert_allclose(arr(getattr(m_t, name)), ref(name),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(arr(m_t.ok), ref("ok"))
    assert int(m_t.recovered) == int(ref("recovered"))
    assert (st_t.tick, st_t.n_track) == (int(ref("tick")), int(ref("n_track"))) == (TICKS, 2)

    np.testing.assert_allclose(arr(st_t.plant.x), ref("plant_x"), atol=1e-5)
    np.testing.assert_allclose(arr(st_t.est.x), ref("est_x"), rtol=1e-5)
    np.testing.assert_allclose(arr(st_t.rti.x_bar), ref("x_bar"), atol=2e-5)
    np.testing.assert_allclose(arr(st_t.rti.u_bar), ref("u_bar"), atol=2e-5)
    for k, got in enumerate(st_t.rti.ipm):
        got, want = arr(got), ref(f"ipm{k}")
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * scale, err_msg=f"ipm {k}")
