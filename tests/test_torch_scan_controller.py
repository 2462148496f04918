"""PyTorch port vs JAX: the scan controller (`backend="jax"`,
`make_rti_controller`), the legacy dense controller (`backend="pallas_packed"`)
and the small-topology mission on the scan controller, on the CPU.

- The batched scan controller against the JAX one over 3 chained ticks at
  B=16 in f64, with a far scenario (25 m, the zero-control start) and a NaN
  x0 (`ok` False, no exception, NaN where JAX has NaN): the same algorithm
  rounded in another order, so rtol 1e-8 (eq_res, rounding noise at
  dynamics-exact iterates, above 1e-12). `make_rti_controller`, one
  scenario at a time, gives the batched rows.
- The pallas_packed controller (the plain K8/K9) against the port's scan
  controller, 2 chained ticks in f32 in the nominal regime, at
  `tests/test_pallas_riccati.py`'s 1e-4: the same QP and the same IPM
  (the packed one has no far-regime fallback, which the nominal regime
  does not take).
- The `three_qd_ndp` mission through `make_episode(solver_backend="auto")`
  on the CPU resolves to the scan controller, as the JAX CLI's, and its
  first 50 ticks' controls match the JAX mission golden
  (`assets/mission_golden_three_qd_ndp.npz`, the JAX scan mission) at 1e-5.
- `resolve_backend`, the one copy of that rule, and the mission CLI
  reporting the backend it resolved, by the rule and by `--backend`.

Inputs are made with numpy from a seed; both packages get the same arrays.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.solver import rti as j_rti
from ndp_nmpc_qd_tpu_torch import cli
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig, SimParams
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode, resolve_backend
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(B, seed, ticks, far=(), nan=()):
    """Hover references at (0, 0, 1), x0 per tick at offsets in [-1, 1] m
    drifting by 0.05 m a tick, forecast forces of scale 0.3; scenarios in
    `far` 25 m away along x, in `nan` a NaN x0."""
    rng = np.random.default_rng(seed)
    xr = np.zeros((B, N + 1, 10))
    xr[..., 2] = 1.0
    xr[..., 6] = 1.0
    ur = np.zeros((B, N, 4))
    ur[..., 3] = CFG.vehicle.gravity
    x0 = xr[:, 0].copy()
    x0[:, 0:3] += rng.uniform(-1.0, 1.0, (B, 3))
    x0[list(far), 0] = 25.0
    x0s = [x0 + 0.05 * k * rng.standard_normal((B, 10)) * np.r_[np.ones(6), np.zeros(4)]
           for k in range(ticks)]
    for x in x0s:
        x[list(nan), 3] = np.nan
    fd = 0.3 * rng.standard_normal((ticks, B, N + 1, 3))
    return xr, ur, x0s, fd


def assert_state_close(got, want, msg):
    """got: port (u0, RtiState, RtiInfo); want: the same from JAX."""
    (u_t, st_t, in_t), (u_j, st_j, in_j) = got, want
    pairs = dict(u0=(u_t, u_j), x_bar=(st_t.x_bar, st_j.x_bar), u_bar=(st_t.u_bar, st_j.u_bar),
                 mu=(in_t.mu, in_j.mu), eq_res=(in_t.eq_res, in_j.eq_res))
    for name, (g, r) in pairs.items():
        r = torch.tensor(np.asarray(r))
        fin = torch.isfinite(r)
        scale = max(1.0, float(r[fin].abs().max())) if bool(fin.any()) else 1.0
        atol = 1e-12 if name == "eq_res" else 1e-10 * scale
        torch.testing.assert_close(g, r, rtol=1e-8, atol=atol, equal_nan=True,
                                   msg=f"{msg}: {name}")
    np.testing.assert_array_equal(in_t.ok.numpy(), np.asarray(in_j.ok), err_msg=msg)


def test_scan_controller_matches_jax_over_chained_ticks():
    B, ticks = 16, 3
    xr, ur, x0s, fd = inputs(B, 0, ticks, far=(3,), nan=(7,))
    jc = JaxConfig()
    ctl_j = j_rti.make_batched_rti_controller(jc.ocp, jc.vehicle, with_disturbance=True,
                                              qp_iters=12, backend="jax")
    ctl_t = t_rti.make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                              qp_iters=12, backend="jax", device="cpu")
    one = t_rti.make_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True, qp_iters=12,
                                    device="cpu")
    upd_j = jax.jit(ctl_j.update)
    T = torch.tensor
    st_j, st_t = ctl_j.reset(xr, ur), ctl_t.reset(T(xr), T(ur))
    rows = (0, 3, 7)  # nominal, far, NaN
    st_1 = [one.reset(T(xr[i]), T(ur[i])) for i in rows]
    for k in range(ticks):
        out_j = upd_j(st_j, x0s[k], xr, ur, fd[k])
        out_t = ctl_t.update(st_t, T(x0s[k]), T(xr), T(ur), T(fd[k]))
        assert_state_close(out_t, out_j, f"tick {k}")
        for n, i in enumerate(rows):
            u1, st_1[n], info1 = one.update(st_1[n], T(x0s[k][i]), T(xr[i]), T(ur[i]), T(fd[k][i]))
            for g, r in ((u1, out_t[0][i]), (st_1[n].x_bar, out_t[1].x_bar[i]),
                         (info1.ok, out_t[2].ok[i])):
                torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12, equal_nan=True)
        st_j, st_t = out_j[1], out_t[1]
        ok = out_t[2].ok
        assert not bool(ok[7]) and bool(ok[[0, 1, 2]].all()), ok
    assert out_t[1].ipm is None and out_t[1].x_bar.dtype == torch.float64


def test_pallas_packed_matches_scan_controller():
    B = 16
    xr, ur, x0s, fd = inputs(B, 1, 2)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    kw = dict(with_disturbance=True, qp_iters=12, device="cpu")
    dense = t_rti.make_batched_rti_controller(CFG.ocp, CFG.vehicle, backend="pallas_packed", **kw)
    scan = t_rti.make_batched_rti_controller(CFG.ocp, CFG.vehicle, backend="jax", **kw)
    st_d, st_s = dense.reset(f(xr), f(ur)), scan.reset(f(xr), f(ur))
    for k in range(2):
        u_d, st_d, i_d = dense.update(st_d, f(x0s[k]), f(xr), f(ur), f(fd[k]))
        u_s, st_s, i_s = scan.update(st_s, f(x0s[k]), f(xr), f(ur), f(fd[k]))
        torch.testing.assert_close(u_d, u_s, rtol=0, atol=1e-4, msg=f"tick {k}")
        assert bool(i_d.ok.all()) and torch.equal(i_d.ok, i_s.ok)
        assert u_d.dtype == torch.float32 and st_d.x_bar.shape == (B, N + 1, 10)


def test_three_qd_ndp_mission_runs_the_scan_controller_on_the_golden():
    """The golden's mission as the CLI builds it (`tools/validate_port_mission.py`):
    k_true 46, 200 hold ticks, recovery on, f32, cold@12; its first 50
    ticks."""
    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=46.0))
    init_fn, _, run_fn = make_episode(
        cfg, cli.build_eight(), n_drones=3, use_ndp=True, true_downwash=True,
        downwash_params=load_npz(os.path.join(ASSETS, "downwash_analytic_sn4.npz"),
                                 device="cpu"),
        qp_iters=12, hold_ticks=200, recover=True, record_traces=True,
        solver_backend="auto", device="cpu",
    )
    st = init_fn()
    assert st.rti.ipm is None  # the scan controller's state: no carried duals
    st, metrics, (x, u0, _) = run_fn(st, 50)
    with np.load(os.path.join(ASSETS, "mission_golden_three_qd_ndp.npz")) as g:
        np.testing.assert_allclose(u0.numpy(), g["u0"][:50], rtol=0, atol=1e-5)
    assert bool(metrics.ok.all()) and int(metrics.recovered) == 0


@pytest.mark.parametrize("n_drones, device, name, want", [
    (3, "cpu", "auto", "jax"),
    (65535, "cpu", "auto", "jax"),
    (511, "cuda", "auto", "jax"),
    (512, "cuda", "auto", "pallas"),
    (3, "cpu", "pallas", "pallas"),
    (65535, "cuda", "pallas_packed", "pallas_packed"),
])
def test_resolve_backend(n_drones, device, name, want):
    """`make_episode`'s backend rule, the one the CLI reports: "auto" is the
    kernels from 512 drones on the card, else the scan controller; a named
    backend stands. (No tensor is made, so no card is needed.)"""
    assert resolve_backend(name, n_drones, device) == want


@pytest.mark.parametrize("extra, want", [
    ((), dict(backend="jax", qp_iters=12, warm=False, whole_step=False, lqr_start=False)),
    (("--backend", "pallas", "--no-whole-step", "--no-whole-ipm", "--no-bf16"),
     dict(backend="pallas", qp_iters=3, warm=True, whole_step=False, lqr_start=True)),
])
def test_mission_cli_reports_the_resolved_backend(extra, want):
    """`run_mission` flies the controller `resolve_backend` picks and
    reports it; with `--backend pallas` the defaults follow the kernels
    (warm start at 3 QP iterations). One tick of `three_qd_ndp` on the
    CPU."""
    args = cli.make_parser().parse_args(["mission", "three_qd_ndp", "--cpu", *extra])
    result, run = cli.run_mission(args, n_ticks=1)
    assert {k: result["solver"][k] for k in want} == want
    assert result["ok"] == [True, True, True]
    assert (run["state"].rti.ipm is None) == (want["backend"] == "jax")
