"""PyTorch port vs JAX: the closed-loop episode's pieces, in float64.

Estimators (alpha filter, differentiator, hover-throttle KF, throttle
conversion), trajectories (`fit_waypoints`, `eval_traj` plain and stacked,
differential flatness, `nmpc_refs`, `gen_fix_pt_ref`, `traj_progress`,
yaml scenarios), formation offsets, the plant (with and without actuator
lags), the ground-truth downwash, recovery in both state layouts and the
IPM's elementwise helpers (`ipm_corr_terms`, `ipm_max_step`). The same
numpy inputs go through both packages; everything is elementwise or a
short sum, so the tolerance is rtol 1e-12 (1e-10 where a polynomial is
evaluated through `pow`, which the two libraries round differently) with an
atol of 1e-12 of the quantity's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu import cli as j_cli
from ndp_nmpc_qd_tpu.estimators import filters as j_filters
from ndp_nmpc_qd_tpu.estimators import hover_throttle as j_ht
from ndp_nmpc_qd_tpu.ops.pallas.riccati import BLOCK
from ndp_nmpc_qd_tpu.ops.pallas.riccati import pack as j_pack
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig, SimParams
from ndp_nmpc_qd_tpu.sim import downwash_truth as j_dw
from ndp_nmpc_qd_tpu.sim import plant as j_plant
from ndp_nmpc_qd_tpu.solver import qp_ipm as j_qp
from ndp_nmpc_qd_tpu.solver.rti import RtiState as JRtiState
from ndp_nmpc_qd_tpu.swarm import formation as j_form
from ndp_nmpc_qd_tpu.traj import flatness as j_flat
from ndp_nmpc_qd_tpu.traj import polyopt as j_poly
from ndp_nmpc_qd_tpu.traj import refgen as j_ref
from ndp_nmpc_qd_tpu.traj import scenarios as j_scen
from ndp_nmpc_qd_tpu.utils import recovery as j_rec
from ndp_nmpc_qd_tpu_torch import cli as t_cli
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.estimators import filters as t_filters
from ndp_nmpc_qd_tpu_torch.estimators import hover_throttle as t_ht
from ndp_nmpc_qd_tpu_torch.ops.layout import pack as t_pack
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.params import SimParams as PortSim
from ndp_nmpc_qd_tpu_torch.sim import downwash_truth as t_dw
from ndp_nmpc_qd_tpu_torch.sim import plant as t_plant
from ndp_nmpc_qd_tpu_torch.solver import qp_ipm as t_qp
from ndp_nmpc_qd_tpu_torch.solver.rti import RtiState
from ndp_nmpc_qd_tpu_torch.swarm import formation as t_form
from ndp_nmpc_qd_tpu_torch.traj import flatness as t_flat
from ndp_nmpc_qd_tpu_torch.traj import polyopt as t_poly
from ndp_nmpc_qd_tpu_torch.traj import refgen as t_ref
from ndp_nmpc_qd_tpu_torch.traj import scenarios as t_scen
from ndp_nmpc_qd_tpu_torch.utils import recovery as t_rec


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the ops here are small, and the suite's
    latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, rtol=1e-12, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    if ref.dtype == bool:
        np.testing.assert_array_equal(got, ref, err_msg=msg)
        return
    scale = max(float(np.abs(ref).max()), 1.0) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12 * scale, err_msg=msg)


T = lambda a: torch.tensor(np.asarray(a, np.float64))
J = lambda a: jnp.asarray(np.asarray(a, np.float64))


def test_estimators_match_jax():
    rng = np.random.default_rng(0)
    ep = NdpNmpcConfig().estimator
    D = 16
    st_j = j_ht.hover_throttle_init(ep, batch=(D,), dtype=jnp.float64)
    st_t = t_ht.hover_throttle_init(PortConfig().estimator, batch=(D,), dtype=torch.float64)
    for k in range(6):
        vz = rng.normal(0, 0.5, D)
        thr = rng.uniform(-0.1, 1.2, D)  # some outside the update gate
        st_j, k_j = j_ht.hover_throttle_update(st_j, J(vz), J(thr), ep)
        st_t, k_t = t_ht.hover_throttle_update(st_t, T(vz), T(thr), PortConfig().estimator)
        for got, ref in zip((st_t.x, st_t.P, st_t.diff.x_prev, st_t.diff.xdot_prev, k_t),
                            (st_j.x, st_j.P, st_j.diff.x_prev, st_j.diff.xdot_prev, k_j)):
            close(got, ref, msg=f"tick {k}")
    c = rng.uniform(0, 20, D)
    kt = rng.uniform(30, 60, D)
    kt[:3] = 0.0
    close(t_ht.throttle_from_collective(T(c), T(kt), 1.4844),
          j_ht.throttle_from_collective(J(c), J(kt), 1.4844))
    a_j, y_j = j_filters.alpha_filter_update(j_filters.alpha_filter_init(J(c)), J(kt), 0.8)
    a_t, y_t = t_filters.alpha_filter_update(t_filters.alpha_filter_init(T(c)), T(kt), 0.8)
    close(y_t, y_j)


def test_trajectories_match_jax():
    tr_j = j_cli.build_eight()
    tr_t = t_cli.build_eight(dtype=torch.float64)
    for f in t_poly.PiecewisePoly._fields:
        close(getattr(tr_t, f), getattr(tr_j, f), msg=f)
    ts = np.concatenate([[-0.5, 0.0, 2.0, 15.99, 16.0, 17.3], np.linspace(0, 16.5, 41)])
    ocp, veh = NdpNmpcConfig().ocp, NdpNmpcConfig().vehicle
    fo_j = j_poly.eval_traj(tr_j, J(ts))
    fo_t = t_poly.eval_traj(tr_t, T(ts))
    for f in t_poly.FlatOutputs._fields:
        close(getattr(fo_t, f), getattr(fo_j, f), rtol=1e-10, msg=f)
    fs_j = j_flat.diff_flatness(fo_j, mass=veh.mass, gravity=veh.gravity)
    fs_t = t_flat.diff_flatness(fo_t, mass=veh.mass, gravity=veh.gravity)
    close(fs_t.x, fs_j.x, rtol=1e-10)
    close(fs_t.u, fs_j.u, rtol=1e-9)
    for t in (0.0, 3.7, 15.5):
        xr_j, ur_j = j_ref.nmpc_refs(tr_j, J(t), ocp, veh)
        xr_t, ur_t = t_ref.nmpc_refs(tr_t, t, PortConfig().ocp, PortConfig().vehicle)
        close(xr_t, xr_j, rtol=1e-10)
        close(ur_t, ur_j, rtol=1e-9)
        for got, ref in zip(t_ref.traj_progress(tr_t, t), j_ref.traj_progress(tr_j, J(t))):
            close(got, ref)
    x = np.random.default_rng(1).normal(size=(5, 10))
    for got, ref in zip(t_ref.gen_fix_pt_ref(T(x), ocp, veh), j_ref.gen_fix_pt_ref(J(x), ocp, veh)):
        close(got, ref)
    # stacked trajectories of different segment counts (per-drone goals)
    short_j = j_poly.fit_waypoints(np.array([[0, 0, 1], [1, 2, 1.5], [2, 0, 1]]),
                                   np.array([1.5, 2.5]), np.array([0, 0.3, 0.1]))
    short_t = convert.traj_from_numpy(jax.tree.map(np.asarray, short_j), device="cpu")
    st_j = j_poly.stack_trajs([tr_j, short_j, tr_j])
    st_t = t_poly.stack_trajs([tr_t, short_t, tr_t])
    for f in t_poly.PiecewisePoly._fields:
        close(getattr(st_t, f), getattr(st_j, f), msg=f)
    tq = np.array([0.3, 3.5, 10.0])
    fo_j = jax.vmap(j_poly.eval_traj)(st_j, J(tq))
    fo_t = t_poly.eval_traj(st_t, T(tq))
    for f in t_poly.FlatOutputs._fields:
        close(getattr(fo_t, f), getattr(fo_j, f), rtol=1e-10, msg=f"stacked {f}")
    xr_j, _ = jax.vmap(lambda tr: j_ref.nmpc_refs(tr, J(1.2), ocp, veh))(st_j)
    xr_t, _ = t_ref.nmpc_refs(st_t, 1.2, PortConfig().ocp, PortConfig().vehicle)
    close(xr_t, xr_j, rtol=1e-10)


def test_yaml_scenario_matches_jax():
    name = j_scen.list_scenarios()[0]
    assert t_scen.list_scenarios() == j_scen.list_scenarios()
    tr_j = j_scen.load_scenario(name)
    tr_t = t_scen.load_scenario(name)
    for f in t_poly.PiecewisePoly._fields:
        close(getattr(tr_t, f), getattr(tr_j, f), msg=f)


def test_formation_plant_and_downwash_match_jax():
    rng = np.random.default_rng(2)
    lead = rng.normal(0, 2.5, (7, 10))
    close(t_form.reference_formation_offsets(T(lead), 4),
          j_form.reference_formation_offsets(J(lead), 4))
    assert t_form.rate_converted_alpha(0.8, 0.05, 0.02) == j_form.rate_converted_alpha(
        0.8, 0.05, 0.02)
    xr, ur, off = rng.normal(size=(21, 10)), rng.normal(size=(20, 4)), rng.normal(size=(3, 3))
    for got, ref in zip(t_form.offset_references(T(xr), T(ur), T(off)),
                        j_form.offset_references(J(xr), J(ur), J(off))):
        close(got, ref)

    xs = rng.normal(0, 0.6, (2, 5, 10))
    xs[..., 6:10] /= np.linalg.norm(xs[..., 6:10], axis=-1, keepdims=True)
    close(t_dw.pairwise_downwash(T(xs)), j_dw.pairwise_downwash(J(xs)))
    close(t_dw.downwash_on_locals(T(xs[0, 1:3]), T(xs[0]), torch.tensor([1, 2])),
          j_dw.downwash_on_locals(J(xs[0, 1:3]), J(xs[0]), jnp.array([1, 2])))

    veh = NdpNmpcConfig().vehicle
    x = xs[0]
    for lags in ((0.0, 0.0), (0.03, 0.05)):
        sim_j = SimParams(rate_tau=lags[0], thrust_tau=lags[1], k_throttle_true=46.0)
        sim_t = PortSim(rate_tau=lags[0], thrust_tau=lags[1], k_throttle_true=46.0)
        pj, pt = j_plant.plant_init(J(x), veh), t_plant.plant_init(T(x), PortConfig().vehicle)
        w, thr, f = rng.normal(size=(5, 3)), rng.uniform(0.2, 0.5, 5), rng.normal(size=(5, 3))
        for _ in range(2):
            pj = j_plant.plant_step(pj, J(w), J(thr), J(f), 0.02, veh, sim_j)
            pt = t_plant.plant_step(pt, T(w), T(thr), T(f), 0.02, PortConfig().vehicle, sim_t)
        for got, ref in zip(pt, pj):
            close(got, ref, rtol=1e-11, msg=f"plant lags {lags}")


def test_recovery_matches_jax_in_both_layouts():
    rng = np.random.default_rng(3)
    B, N = 6, 20
    xb, ub = rng.normal(size=(B, N + 1, 10)), rng.normal(size=(B, N, 4))
    ipm = (rng.normal(size=(B, N, 4)), rng.normal(size=(B, N, 4)),
           rng.normal(size=(B, N + 1, 3)), rng.normal(size=(B, N + 1, 3)), rng.normal(size=B))
    xb[1, 5, 2] = np.nan
    ipm[3][4, 0, 1] = np.inf
    xr, ur = rng.normal(size=(B, N + 1, 10)), rng.normal(size=(B, N, 4))
    ok = np.array([True, True, True, False, True, True])

    st_j = JRtiState(J(xb), J(ub), tuple(J(a) for a in ipm))
    st_t = RtiState(T(xb), T(ub), tuple(T(a) for a in ipm))
    ok_j = j_rec.screen_nan(st_j, jnp.asarray(ok))
    ok_t = t_rec.screen_nan(st_t, torch.tensor(ok))
    close(ok_t, ok_j)
    assert ok_t.tolist() == [True, False, True, False, False, True]
    rec_j = j_rec.recover_rti(st_j, ok_j, J(xr), J(ur))
    rec_t = t_rec.recover_rti(st_t, ok_t, T(xr), T(ur))
    for got, ref in zip((rec_t.x_bar, rec_t.u_bar, *rec_t.ipm), (rec_j.x_bar, rec_j.u_bar,
                                                                 *rec_j.ipm)):
        close(got, ref)

    # kernel layout: the JAX package pads to its lane block, the port does not
    pad = lambda a: jnp.concatenate([J(a), jnp.tile(J(a)[:1], (BLOCK - B,) + (1,) * (a.ndim - 1))])
    pk = lambda a: j_pack(pad(a))
    st_jp = JRtiState(pk(xb), pk(ub), tuple(pk(a) for a in ipm[:4]) + (
        j_pack(pad(ipm[4])[:, None, None])[0, 0],))
    okp = j_rec.screen_nan_packed(st_jp, j_rec.pack_ok(jnp.asarray(ok)))
    rec_jp = j_rec.recover_rti_packed(st_jp, okp, pk(xr), pk(ur))
    st_tp = convert.rti_state_from_numpy(st_jp.x_bar, st_jp.u_bar, st_jp.ipm, B, device="cpu")
    ok_tp = t_rec.screen_nan_packed(st_tp, torch.tensor(ok))
    close(ok_tp, np.asarray(okp).reshape(-1)[:B])
    rec_tp = t_rec.recover_rti_packed(st_tp, ok_tp, t_pack(T(xr)), t_pack(T(ur)))
    want = convert.rti_state_from_numpy(rec_jp.x_bar, rec_jp.u_bar, rec_jp.ipm, B, device="cpu")
    for got, ref in zip((rec_tp.x_bar, rec_tp.u_bar, *rec_tp.ipm),
                        (want.x_bar, want.u_bar, *want.ipm)):
        close(got, ref)


def test_ipm_helpers_match_jax():
    rng = np.random.default_rng(4)
    v, lo, hi = rng.normal(size=(20, 4, 8)), -2 + rng.normal(size=(20, 4, 8)), 2 + rng.normal(
        size=(20, 4, 8))
    s_lo, s_up = rng.uniform(0.01, 1, (2, 20, 4, 8))
    l_lo, l_up = rng.uniform(0.01, 3, (2, 20, 4, 8))
    mu = rng.uniform(1e-4, 1e-1, 8)
    args = (v, lo, hi, s_lo, s_up, l_lo, l_up, mu)
    for got, ref in zip(t_qp.ipm_corr_terms(*map(T, args)), j_qp.ipm_corr_terms(*map(J, args))):
        close(got, ref)
    dv = rng.normal(size=(20, 4, 8))
    close(t_qp.ipm_max_step(T(s_lo), T(dv), 0.95, dims=(0, 1)),
          j_qp.ipm_max_step(J(s_lo), J(dv), 0.95, axes=(0, 1)))
    close(t_qp.ipm_max_step(T(s_lo), T(dv), 0.95), j_qp.ipm_max_step(J(s_lo), J(dv), 0.95))
