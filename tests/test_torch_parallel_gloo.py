"""The port's parallel package across two processes on the CPU (gloo).

One module-scoped spawn: this file starts itself twice as a worker (`python
tests/test_torch_parallel_gloo.py RANK WORLD PORT OUT_DIR`), two ranks
joined by `parallel.distributed.initialize` over gloo on 127.0.0.1 (a
60 s timeout on every collective, one torch thread each). The workers run
the sharded programs and write their local blocks to `OUT_DIR` as `.npz`;
while they run, the parent computes the port's unsharded runs of the same
inputs (made from numpy seeds), and each test holds one sharded program
against them. The parent waits 240 s at most, then kills both workers and
fails with their output.

The cases, float64, the scan controller:
1. (data 1, swarm 2): the NDP mission of `tests/test_sharded_episode.py:39`
   (4 drones, qp_iters 12, the forecast, plant-side downwash, the
   `downwash_analytic_sn4.npz` weights, perturbations from
   `default_rng(7)`), 60 ticks with 20 of hold: both phases;
2. (data 2, swarm 1): the same mission, two scenarios, one per rank;
3. the independent swarm (`tests/test_sharded_episode.py:104`, four_qd
   semantics) with live recovery, swarm 2, 40 ticks with 20 of hold; the
   last drone starts 20 m off, so its rank re-seeds it (5 times) and the
   count is summed over the swarm group;
4. the sharded batch step (`tests/test_batch_step_sharded.py:23`), B=16
   over data 2, two chained ticks;
5. the sharded row's schema at world 2 and its skip at B=15;
6. the sharded swarm step at swarm 2 against one rank.
Tolerances are the JAX tests': metrics, plant state and iterates atol
1e-9, the estimator 1e-12, the batch step rtol/atol 1e-10; `ok` and the
re-seed count identical. The unsharded episodes of cases 1-3 are in turn
held against the JAX package's (its scan controller, one jit of the
mission, run for each of its two scenarios, and one of the independent
swarm) at the same tolerances, so that the sharded blocks are tied to JAX through them.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a worker script
    sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel import batch_step, distributed, episode  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_sharded_swarm_step, release_meshes, shard_scenarios, tree_map,
)
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig  # noqa: E402
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller  # noqa: E402
from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints  # noqa: E402

ASSET = os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz")
CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
F64 = torch.float64
D = 4
MISSION_TICKS, MISSION_HOLD = 60, 20
INDEP_TICKS, INDEP_HOLD = 40, 20
WAIT_S = 240


def _traj(fit=fit_waypoints):
    t = np.linspace(0, 2 * np.pi, 5)
    wpts = np.stack([1.5 * np.sin(t), 0.7 * np.sin(2 * t), 1.0 + 0.2 * np.sin(t)], axis=-1)
    return fit(wpts, np.full(4, 2.0), 0.15 * np.sin(t))


def mission_kw():
    return dict(use_ndp=True, downwash_params=load_npz(ASSET, dtype=F64, device="cpu"),
                true_downwash=True, hold_ticks=MISSION_HOLD, qp_iters=12, solver_backend="jax")


INDEP_KW = dict(independent=True, hold_ticks=INDEP_HOLD, solver_backend="jax", recover=True)
INDEP_OFF = np.zeros((1, D, 3))
INDEP_OFF[0, -1, 0] = 20.0  # far enough for the solver's not-ok regime: re-seeds


def perturb(S):
    return np.random.default_rng(7).uniform(-0.05, 0.05, size=(S, D, 3))


def perturbed(st, p):
    """An episode state with p (D, 3) added to its plant positions."""
    x, dx = st.plant.x, torch.as_tensor(p, dtype=st.plant.x.dtype)
    return st._replace(plant=st.plant._replace(x=torch.cat([x[:, 0:3] + dx, x[:, 3:]], -1)))


def batch_inputs(B, seed):
    """`tests/test_batch_step_sharded.py:23`'s step: hover at uniform offsets
    in [-1, 1] m, hover references at the origin, no disturbance."""
    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                      backend="jax", device="cpu")
    x0 = hover_state(torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, (B, 3))))
    xr = hover_state(torch.zeros(B, 3, dtype=F64))[:, None].repeat(1, N + 1, 1)
    ur = hover_input(CFG.vehicle, (B,), dtype=F64, device="cpu")[:, None].repeat(1, N, 1)
    f = torch.zeros(B, N + 1, 3, dtype=F64)
    return ctl.update, (ctl.reset(xr, ur), x0, xr, ur, f)


def swarm_inputs(S=2):
    """`tests/test_parallel.py:17-40`'s swarm step: S scenarios of D drones
    hovering at uniform offsets, the leader horizon at hover, offsets 0.7 m
    apart in z."""
    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                      backend="jax", device="cpu")
    x0 = hover_state(torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (S, D, 3))))
    xr_lead = hover_state(torch.zeros(S, 3, dtype=F64))[:, None].repeat(1, N + 1, 1)
    ur_lead = hover_input(CFG.vehicle, (S,), dtype=F64, device="cpu")[:, None].repeat(1, N, 1)
    offsets = torch.zeros(S, D, 3, dtype=F64)
    offsets[..., 2] = 0.7 * torch.arange(D, dtype=F64)
    xr = xr_lead[:, None].repeat(1, D, 1, 1)
    xr[..., 0:3] += offsets[:, :, None, :]
    ur = ur_lead[:, None].repeat(1, D, 1, 1)
    rti0 = tree_map(lambda a: a.reshape((S, D) + a.shape[1:]),
                    ctl.reset(xr.reshape(S * D, N + 1, 10), ur.reshape(S * D, N, 4)))
    return ctl, (rti0, x0, xr_lead, ur_lead, offsets)


def episode_arrays(st, m):
    """The compared leaves of a run, as numpy."""
    return dict(pos_rmse=m.pos_rmse, yaw_rmse_deg=m.yaw_rmse_deg, form_rmse=m.form_rmse,
                ok=m.ok, recovered=m.recovered, x=st.plant.x, x_bar=st.rti.x_bar,
                est=st.est.x)


def run_worker(rank, world, port, out_dir):
    """The sharded programs on this rank; its local blocks to out_dir."""
    torch.set_num_threads(1)
    distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank, device="cpu", timeout_s=60)
    out = {}
    put = lambda tag, arrays: out.update({f"{tag}.{k}": torch.as_tensor(v).numpy()
                                          for k, v in arrays.items()})
    try:
        traj = _traj()
        for tag, S, swarm in (("swarm2", 1, 2), ("data2", 2, 1)):
            mesh = make_mesh(world, swarm_axis=swarm, device="cpu")
            init_fn, run_fn = episode.make_sharded_episode(
                CFG, traj, mesh, n_drones=D, scenario_batch=S, **mission_kw())
            st, m, _ = run_fn(init_fn(dtype=F64, perturb=perturb(S)), MISSION_TICKS)
            put(tag, episode_arrays(st, m))

        mesh = make_mesh(world, swarm_axis=2, device="cpu")
        init_fn, run_fn = episode.make_sharded_episode(
            CFG, traj, mesh, n_drones=D, scenario_batch=1, **INDEP_KW)
        st, m, _ = run_fn(init_fn(dtype=F64, perturb=INDEP_OFF), INDEP_TICKS)
        put("indep", episode_arrays(st, m))

        step, args0 = batch_inputs(16, seed=11)
        mesh = batch_step.data_mesh(device="cpu")
        sfn, place = batch_step.make_sharded_step(step, mesh, args0)
        local = place(args0)
        u1, st1, info1 = sfn(*local)
        u2, _, _ = sfn(st1, *local[1:])
        put("batch", dict(u1=u1, x_bar=st1.x_bar, ok=info1.ok, u2=u2,
                          u1_gathered=batch_step.gather(mesh, u1)))

        step, args0 = batch_inputs(16, seed=5)
        row, skip = batch_step.measure_sharded_row(step, args0, B=16, single_sps=1.0, iters=1,
                                                   mesh=mesh)
        step15, args15 = batch_inputs(15, seed=5)
        row15, skip15 = batch_step.measure_sharded_row(step15, args15, B=15, single_sps=1.0,
                                                       iters=1, mesh=mesh)
        out["row"] = np.array(json.dumps(dict(row=row, skip=skip, row15=row15, skip15=skip15)))

        ctl, (rti0, x0, xr_lead, ur_lead, offsets) = swarm_inputs()
        mesh = make_mesh(world, swarm_axis=2, device="cpu")
        drones = mesh.block("swarm", D)
        mine = lambda a: shard_scenarios(mesh, a)[:, drones]
        u0, new, n_ok = make_sharded_swarm_step(CFG, ctl, mesh)(
            tree_map(mine, rti0), mine(x0), shard_scenarios(mesh, xr_lead),
            shard_scenarios(mesh, ur_lead), mine(offsets))
        put("swarm_step", dict(u0=u0, x_bar=new.x_bar, n_ok=n_ok))
    finally:
        distributed.shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print(f"worker {rank}: ok", flush=True)


def unsharded_references():
    """The port's unsharded runs of every case, in this process."""
    ref = {}
    traj = _traj()
    init_fn, _, run_fn = make_episode(CFG, traj, n_drones=D, device="cpu", **mission_kw())
    p = perturb(2)
    for s in range(2):
        st = perturbed(init_fn(dtype=F64), p[s])
        ref[f"mission{s}"] = episode_arrays(*run_fn(st, MISSION_TICKS)[:2])
    init_fn, _, run_fn = make_episode(CFG, traj, n_drones=D, device="cpu", **INDEP_KW)
    st = perturbed(init_fn(dtype=F64), INDEP_OFF[0])
    ref["indep"] = episode_arrays(*run_fn(st, INDEP_TICKS)[:2])

    step, (rti, x0, xr, ur, f) = batch_inputs(16, seed=11)
    u1, st1, info1 = step(rti, x0, xr, ur, f)
    u2, _, _ = step(st1, x0, xr, ur, f)
    ref["batch"] = dict(u1=u1, x_bar=st1.x_bar, ok=info1.ok, u2=u2)

    ctl, args = swarm_inputs()
    u0, new, n_ok = make_sharded_swarm_step(CFG, ctl, make_mesh(1, 1, device="cpu"))(*args)
    release_meshes()
    ref["swarm_step"] = dict(u0=u0, x_bar=new.x_bar, n_ok=n_ok)
    return {case: {k: torch.as_tensor(v).numpy() for k, v in arrays.items()}
            for case, arrays in ref.items()}


def jax_references():
    """The JAX package's unsharded runs of cases 1-3 (imported here: the
    workers load this file and use no JAX): the mission's two scenarios
    and the independent swarm."""
    import jax
    import jax.numpy as jnp

    from ndp_nmpc_qd_tpu.models.downwash_mlp import load_npz as j_load
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
    from ndp_nmpc_qd_tpu.sim.closed_loop import make_episode as j_episode
    from ndp_nmpc_qd_tpu.traj.polyopt import fit_waypoints as j_fit

    traj = _traj(j_fit)

    def run(kw, n_ticks, offsets):
        """One jit of the episode, run scenario by scenario as the port's is."""
        init_fn, _, run_fn = j_episode(JaxConfig(), traj, n_drones=D, **kw)
        st0, run = init_fn(dtype=jnp.float64), jax.jit(lambda s: run_fn(s, n_ticks)[:2])
        outs = [episode_arrays(*run(st0._replace(plant=st0.plant._replace(
            x=st0.plant.x.at[:, 0:3].add(p))))) for p in offsets]
        return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}

    kw = dict(mission_kw(), downwash_params=j_load(ASSET, dtype=jnp.float64))
    return dict(mission=run(kw, MISSION_TICKS, perturb(2)),
                indep=run(INDEP_KW, INDEP_TICKS, INDEP_OFF))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("gloo")
    port = distributed.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        deadline = time.monotonic() + WAIT_S
        ref = unsharded_references()
        jref = jax_references()
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail(f"the gloo workers did not finish within {WAIT_S} s:\n" + "\n".join(outs))
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {rank}: ok" in out, f"worker {rank}:\n{out}"
    blocks = []
    for rank in range(2):
        with np.load(out_dir / f"rank{rank}.npz") as z:
            blocks.append({k: z[k] for k in z.files})
    return ref, blocks, jref


def joined(blocks, tag, name, axis):
    return np.concatenate([b[f"{tag}.{name}"] for b in blocks], axis=axis)


def check_episode(got, want, tag):
    """`tests/test_sharded_episode.py:82-97`'s tolerances; returns the
    largest difference of each compared leaf."""
    seen = {}
    for name, atol in (("pos_rmse", 1e-9), ("yaw_rmse_deg", 1e-9), ("form_rmse", 1e-9),
                       ("x", 1e-9), ("x_bar", 1e-9), ("est", 1e-12)):
        seen[name] = float(np.abs(got[name] - want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=f"{tag}: {name}")
    for name in ("ok", "recovered"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{tag}: {name}")
    print(f"{tag}: largest differences {seen}")
    return seen


NAMES = ("pos_rmse", "yaw_rmse_deg", "form_rmse", "ok", "recovered", "x", "x_bar", "est")


@pytest.mark.parametrize("case", ["mission", "indep"])
def test_unsharded_episodes_match_jax(runs, case):
    """The port's unsharded episodes, which the sharded blocks are held
    against, against the JAX package's on the same inputs: the NDP
    mission's two scenarios, and the independent swarm with its re-seeds."""
    ref, _, jref = runs
    got = ({k: np.stack([ref["mission0"][k], ref["mission1"][k]]) for k in NAMES}
           if case == "mission" else {k: v[None] for k, v in ref["indep"].items()})
    check_episode(got, jref[case], f"JAX {case}")


def test_swarm_sharded_ndp_mission_matches_unsharded(runs):
    """(data 1, swarm 2): two drones a rank, the PredXU hop, the companion
    horizon and the wake coupling through the swarm group's all_gather."""
    ref, blocks, _ = runs
    got = {k: joined(blocks, "swarm2", k, 1) if k != "recovered"
           else blocks[0][f"swarm2.{k}"] for k in NAMES}
    want = {k: v[None] for k, v in ref["mission0"].items()}
    check_episode(got, want, "swarm 2")
    np.testing.assert_array_equal(blocks[0]["swarm2.recovered"], blocks[1]["swarm2.recovered"])
    assert want["ok"].all() and float(want["pos_rmse"].max()) < 0.2  # it tracked


def test_data_sharded_ndp_mission_matches_unsharded(runs):
    """(data 2, swarm 1): one whole scenario a rank."""
    ref, blocks, _ = runs
    got = {k: joined(blocks, "data2", k, 0) for k in NAMES}
    want = {k: np.stack([ref["mission0"][k], ref["mission1"][k]]) for k in NAMES}
    check_episode(got, want, "data 2")


def test_sharded_independent_swarm_matches_unsharded(runs):
    """four_qd semantics (every drone its own leader, no exchange) with live
    recovery: the far drone's rank re-seeds it, and both ranks hold the
    re-seed count summed over the swarm group."""
    ref, blocks, _ = runs
    got = {k: joined(blocks, "indep", k, 1) if k != "recovered"
           else blocks[0][f"indep.{k}"] for k in NAMES}
    check_episode(got, {k: v[None] for k, v in ref["indep"].items()}, "independent")
    np.testing.assert_array_equal(blocks[1]["indep.recovered"], ref["indep"]["recovered"][None])
    assert int(ref["indep"]["recovered"]) > 0


def test_sharded_batch_step_matches_unsharded(runs):
    """B=16 over data 2, two chained ticks; the gathered u0 on every rank."""
    ref, blocks, _ = runs
    want = ref["batch"]
    for name in ("u1", "x_bar", "u2"):
        np.testing.assert_allclose(joined(blocks, "batch", name, 0), want[name], rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(joined(blocks, "batch", "ok", 0), want["ok"])
    for b in blocks:
        np.testing.assert_array_equal(b["batch.u1_gathered"], joined(blocks, "batch", "u1", 0))


def test_sharded_row_schema_at_world_2(runs):
    """The row's schema at two ranks (`tests/test_batch_step_sharded.py:71`),
    every rank the same row; B=15 skips with its reason."""
    _, blocks, _ = runs
    rows = [json.loads(str(b["row"])) for b in blocks]
    row = rows[0]["row"]
    assert rows[0]["skip"] is None
    assert set(row) == {"n_devices", "B_global", "solves_per_s", "solves_per_s_per_device",
                        "scaling_efficiency_vs_single", "ok"}
    assert row["n_devices"] == 2 and row["B_global"] == 16 and row["ok"] == 16
    assert row["solves_per_s"] > 0 and row["solves_per_s_per_device"] > 0
    assert row["scaling_efficiency_vs_single"] > 0
    assert rows[1]["row"] == row
    for r in rows:
        assert r["row15"] is None and "block" in r["skip15"] and "2 devices" in r["skip15"]


def test_sharded_swarm_step_matches_one_rank(runs):
    """Swarm 2 against one rank: u0 and the iterates atol 1e-9, n_ok equal
    on both ranks."""
    ref, blocks, _ = runs
    want = ref["swarm_step"]
    for name in ("u0", "x_bar"):
        np.testing.assert_allclose(joined(blocks, "swarm_step", name, 1), want[name], rtol=0,
                                   atol=1e-9, err_msg=name)
    for b in blocks:
        np.testing.assert_array_equal(b["swarm_step.n_ok"], want["n_ok"])


if __name__ == "__main__":
    run_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
