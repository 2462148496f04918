"""The port's launcher (`parallel/launch.py`), its entry points
(`entry.py`: `entry`, `dryrun_multichip`) and the data-parallel training
step, on the CPU.

The module's fixture first computes the references in this process: the
one-process step of `make_trainer(sn=0, lr=1e-3)` on the whole batch and
JAX's (`jax.value_and_grad` of the MSE and `optax.adam(1e-3)`,
`__graft_entry__.py:143-156`) from the same numpy weights, and JAX's
`entry()`, while the module entry (`python -m
ndp_nmpc_qd_tpu_torch.parallel.launch --nproc 2 --cpu`) runs a script that
all_reduces over its two ranks and then a launch whose rank 1 raises runs
(their ranks import torch and end). Then one
launch of two gloo ranks (`spawn(..., device="cpu")`) runs
`dryrun_multichip` on both (data, swarm) meshes of two ranks, (data 1,
swarm 2) and (data 2, swarm 1), in one world, with nothing else running
in this file. The data-parallel
step's averaged gradients, loss and weights are held against both
references: gradients at rtol 1e-5 (atol 1e-5 of the tensor's largest),
weights atol 1e-6 and loss rtol 1e-5 (`tests/test_torch_downwash_train.py`'s
bounds); `entry()` against JAX's `entry()` on JAX's positions in float64 at
`tests/test_torch_scan_controller.py`'s tolerances.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ndp_nmpc_qd_tpu_torch import entry as t_entry
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import make_trainer
from ndp_nmpc_qd_tpu_torch.parallel import launch
from ndp_nmpc_qd_tpu_torch.parallel.mesh import make_mesh, release_meshes
from ndp_nmpc_qd_tpu_torch.solver.rti import RtiState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"data1_swarm2": 2, "data2_swarm1": 1}  # name -> swarm axis
WORLD = 2
SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import torch
from ndp_nmpc_qd_tpu_torch.parallel import distributed
from ndp_nmpc_qd_tpu_torch.parallel.mesh import all_reduce, make_mesh
torch.set_num_threads(1)
distributed.initialize()
mesh = make_mesh()
t = torch.full((2,), float(distributed.process_index() + 1))
all_reduce(mesh, "data", t)
# one write a line: the ranks share the launcher's stdout
sys.stdout.write(f"rank {{distributed.process_index()}} of {{distributed.process_count()}} "
                 f"{{mesh.device}} {{t.tolist()}}\\n")
sys.stdout.flush()
distributed.shutdown()
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rank_work():
    """Both two-rank meshes' dry runs on this rank, and what the rank saw."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "env": {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE")},
           "backend": dist.get_backend()}
    for name, swarm in MESHES.items():
        out[name] = t_entry.dryrun_multichip(make_mesh(WORLD, swarm_axis=swarm, device="cpu"))
    return out


def raise_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank one says no")
    return dist.get_rank()


def raising_launch():
    """Two gloo ranks of `raise_on_rank_one`: the LaunchError the launch
    fails with (None if it does not fail)."""
    try:
        launch.spawn(raise_on_rank_one, 2, device="cpu", timeout_s=60)
    except launch.LaunchError as e:
        return e
    return None


def jax_train_step(weights, x, y):
    """JAX's data-parallel step on the whole batch (`__graft_entry__.py:
    143-156` without the shard_map: one device holds every row; jitted as
    there): the loss, the gradients and the weights after the step."""
    import jax
    import jax.numpy as jnp
    import optax

    from ndp_nmpc_qd_tpu.models.downwash_mlp import MlpParams, mlp_forward

    params = MlpParams(tuple(jnp.asarray(w) for w, _ in weights),
                       tuple(jnp.asarray(b) for _, b in weights))
    opt = optax.adam(1e-3)

    def loss_fn(p, xb, yb):
        return jnp.mean((mlp_forward(p, xb) - yb) ** 2)

    @jax.jit
    def step(p, xb, yb):
        loss, grads = jax.value_and_grad(loss_fn)(p, xb, yb)
        updates, _ = opt.update(grads, opt.init(p))
        return loss, grads, optax.apply_updates(p, updates)

    loss, grads, params = step(params, jnp.asarray(x), jnp.asarray(y))
    pairs = lambda p: [(np.asarray(w), np.asarray(b)) for w, b in zip(p.weights, p.biases)]
    return float(loss), pairs(grads), pairs(params)


def jax_entry():
    """JAX's `entry()` step on its own positions, in float64."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    fn, args = graft.entry()
    args64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), args)
    out = jax.jit(fn)(*args64)
    rti, x0, xr, ur = args64
    ins = [np.asarray(a) for a in (rti.x_bar, rti.u_bar, x0, xr, ur)]
    return ins, [np.asarray(o) for o in out]


def references():
    """The parent's references: the one-process step and JAX's, from the
    dry run's initial weights on its whole batch, and JAX's entry."""
    mlp, opt = t_entry.train_init("cpu")
    w0 = t_entry.weights_of(mlp)
    xb, yb = t_entry.train_batch(WORLD * t_entry.ROWS_PER_RANK, "cpu")
    _, _, loss = make_trainer(sn=0.0, lr=t_entry.TRAIN_LR)[1](mlp, opt, xb, yb)
    return {"one": (float(loss), t_entry.grads_of(mlp), t_entry.weights_of(mlp)),
            "jax": jax_train_step(w0, xb.numpy(), yb.numpy()),
            "entry": jax_entry()}


def module_entry(script):
    """The module entry on two CPU ranks running `script`: (rc, output)."""
    try:
        r = subprocess.run(
            [sys.executable, "-m", "ndp_nmpc_qd_tpu_torch.parallel.launch", "--nproc", "2",
             "--cpu", "--timeout", "120", str(script)],
            cwd=ROOT, capture_output=True, text=True, timeout=150,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
    except subprocess.TimeoutExpired as e:
        return None, f"{e.stdout}{e.stderr}"
    return r.returncode, r.stdout + r.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references beside the module entry's and the raising launch's
    short runs, then the two-rank launch alone (this process waits while
    its ranks run). The launches start from a thread at nice 10: on Linux
    a thread's nice value is its own and the processes it starts inherit
    it, so the ranks yield the CPU to the suite's other workers (its
    real-time daemon tests among them) while this process keeps its own."""
    script = tmp_path_factory.mktemp("launch") / "rank_script.py"
    script.write_text(SCRIPT.format(root=ROOT))
    box, refs_done = {}, threading.Event()

    def launches():
        try:
            os.nice(10)
            box["module"] = module_entry(script)
            box["raised"] = raising_launch()
            refs_done.wait()
            box["ranks"] = launch.spawn(rank_work, WORLD, device="cpu", timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test thread
            box["error"] = e

    thread = threading.Thread(target=launches)
    thread.start()
    try:
        ref = references()
    finally:
        refs_done.set()
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], ref, box["module"], box["raised"]


def test_spawn_returns_each_ranks_result_in_rank_order(runs):
    ranks, _, _, _ = runs
    assert [r["rank"] for r in ranks] == [0, 1]
    for rank, r in enumerate(ranks):
        assert r["world"] == WORLD and r["backend"] == "gloo"
        assert r["env"] == {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2"}


def test_module_entry_runs_a_script_on_two_cpu_ranks(runs):
    _, _, (rc, out), _ = runs
    assert rc == 0, out
    for rank in range(2):
        assert f"rank {rank} of 2 cpu [3.0, 3.0]" in out, out


def test_a_raising_rank_fails_the_launch_with_its_traceback(runs):
    err = runs[3]
    assert isinstance(err, launch.LaunchError), err
    msg = str(err)
    assert "rank 1 of 2 failed" in msg and "ValueError: rank one says no" in msg, msg
    assert "raise_on_rank_one" in msg  # the rank's own traceback


@pytest.mark.parametrize("case", ["no_card", "more_ranks_than_cards", "cpu_without_count"])
def test_a_launch_that_cannot_start_raises_before_any_rank(monkeypatch, case):
    """Without a card (and without the CPU asked for) spawn raises; more
    ranks than cards raises; CPU ranks need a count. Nothing falls back
    to one rank, and no process starts."""
    started = []
    monkeypatch.setattr(launch.mp, "get_context", lambda *a: started.append(a))
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.spawn(raise_on_rank_one, 2)
    elif case == "more_ranks_than_cards":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 ranks asked for, 1 card"):
            launch.spawn(raise_on_rank_one, 2)
    else:
        with pytest.raises(ValueError, match="need a count"):
            launch.spawn(raise_on_rank_one, device="cpu")
    assert not started


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_multichip_passes_on_both_two_rank_meshes(runs, mesh):
    ranks, _, _, _ = runs
    swarm = MESHES[mesh]
    n_data = WORLD // swarm
    for r in ranks:
        out = r[mesh]
        assert out["mesh"] == {"data": n_data, "swarm": swarm}
        assert out["episode"]["ok"].shape == (2, 2)  # (S / n_data, D / n_swarm)
        assert out["formation"]["ok"].shape == (2, 4 // swarm)
        for part in ("episode", "formation"):
            assert out[part]["ok"].all() and np.isfinite(out[part]["pos_rmse"]).all()
        assert np.isfinite(out["loss"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_parallel_step_matches_one_process_and_jax(runs, mesh):
    """Two ranks' step (the gradients and loss averaged over data, then
    swarm) against the one-process step on the whole batch and JAX's:
    the averaged gradients at rtol 1e-5 (atol 1e-5 of the tensor's
    largest: a sum not divided, or divided by another axis's size, is off
    by a factor), weights atol 1e-6 and loss rtol 1e-5 (Adam's first step
    is about lr x sign(g), so the weights alone would not see the
    factor); weights and gradients replicated; `train_step_diff`, which
    `chip_smoke.py` and the multi-card tool read, agrees."""
    ranks, ref, _, _ = runs
    got = [r[mesh] for r in ranks]
    for key in ("weights", "grads"):
        for a, b in zip(got[0][key], got[1][key]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)
    assert got[0]["loss"] == got[1]["loss"]
    for name in ("one", "jax"):
        loss, grads, weights = ref[name]
        np.testing.assert_allclose(got[0]["loss"], loss, rtol=1e-5, err_msg=name)
        for pair, pair_r in zip(got[0]["grads"], grads):
            for g, g_r in zip(pair, pair_r):
                np.testing.assert_allclose(g, g_r, rtol=1e-5, atol=1e-5 * np.abs(g_r).max(),
                                           err_msg=f"{name} grads")
        for (w, b), (w_r, b_r) in zip(got[0]["weights"], weights):
            np.testing.assert_allclose(w, w_r, rtol=0, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(b, b_r, rtol=0, atol=1e-6, err_msg=name)
    d = t_entry.train_step_diff(got, "cpu")
    assert d["replicated"] and d["grads_max_rel_diff"] <= 1e-5, d
    assert d["weights_max_abs_diff"] <= 1e-6 and d["loss_rel_diff"] <= 1e-5, d
    # the step moved the weights by about lr
    w0 = t_entry.weights_of(t_entry.train_init("cpu")[0])
    assert abs(float(np.abs(got[0]["weights"][0][0] - w0[0][0]).max()) - 1e-3) < 2e-4


def test_entry_matches_jax_entry(runs):
    """`entry()`'s step against JAX's `entry()` step on JAX's example inputs
    in float64: u0 and x_bar at rtol 1e-8 (atol 1e-10 of the scale), `ok`
    equal; `entry()`'s own example inputs are JAX's but the drones'
    offsets (each package's generator) and the hover thrust (which JAX
    rounds to f32 first), and in f32 they run and are healthy."""
    _, ref, _, _ = runs
    (xb_j, ub_j, x0_j, xr_j, ur_j), (u_j, xbar_j, ok_j) = ref["entry"]
    fn, (rti0, x0, xr, ur) = t_entry.entry("cpu", dtype=torch.float64)
    T = torch.as_tensor
    torch.testing.assert_close(xr, T(xr_j), rtol=0, atol=0)
    torch.testing.assert_close(rti0.x_bar, T(xb_j), rtol=0, atol=0)
    for got, want in ((rti0.u_bar, ub_j), (ur, ur_j)):
        torch.testing.assert_close(got, T(want), rtol=1e-6, atol=0)
    torch.testing.assert_close(x0[..., 3:], T(x0_j[..., 3:]), rtol=0, atol=0)
    assert x0.shape == x0_j.shape and float(x0[..., 0:3].abs().max()) <= 1.0
    u0, x_bar, ok = fn(RtiState(T(xb_j), T(ub_j)), T(x0_j), T(xr_j), T(ur_j))
    assert u0.shape == (8, 3, 4) and x_bar.shape == (8, 3, 21, 10) and ok.shape == (8, 3)
    for name, g, r in (("u0", u0, u_j), ("x_bar", x_bar, xbar_j)):
        r = torch.as_tensor(r)
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-8, atol=1e-10 * scale, msg=name)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    fn, args = t_entry.entry("cpu")
    u0, x_bar, ok = fn(*args)
    assert u0.dtype == torch.float32 and bool(ok.all()) and bool(torch.isfinite(u0).all())


def test_train_step_diff_is_bitwise_at_one_rank_and_sees_an_unaveraged_sum():
    """At one rank (no process group: the all_reduces are the identity) the
    data-parallel step is bitwise `make_trainer(sn=0)`'s step on the same
    rows; gradients summed over two ranks and not divided show as a
    relative difference of 1, which the weights after Adam's first step
    do not show."""
    mesh = make_mesh(1, device="cpu")
    try:
        mlp, opt = t_entry.train_init("cpu")
        xb, yb = t_entry.train_batch(t_entry.ROWS_PER_RANK, "cpu")
        loss = t_entry.data_parallel_train_step(mesh, mlp, opt, xb, yb)
    finally:
        release_meshes()
    dry = {"loss": float(loss), "grads": t_entry.grads_of(mlp),
           "weights": t_entry.weights_of(mlp)}
    d = t_entry.train_step_diff([dry], "cpu")
    assert d["bitwise"] and d["replicated"], d
    summed = dict(dry, grads=[(2 * w, 2 * b) for w, b in dry["grads"]])
    d = t_entry.train_step_diff([summed], "cpu")
    assert not d["bitwise"] and abs(d["grads_max_rel_diff"] - 1.0) < 1e-6, d
    assert d["weights_max_abs_diff"] == 0.0
