"""The port's parallel package in one process (world 1), and its sharded
swarm step against the JAX package's on a one-device mesh.

The two-rank runs over gloo are `test_torch_parallel_gloo.py`. Here: the
bootstrap's no-op and the meshes at world 1; the blocks that
`shard_scenarios` and `make_sharded_step`'s `place` cut for another rank's
coordinates (batch-first leaves on dim 0, kernel-layout state on its last
dim, including a leaf whose stage count equals B); the default meshes and
`place`'s check of the batch; the sharded row's schema
at world 1; a sharded episode whose axis no mesh has; and the JAX parity of
`make_sharded_swarm_step` (`tests/test_parallel.py:17-84`'s setup at S=4,
D=4, float64, the MLP forces from `downwash_analytic_sn4.npz`): u0 and the
iterates atol 1e-9, n_ok equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.models.downwash_mlp import load_npz as j_load
from ndp_nmpc_qd_tpu.models.quadrotor import hover_input as j_hover_input
from ndp_nmpc_qd_tpu.models.quadrotor import hover_state as j_hover_state
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.parallel.mesh import make_mesh as j_make_mesh
from ndp_nmpc_qd_tpu.parallel.mesh import make_sharded_swarm_step as j_swarm_step
from ndp_nmpc_qd_tpu.solver.rti import make_rti_controller as j_rti
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.cli import build_eight
from ndp_nmpc_qd_tpu_torch.models.quadrotor import hover_input, hover_state
from ndp_nmpc_qd_tpu_torch.parallel import batch_step, distributed
from ndp_nmpc_qd_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, make_sharded_swarm_step, registered, release_meshes, shard_scenarios,
    tree_map,
)
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode
from ndp_nmpc_qd_tpu_torch.solver.rti import RtiState, make_batched_rti_controller

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "downwash_analytic_sn4.npz")
CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
F64 = torch.float64


@pytest.fixture(autouse=True)
def one_thread_no_mesh():
    """One torch thread; every test starts and ends with no mesh kept."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    release_meshes()
    yield
    release_meshes()
    torch.set_num_threads(n)


def test_initialize_is_a_noop_for_one_process():
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_local_batch(4096) == 4096


def test_meshes_at_world_1():
    mesh = distributed.make_global_mesh(swarm_axis=1, device="cpu")
    assert mesh.shape == {"data": 1, "swarm": 1}
    assert mesh.coords == {"data": 0, "swarm": 0} and mesh.groups == {"data": None, "swarm": None}
    assert make_mesh(1, swarm_axis=1, device="cpu").shape == {"data": 1, "swarm": 1}
    assert batch_step.data_mesh(device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="every rank"):
        make_mesh(8, swarm_axis=2, device="cpu")
    with pytest.raises(ValueError, match="one host"):
        distributed.make_global_mesh(swarm_axis=2, device="cpu")


def _second_half_mesh(names=("data", "swarm")):
    """A mesh that puts this process (rank 0) at data coordinate 1 of 2."""
    ranks = np.array([1, 0]).reshape((2,) + (1,) * (len(names) - 1))
    return Mesh(ranks, names, torch.device("cpu"), {n: None for n in names})


def test_blocks_follow_the_state_type_not_the_shape():
    """B = 20 = N: the kernel-layout u_bar (20, 4, 20) and the duals carry
    their batch on the last dim, x0 on its first; this rank's block is the
    second half, a copy."""
    B = N
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.rand(*s, generator=g, dtype=F64)
    state = RtiState(r(N + 1, 10, B), r(N, 4, B), (r(N, 4, B), r(N, 4, B), r(N + 1, 3, B),
                                                    r(N + 1, 3, B), r(B)))
    x0, scalar = r(B, 10), torch.tensor(2.0)
    mesh = _second_half_mesh(("data",))
    _, place = batch_step.make_sharded_step(lambda *a: a, mesh, (state, x0, scalar),
                                            layout="kernel")
    st_l, x0_l, s_l = place((state, x0, scalar))
    assert st_l.u_bar.shape == (N, 4, B // 2)
    torch.testing.assert_close(st_l.u_bar, state.u_bar[..., B // 2:], rtol=0, atol=0)
    torch.testing.assert_close(st_l.ipm[4], state.ipm[4][B // 2:], rtol=0, atol=0)
    torch.testing.assert_close(x0_l, x0[B // 2:], rtol=0, atol=0)
    assert s_l is scalar and st_l.x_bar.is_contiguous()
    st_l.x_bar.zero_()  # a copy: the caller's state is untouched
    assert state.x_bar.abs().sum() > 0
    # batch-first: the leaves of the same type on dim 0
    first = RtiState(r(B, N + 1, 10), r(B, N, 4), None)
    fl, _ = batch_step.make_sharded_step(lambda *a: a, mesh, (first, x0))[1]((first, x0))
    torch.testing.assert_close(fl.u_bar, first.u_bar[B // 2:], rtol=0, atol=0)
    # the scenario block of a (S, D, ...) tree, replicated over swarm
    tree = dict(x=r(4, 3, 10), c=torch.tensor(1.0))
    cut = shard_scenarios(_second_half_mesh(), (tree["x"], tree["c"]))
    torch.testing.assert_close(cut[0], tree["x"][2:], rtol=0, atol=0)
    assert cut[1] is tree["c"]
    with pytest.raises(ValueError, match="block-divisible"):
        batch_step.make_sharded_step(lambda *a: a, mesh, (r(B + 1, 10),))


def test_defaults_reuse_the_mesh_and_place_checks_the_batch():
    """With no mesh given, the sharded programs take the mesh last built for
    their axes (its process groups made once), and build a new one, on this
    rank's card, only where none is kept; `place` refuses a batch other than
    the example's; a card asked for without its index gets one."""
    grid = make_mesh(1, 1, device="cpu")
    assert registered(("data", "swarm")) is grid and registered(("data",)) is None
    line = batch_step.data_mesh(device="cpu")
    assert batch_step._default(None) is line and registered(("data", "swarm")) is grid
    x0 = torch.zeros(8, 10, dtype=F64)
    step, place = batch_step.make_sharded_step(lambda x: x, None, (x0,))
    assert step(x0) is x0
    with pytest.raises(ValueError, match="batch of 8 scenarios, got 6"):
        place((x0[:6],))
    release_meshes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch_step._default(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.local_device("cuda")
    else:
        assert distributed.local_device("cuda").index is not None


def test_sharded_row_schema_at_world_1():
    """`measure_sharded_row` at one rank on the scan controller, B=16, one
    timed step; `gather` is the identity there."""
    B = 16
    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                      backend="jax", device="cpu")
    x0 = hover_state(torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, (B, 3))))
    xr = hover_state(torch.zeros(B, 3, dtype=F64))[:, None].repeat(1, N + 1, 1)
    ur = hover_input(CFG.vehicle, (B,), dtype=F64, device="cpu")[:, None].repeat(1, N, 1)
    f = torch.zeros(B, N + 1, 3, dtype=F64)
    mesh = batch_step.data_mesh(device="cpu")
    row, skip = batch_step.measure_sharded_row(ctl.update, (ctl.reset(xr, ur), x0, xr, ur, f),
                                               B=B, single_sps=1.0, iters=1, mesh=mesh)
    assert skip is None
    assert set(row) == {"n_devices", "B_global", "solves_per_s", "solves_per_s_per_device",
                        "scaling_efficiency_vs_single", "ok"}
    assert row["n_devices"] == 1 and row["B_global"] == B and row["ok"] == B
    assert row["solves_per_s"] > 0 and row["solves_per_s"] == row["solves_per_s_per_device"]
    assert batch_step.gather(mesh, x0) is x0


def test_sharded_axis_without_a_mesh_raises():
    """A sharded episode never runs unsharded in silence: an axis name that
    no mesh has, or a shard count without a name, raises ValueError; so
    does a shard count the mesh's axis does not have."""
    kw = dict(n_drones=2, device="cpu")
    with pytest.raises(ValueError, match="'swarm'"):
        make_episode(NdpNmpcConfig(), build_eight(), swarm_axis_name="swarm", **kw)
    with pytest.raises(ValueError, match="swarm_axis_name"):
        make_episode(NdpNmpcConfig(), build_eight(), swarm_shards=2, **kw)
    make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="has 1 ranks"):
        make_episode(NdpNmpcConfig(), build_eight(), swarm_axis_name="swarm", swarm_shards=2,
                     **kw)
    kernel = make_batched_rti_controller(CFG.ocp, CFG.vehicle, packed_state=True,
                                         whole_step=True, device="cpu")
    with pytest.raises(ValueError, match="batch-first"):
        make_sharded_swarm_step(CFG, kernel, make_mesh(1, 1, device="cpu"))


def test_swarm_step_matches_jax_on_one_device():
    """The port's world-1 swarm step against JAX's shard_map on a one-device
    mesh: the same inputs (a numpy seed), the MLP's pair forces from the
    same weights (through `convert`), the scan controller at qp_iters 12."""
    S, D = 4, 4
    pos = np.random.default_rng(0).uniform(-1.0, 1.0, (S, D, 3))
    offsets = np.zeros((S, D, 3))
    offsets[..., 2] = 0.7 * np.arange(D)

    jcfg = JaxConfig()
    jctl = j_rti(jcfg.ocp, jcfg.vehicle, with_disturbance=True)
    xr_lead = jnp.tile(j_hover_state(jnp.zeros((S, 3), jnp.float64))[:, None, :], (1, N + 1, 1))
    ur_lead = jnp.tile(j_hover_input(jcfg.vehicle, (S,), jnp.float64)[:, None, :], (1, N, 1))
    xr = jnp.broadcast_to(xr_lead[:, None], (S, D, N + 1, 10)).at[..., 0:3].add(
        jnp.asarray(offsets)[:, :, None, :])
    ur = jnp.broadcast_to(ur_lead[:, None], (S, D, N, 4))
    params = j_load(ASSET, dtype=jnp.float64)
    jstep = j_swarm_step(jcfg, jctl, j_make_mesh(1, swarm_axis=1), downwash_params=params)
    u0_j, rti_j, n_ok_j = jstep(jax.vmap(jax.vmap(jctl.reset))(xr, ur),
                                j_hover_state(jnp.asarray(pos)), xr_lead, ur_lead,
                                jnp.asarray(offsets))

    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, with_disturbance=True,
                                      backend="jax", device="cpu")
    t = lambda a: torch.as_tensor(np.array(a))
    rti0 = tree_map(lambda a: a.reshape((S, D) + a.shape[1:]),
                    ctl.reset(t(xr).reshape(S * D, N + 1, 10), t(ur).reshape(S * D, N, 4)))
    mlp = convert.mlp_from_numpy([np.asarray(w) for w in params.weights],
                                 [np.asarray(b) for b in params.biases], dtype=F64, device="cpu")
    step = make_sharded_swarm_step(CFG, ctl, make_mesh(1, 1, device="cpu"), downwash_params=mlp)
    u0, new, n_ok = step(rti0, hover_state(t(pos)), t(xr_lead), t(ur_lead), t(offsets))

    np.testing.assert_allclose(u0.numpy(), np.asarray(u0_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(new.x_bar.numpy(), np.asarray(rti_j.x_bar), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(n_ok.numpy(), np.asarray(n_ok_j))
    assert int(n_ok.sum()) > 0
