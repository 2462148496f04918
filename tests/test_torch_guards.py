"""Guards of the PyTorch port: no JAX inside it, no silent CPU fallback, and
the CPU route of each kernel wrapper never counts a launch."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels import ipm_whole, linearize, riccati_sparse, step_whole
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver import rti
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, lin_consts, whole_step_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the port's tools that import no JAX (`validate_port_mission.py` holds the
# port against the JAX package and imports it on purpose)
PORT_TOOLS = ("profile_torch_step.py", "time_sweep_kernels.py", "time_team_kernels.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "ndp_nmpc_qd_tpu_torch").rglob("*.py"))
    parallel = {"distributed.py", "mesh.py", "episode.py", "batch_step.py", "launch.py"}
    assert parallel <= {f.name for f in files if f.parent.name == "parallel"}, files
    assert {ROOT / "ndp_nmpc_qd_tpu_torch" / name for name in ("entry.py", "deployed.py")} <= set(
        files)
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    tools = sorted((ROOT / "tools").glob("*_torch.py"))
    assert {"profile_step_torch.py", "profile_trace_torch.py", "multicard_torch.py"} <= {
        t.name for t in tools}, tools
    assert len(tools) >= 12, tools
    files += tools + [ROOT / "tools" / name for name in PORT_TOOLS]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ndp_nmpc_qd_tpu"), (path, mod)


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NdpNmpcConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rti.make_batched_rti_controller(
            cfg.ocp, cfg.vehicle, packed_state=True, whole_step=True
        )


TOOL_ARGV = {
    "train_downwash_torch": ["--epochs", "1", "--n-train", "8"],
    "qp_envelope_torch": ["--max-d", "2"],
    "validate_backends_torch": ["--ticks", "1"],
    "bench_points_torch": ["8"],
    "bench_ipm_whole_torch": ["8", "1"],
    "plot_traj_torch": ["--track-secs", "0.02"],
    "viz3d_torch": ["--track-secs", "0.02"],
    "nn_field_viz_torch": ["--dzs", "0.8"],
    "live_plot_torch": ["--secs", "0.01"],
    "profile_step_torch": ["8"],
    "profile_trace_torch": ["8", "--skip-interactive"],
    "multicard_torch": ["--worlds", "1"],
}


@pytest.mark.parametrize("entry", ["thrust_controller", "thrust_episode", "tensor_lin",
                                   "init_mlp", "load_torch_checkpoint", "initialize",
                                   "make_sharded_step", "make_sharded_episode", "spawn",
                                   "launch_main", "entry", "dryrun_multichip", "multichip_rank",
                                   "sharded_row_rank", *TOOL_ARGV])
def test_new_entry_points_without_a_card_raise(monkeypatch, tmp_path, entry):
    """The motor-thrust controller and its episode, the tensor-op
    linearizer's controller, the MLP trainer's entry points, the parallel
    package's (joining a process group, the sharded batch step and the
    sharded episode, each on a new default mesh, none being kept), the
    launcher (`spawn`, the module entry), `entry.py`'s `entry`,
    `dryrun_multichip` and `multichip_rank`, the deployed step's sharded
    row on one rank (`deployed.sharded_row_rank`) and the port's tools (the profilers and the
    multi-card tool too) run on the card by default: without one, and
    without an explicit device or `--cpu`, they raise (`initialize` before
    it joins any group, the launcher before it starts any process)."""
    from ndp_nmpc_qd_tpu_torch import cli, deployed, entry as t_entry
    from ndp_nmpc_qd_tpu_torch.models import downwash_mlp
    from ndp_nmpc_qd_tpu_torch.parallel import batch_step, distributed, episode, launch
    from ndp_nmpc_qd_tpu_torch.parallel.mesh import release_meshes
    from ndp_nmpc_qd_tpu_torch.sim.thrust_loop import make_thrust_episode
    from ndp_nmpc_qd_tpu_torch.solver.ocp_thrust import make_thrust_rti_controller
    from test_torch_tools import load_tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NdpNmpcConfig()
    ckpt = tmp_path / "sd.pt"
    torch.save(downwash_mlp.init_mlp(torch.Generator(), (6, 3), device="cpu").layers[0]
               .state_dict(prefix="0."), ckpt)
    build = {
        "thrust_controller": lambda: make_thrust_rti_controller(cfg.ocp, cfg.vehicle),
        "thrust_episode": lambda: make_thrust_episode(cfg, cli.build_eight()),
        "tensor_lin": lambda: rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle,
                                                               fused_lin=False),
        "init_mlp": lambda: downwash_mlp.init_mlp(torch.Generator()),
        "load_torch_checkpoint": lambda: downwash_mlp.load_torch_checkpoint(str(ckpt)),
        "initialize": lambda: distributed.initialize(coordinator="127.0.0.1:1", num_processes=2,
                                                     process_id=0),
        "make_sharded_step": lambda: batch_step.make_sharded_step(
            lambda *a: a, None, (torch.zeros(2, 3),)),
        "make_sharded_episode": lambda: episode.make_sharded_episode(
            cfg, cli.build_eight(), None, n_drones=2, scenario_batch=1),
        "spawn": lambda: launch.spawn(print, 2),
        "launch_main": lambda: launch.main(["--nproc", "1", str(tmp_path / "never.py")]),
        "entry": lambda: t_entry.entry(),
        "dryrun_multichip": lambda: t_entry.dryrun_multichip(),
        "multichip_rank": lambda: t_entry.multichip_rank(8, 0, 1.0),
        "sharded_row_rank": lambda: deployed.sharded_row_rank(8, 0, 1.0),
    }.get(entry) or (lambda: load_tool(entry).main(TOOL_ARGV[entry]))
    release_meshes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_no_raise_cites_item_10():
    """Queue 1 items 10 (the tensor-op linearizer, the motor-thrust NMPC)
    and 11 (the parallel package) are ported: no message of the package
    cites them."""
    for path in sorted((ROOT / "ndp_nmpc_qd_tpu_torch").rglob("*.py")):
        text = path.read_text()
        assert "item 10" not in text and "item 11" not in text, path


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 3
    consts = whole_step_consts(cfg.ocp, cfg.vehicle, True, num_iters=1)
    rng = np.random.default_rng(0)
    xb = torch.zeros(N + 1, 10, B)
    xb[:, 6] = 1.0
    xr = xb.clone()
    xb[:, 0:3] += torch.as_tensor(rng.uniform(-1, 1, (1, 3, B)), dtype=torch.float32)
    ub = torch.zeros(N, 4, B)
    ub[:, 3] = 9.81
    ur, x0 = ub.clone(), xb[:1].clone()
    fd = torch.as_tensor(0.1 * rng.standard_normal((N + 1, 3, B)), dtype=torch.float32)
    warm = cold_warm(N, B, torch.float32, "cpu")
    want = step_whole.control_step_whole_plain(xb, ub, xr, ur, fd, x0, *warm, **consts)

    before = step_whole.control_step_whole.launches
    eq = step_whole.control_step_whole(xb, ub, xr, ur, fd, x0, *warm, **consts)
    assert step_whole.control_step_whole.launches == before
    for got, ref in zip((xb, ub, *warm, eq), (*want[:7], want[7])):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_team_kernels_take_no_workspace():
    """K1 and K2 keep each scenario's working set in shared memory: no
    wrapper or caller takes or makes a global workspace."""
    import inspect

    from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import make_whole_step
    from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import ipm_sparse

    cfg = NdpNmpcConfig()
    step = make_whole_step(cfg.ocp, cfg.vehicle, True, jac_bf16=True, num_iters=3)
    for fn in (step_whole.control_step_whole, ipm_whole.riccati_ipm_whole, step, ipm_sparse):
        assert "workspace" not in inspect.signature(fn).parameters, fn
    assert not hasattr(step_whole, "make_workspace") and not hasattr(ipm_whole, "make_workspace")


def test_two_kernel_wrappers_take_the_plain_versions_on_cpu_tensors():
    """K3, K2 (with and without the fold, duals and iterates updated in
    place as on the card) and K4/K5 return exactly their plain versions'
    results for CPU tensors and count no launch."""
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 3
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=True)
    ic = ipm_consts(cfg.ocp, num_iters=1)
    ins = testing.kernel_inputs(B, N, "cpu", seed=0)
    wrappers = (linearize.linearize_stage_data, ipm_whole.riccati_ipm_whole,
                riccati_sparse.riccati_backward_glue, riccati_sparse.riccati_forward_glue)
    before = [w.launches for w in wrappers]

    qp = linearize.linearize_stage_data(*ins, **lc)
    for got, ref in zip(qp, linearize.linearize_stage_data_plain(*ins, **lc)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for xu in (None, ins[:2]):
        warm = cold_warm(N, B, torch.float32, "cpu")
        want = ipm_whole.riccati_ipm_whole_plain(*qp[:11], *warm, qp[11], *(xu or (None, None)),
                                                 **ic)
        xs = [t.clone() for t in xu] if xu else [None, None]
        got = ipm_whole.riccati_ipm_whole(*qp[:11], *warm, qp[11], *xs, **ic)
        assert all(g is w for g, w in zip(got[2:7], warm))  # the duals, in place
        if xu:
            assert got[0] is xs[0] and got[1] is xs[1]  # the iterates, in place
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    args = testing.iter_args(qp, ic)
    got = riccati_sparse.riccati_iter_fused(*args, **{k: ic[k] for k in (
        "h", "diag6_stage", "diag6_term", "rdiag_stage", "tau")})
    want = riccati_sparse.riccati_iter_fused_plain(*args, **{k: ic[k] for k in (
        "h", "diag6_stage", "diag6_term", "rdiag_stage", "tau")})
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before


def test_cuda_wrappers_refuse_other_devices():
    """A wrapper given neither CPU nor CUDA tensors raises; it never falls
    back to its plain version."""
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 2
    ins = [t.to("meta") for t in testing.kernel_inputs(B, N, "cpu", seed=0)]
    with pytest.raises(ValueError, match="unsupported device"):
        linearize.linearize_stage_data(*ins, **lin_consts(cfg.ocp, cfg.vehicle, True))


def test_sweep_wrappers_take_the_plain_versions_on_cpu_tensors():
    """K6 and K7 return exactly their plain versions' results for CPU
    tensors, in both call shapes, count no launch, and refuse other
    devices."""
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 3
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=True)
    ic = ipm_consts(cfg.ocp, num_iters=1)
    qp = linearize.linearize_stage_data(*testing.kernel_inputs(B, N, "cpu", seed=0), **lc)
    kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    wrappers = (riccati_sparse.riccati_sweep_backward, riccati_sparse.riccati_sweep_forward)
    before = [w.launches for w in wrappers]
    for call in ("lqr_start", "unfused_glue"):
        args, hold = testing.sweep_args(qp, ic, call)
        got = riccati_sparse.riccati_sweep_sparse(*args, **kw, with_hold=hold)
        K, kf, rhat = riccati_sparse.riccati_sweep_backward_plain(*args[:13], **kw)
        want = riccati_sparse.riccati_sweep_forward_plain(
            *args[3:6], rhat, K, kf, *args[13:], h=ic["h"], with_hold=hold)
        assert len(got) == 4 if hold else 3
        for g, r in zip(got, (want[0], want[1], rhat) + want[2:]):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="unsupported device"):
        riccati_sparse.riccati_sweep_backward(*(t.to("meta") for t in args[:13]), **kw)


@pytest.mark.parametrize("bad, match", [(dict(swarm_axis_name="x"), "'x'"),
                                        (dict(swarm_shards=2), "swarm_axis_name")])
def test_unported_ipm_options_raise(bad, match):
    """The sharded episode, which raised here until it was ported (Queue 1
    item 11, `test_torch_parallel_gloo.py` runs it over two ranks), never
    runs unsharded in silence: without a mesh, a mesh axis name raises
    ValueError naming the axis, and a shard count without an axis name
    raises too. The per-iteration IPM's clipped-LQR start and unfused glue
    and the scan controller (`solver_backend="jax"`), which raised here
    before they were ported, run now (`test_torch_riccati_sweep.py`,
    `test_torch_scan_controller.py`)."""
    from ndp_nmpc_qd_tpu_torch.cli import build_eight
    from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode

    with pytest.raises(ValueError, match=match):
        make_episode(NdpNmpcConfig(), build_eight(), n_drones=2, device="cpu", **bad)


def test_packed_wrappers_take_the_plain_versions_on_cpu_tensors():
    """K8 and K9 return exactly their plain versions' results for CPU
    tensors, in both call shapes, count no launch, and refuse other
    devices."""
    from ndp_nmpc_qd_tpu_torch.ops.kernels import riccati

    p, dx0 = testing.dense_payload(NdpNmpcConfig(), 3, "cpu", seed=0)
    wrappers = (riccati.riccati_backward_packed, riccati.riccati_forward_packed)
    before = [w.launches for w in wrappers]
    for call in ("lqr_start", "newton"):
        args = testing.packed_args(p, dx0, call)
        K, kf = riccati.riccati_backward_packed_plain(*args[:9])
        want = riccati.riccati_forward_packed_plain(*args[6:9], K, kf, *args[9:])
        got = riccati.riccati_sweep_packed(*args[:10], clip_lo=args[10], clip_hi=args[11])
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
        for g, r in zip(riccati.riccati_backward_packed(*args[:9]), (K, kf)):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before
    meta = [t.to("meta") for t in args[:10]]
    with pytest.raises(ValueError, match="unsupported device"):
        riccati.riccati_backward_packed(*meta[:9])
    with pytest.raises(ValueError, match="unsupported device"):
        riccati.riccati_forward_packed(*meta[6:9], K.to("meta"), kf.to("meta"), meta[9])


@pytest.mark.parametrize("argv, error, match", [
    (["serve", "--max-ticks", "1"], RuntimeError, "no CUDA device"),
    (["mission", "one_qd", "--controller", "thrust"], RuntimeError, "no CUDA device"),
])
def test_unported_cli_commands_raise(argv, error, match, monkeypatch):
    """The commands ported since they raised here run on the card or with
    --cpu: without a card `serve` and the thrust mission (ROADMAP Queue 1
    item 10, which raised until it was ported; `test_torch_thrust_episode.py`
    flies it with --cpu) fail instead of running on the CPU."""
    from ndp_nmpc_qd_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        main(argv)


def test_mission_cli_without_a_card_fails(monkeypatch):
    """Without a card and without --cpu the mission command fails; --f64
    without --cpu raises (the kernels are f32)."""
    from ndp_nmpc_qd_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["one_qd", "--track-secs", "0.02", "--hold-ticks", "0"])
    with pytest.raises(NotImplementedError, match="--f64"):
        main(["one_qd", "--f64"])
