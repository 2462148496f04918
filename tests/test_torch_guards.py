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


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "ndp_nmpc_qd_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 10
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


@pytest.mark.parametrize("entry", ["thrust_controller", "thrust_episode", "tensor_lin"])
def test_new_entry_points_without_a_card_raise(monkeypatch, entry):
    """The motor-thrust controller and its episode, and the tensor-op
    linearizer's controller run on the card by default: without one, and
    without an explicit device, they raise."""
    from ndp_nmpc_qd_tpu_torch import cli
    from ndp_nmpc_qd_tpu_torch.sim.thrust_loop import make_thrust_episode
    from ndp_nmpc_qd_tpu_torch.solver.ocp_thrust import make_thrust_rti_controller

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NdpNmpcConfig()
    build = {
        "thrust_controller": lambda: make_thrust_rti_controller(cfg.ocp, cfg.vehicle),
        "thrust_episode": lambda: make_thrust_episode(cfg, cli.build_eight()),
        "tensor_lin": lambda: rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle,
                                                               fused_lin=False),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_no_raise_cites_item_10():
    """Queue 1 item 10 (the tensor-op linearizer, the motor-thrust NMPC) is
    ported: no message of the package cites it."""
    for path in sorted((ROOT / "ndp_nmpc_qd_tpu_torch").rglob("*.py")):
        assert "item 10" not in path.read_text(), path


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


@pytest.mark.parametrize("bad", [dict(swarm_axis_name="x"), dict(swarm_shards=2)])
def test_unported_ipm_options_raise(bad):
    """The episode's options that are not ported yet raise, naming their
    ROADMAP item: the sharded episode, by its mesh axis name or its shard
    count (Queue 1 item 11). The per-iteration IPM's clipped-LQR start and
    unfused glue and the scan controller (`solver_backend="jax"`), which
    raised here before they were ported, run now
    (`test_torch_riccati_sweep.py`, `test_torch_scan_controller.py`)."""
    from ndp_nmpc_qd_tpu_torch.cli import build_eight
    from ndp_nmpc_qd_tpu_torch.sim.closed_loop import make_episode

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
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
