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
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import (
    SparseQp, ipm_consts, lin_consts, sparse_consts, whole_step_consts,
)
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm, ipm_sparse


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
    files.append(ROOT / "chip_smoke.py")
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


@pytest.mark.parametrize("bad", [dict(lqr_start=True), dict(lqr_start=False, fuse_glue=False)])
def test_unported_ipm_options_raise(bad):
    """The per-iteration IPM's clipped-LQR start and unfused glue need
    `riccati_sweep_sparse` (K6+K7), not ported yet."""
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 2
    lc = lin_consts(cfg.ocp, cfg.vehicle, True)
    *fields, dx0 = linearize.linearize_stage_data(*testing.kernel_inputs(B, N, "cpu", 0), **lc)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 K6"):
        ipm_sparse(SparseQp(*fields), sparse_consts(cfg.ocp), dx0, num_iters=1, **bad)
