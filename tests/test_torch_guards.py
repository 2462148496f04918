"""Guards of the PyTorch port: no JAX inside it, no silent CPU fallback, and
the CPU route of the kernel wrapper never counts a launch."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu_torch.ops.kernels import step_whole
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver import rti
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import whole_step_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm

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
