"""PyTorch port vs JAX: checkpoint / resume (`utils/checkpoint.py`).

`test_utils.py:84-151`'s five cases, each with its port counterpart: a
corrupt checkpoint raises (never a fallback to a stale file), a missing one
raises FileNotFoundError, a round trip restores every tensor bitwise, a
restore into another layout raises (the counterpart of the JAX tile-size
(SUB) check), and a template of another shape raises. Beside them: another
dtype raises; a controller's `RtiState` with its IPM warm tuple (the kernel
layout of `packed_state=True`) round-trips and the restored controller
continues bitwise as the original.
"""

import json
import os

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.rti import RtiState, make_batched_rti_controller
from ndp_nmpc_qd_tpu_torch.utils.checkpoint import restore_pytree, save_pytree


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zeros_like(tree):
    return {k: (tuple(torch.zeros_like(t) for t in v) if isinstance(v, tuple)
                else torch.zeros_like(v)) for k, v in tree.items()}


TREE = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": (torch.zeros(4), torch.ones((2, 2), dtype=torch.float64))}


def test_checkpoint_corrupt_raises(tmp_path):
    path = os.path.join(tmp_path, "ck")
    save_pytree(path, TREE)
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(Exception) as ei:
        restore_pytree(path, zeros_like(TREE))
    assert not isinstance(ei.value, AssertionError)


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_pytree(os.path.join(tmp_path, "nope"), {"a": torch.zeros(2)})


def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "ck")
    save_pytree(path, TREE)
    out = restore_pytree(path, zeros_like(TREE))
    assert torch.equal(out["a"], TREE["a"])
    for a, b in zip(out["b"], TREE["b"]):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_layout_mismatch_raises(tmp_path):
    """The sidecar records the layout; a restore asking for the other one
    raises, naming both."""
    tree = {"a": torch.arange(4.0)}
    path = os.path.join(tmp_path, "ck")
    save_pytree(path, tree, layout="kernel")
    with open(path + ".meta.json") as f:
        assert json.load(f)["layout"] == "kernel"
    restore_pytree(path, zeros_like(tree), layout="kernel")
    with pytest.raises(ValueError, match="'kernel' layout"):
        restore_pytree(path, zeros_like(tree), layout="batch")


@pytest.mark.parametrize("like", [{"a": torch.zeros((2, 2))},
                                  {"a": torch.zeros(4, dtype=torch.float64)},
                                  {"a": torch.zeros(4), "b": torch.zeros(1)}])
def test_checkpoint_template_mismatch_raises(tmp_path, like):
    path = os.path.join(tmp_path, "ck")
    save_pytree(path, {"a": torch.arange(4.0)})
    with pytest.raises(ValueError, match="template expects"):
        restore_pytree(path, like)


def test_controller_state_roundtrip(tmp_path):
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 5
    ctl = make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=3, warm_start=True,
        whole_ipm=True, packed_state=True, device="cpu")
    rng = np.random.default_rng(0)
    x0 = torch.zeros(B, 10)
    x0[:, 6] = 1.0
    x0[:, 0:3] = torch.as_tensor(rng.uniform(-1, 1, (B, 3)), dtype=torch.float32)
    xr = torch.zeros(B, N + 1, 10)
    xr[..., 6] = 1.0
    ur = torch.zeros(B, N, 4)
    ur[..., 3] = cfg.vehicle.gravity
    f = torch.zeros(B, N + 1, 3)
    _, st, _ = ctl.update(ctl.reset(xr, ur), x0, xr, ur, f)
    path = os.path.join(tmp_path, "rti")
    save_pytree(path, st, layout=ctl.layout)
    like = RtiState(torch.zeros_like(st.x_bar), torch.zeros_like(st.u_bar),
                    tuple(torch.zeros_like(t) for t in st.ipm))
    back = restore_pytree(path, like, layout="kernel")
    assert isinstance(back, RtiState) and len(back.ipm) == 5
    for a, b in zip((back.x_bar, back.u_bar, *back.ipm), (st.x_bar, st.u_bar, *st.ipm)):
        assert torch.equal(a, b)
    copy = RtiState(st.x_bar.clone(), st.u_bar.clone(), tuple(t.clone() for t in st.ipm))
    u_a, _, _ = ctl.update(copy, x0, xr, ur, f)
    u_b, _, _ = ctl.update(back, x0, xr, ur, f)
    assert torch.equal(u_a, u_b)
    with pytest.raises(ValueError, match="layout"):
        restore_pytree(path, like, layout="batch")
