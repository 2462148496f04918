"""PyTorch port vs JAX: the fused whole-step controller over 3 chained ticks.

The JAX side is `make_batched_rti_controller(..., packed_state=True,
whole_step=True)`, which reaches the `control_step_whole` Pallas kernel in
interpret mode, read from the recording `tools/record_jax_refs.py` makes of
it (`jax_refs.py`); the port runs its plain version on the CPU. Same numpy
inputs (the case of `test_packed_state.py`), each side fed its own package's
f32 downwash forecast, which are compared live. Tolerances are the JAX
package's own for this kernel (`test_packed_state.py:62-78`): u0 atol
1e-5; eq_res rtol 1e-4 / atol 1e-6; iterates atol 2e-5; duals rtol 1e-4 /
atol 1e-5; `ok` identical. The
duals and mu are also held at rtol 1e-4 with atol 1e-4 max|ref|, since on
warm ticks they are far below the fixed atol.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu.models import downwash_mlp as j_mlp
from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.models import downwash_mlp as t_mlp
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti

ASSET = os.path.join(
    os.path.dirname(__file__), "..", "assets", "downwash_analytic_sn4.npz"
)
TICKS = 3
# the JAX controller's kernel-layout state as it returns it
STATE = ("state_x_bar", "state_u_bar") + tuple(f"state_ipm{k}" for k in range(5))
TICK_OUT = ("u0", "eq_res", "ok", "mu", "x_bar", "u_bar") + STATE
REF_KEYS = (keys(("whole_step",), (), ("x0", "xr", "ur", "f", "qp_iters"))
            + keys([f"whole_step/tick{t}" for t in range(TICKS)], TICK_OUT))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version runs ~330k ops on (8,) tensors a tick; intra-op
    threads only add overhead there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(B, N, seed=3):
    """x0 hovering at random offsets, hover references at the origin, the
    other drone's horizon 0.9 m above the reference (numpy, f32)."""
    rng = np.random.default_rng(seed)
    hover = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
    x0 = np.tile(hover, (B, 1))
    x0[:, 0:3] = rng.uniform(-2.0, 2.0, (B, 3))
    xr = np.tile(hover, (B, N + 1, 1))
    ur = np.tile(np.array([0, 0, 0, 9.81], np.float32), (B, N, 1))
    other = xr.copy()
    other[:, :, 2] += 0.9
    return x0, xr, ur, other


def jax_forecast(x0, xr, other):
    """The JAX package's f32 downwash forecast of the case (numpy)."""
    return np.array(j_mlp.predict_downwash(
        j_mlp.load_npz(ASSET), jnp.asarray(other), jnp.asarray(xr),
        r_horiz=NdpNmpcConfig().downwash.r_horiz, ego_gate_pos=jnp.asarray(x0)[:, 0:3],
    ))


def jax_state(ref, B):
    """The recorded JAX state (`STATE`; ref reads a recorded array) as the
    port's, carried over with `convert.rti_state_from_numpy`."""
    x_bar, u_bar, *ipm = (ref(name) for name in STATE)
    return convert.rti_state_from_numpy(x_bar, u_bar, ipm, B, device="cpu")


def port_controller(qp_iters, jac_bf16):
    cfg = PortConfig()
    return t_rti.make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=qp_iters,
        warm_start=True, lqr_start=False, whole_ipm=True, packed_state=True,
        whole_step=True, jac_bf16=jac_bf16, device="cpu",
    )


def test_whole_step_controller_matches_jax():
    cfg = NdpNmpcConfig()
    N, B = cfg.ocp.N_node, 8
    x0, xr, ur, other = make_case(B, N)
    r_h = cfg.downwash.r_horiz

    params = j_mlp.load_npz(ASSET)
    f_j = jax_forecast(x0, xr, other)
    mlp = convert.mlp_from_numpy(
        [np.asarray(w) for w in params.weights],
        [np.asarray(b) for b in params.biases], device="cpu",
    )
    with torch.no_grad():
        f_t = t_mlp.predict_downwash(
            mlp, torch.as_tensor(other), torch.as_tensor(xr), r_horiz=r_h,
            ego_gate_pos=torch.as_tensor(x0)[:, 0:3],
        )
    assert float(np.abs(f_j).max()) > 0.1  # the gate is active
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-5, atol=1e-6)

    rec = Recording("test_torch_step_whole")
    rec.check_inputs("whole_step", x0=x0, xr=xr, ur=ur, f=f_j, qp_iters=3)
    ctl_t = port_controller(3, jac_bf16=False)
    st_t = ctl_t.reset(torch.as_tensor(xr), torch.as_tensor(ur))
    for tick in range(TICKS):
        ref = lambda name, t=tick: rec(f"whole_step/tick{t}", name)
        u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f_t)
        msg = f"tick {tick}"
        np.testing.assert_allclose(u_t.numpy(), ref("u0"), atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(
            info_t.eq_res.numpy(), ref("eq_res"), rtol=1e-4, atol=1e-6, err_msg=msg,
        )
        np.testing.assert_array_equal(info_t.ok.numpy(), ref("ok"))
        xb_t, ub_t = t_rti.unpack_iterates(st_t, B)
        np.testing.assert_allclose(xb_t.numpy(), ref("x_bar"), atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(ub_t.numpy(), ref("u_bar"), atol=2e-5, err_msg=msg)
        for got, want in zip(st_t.ipm, jax_state(ref, B).ipm):
            want = want.numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=msg)
            # the warm-tick duals sit near mu (~1e-8), under that atol: hold
            # them at their own scale as well
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4, atol=1e-4 * scale, err_msg=msg
            )
        np.testing.assert_allclose(info_t.mu.numpy(), ref("mu"), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", [
    dict(cli=["mission", "three_qd", "--cpu", "--controller", "thrust"]), dict(fused_lin=False),
    dict(cli=["simnode"], no_card=True), dict(cli=["send"], no_card=True),
])
def test_unported_combinations_raise(bad, monkeypatch):
    """Combinations the JAX package refuses raise ValueError, as its asserts
    do (`cli.py:139-141`, `rti.py:296-298`): the thrust controller on
    another topology than one_qd, and the tensor-op linearizer
    (`fused_lin=False`) with the kernel-layout state. Both options are
    ported (`test_torch_thrust*.py`, `test_torch_sparse_lin.py`); they
    raised NotImplementedError here until then. The runtime daemons
    `simnode` and `send` are ported: they run on the card or with --cpu,
    and without a card they fail instead of running on the CPU. (The
    per-iteration path's clipped-LQR start and the scan and legacy dense
    backends, once cases here, run now.)"""
    if "cli" in bad:
        from ndp_nmpc_qd_tpu_torch.cli import main

        if bad.get("no_card"):
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(bad["cli"])
            return
        with pytest.raises(ValueError, match="one_qd topology"):
            main(bad["cli"])
        return
    cfg = PortConfig()
    kw = dict(packed_state=True, whole_step=True, device="cpu")
    kw.update(bad)
    with pytest.raises(ValueError, match="packed_state requires the fused linearizer"):
        t_rti.make_batched_rti_controller(cfg.ocp, cfg.vehicle, **kw)
