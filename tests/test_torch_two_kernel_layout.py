"""The two-kernel RTI controllers in the batch-first layout and without
warm start, and the one-kernel step against the two-kernel path.

- PyTorch port vs JAX: the batch-first controller (`packed_state=False`)
  without warm start on the per-iteration path (`whole_ipm=False`), whose
  residual comes from the defect of the solution (`sparse_defect`), over 2
  ticks, at `test_packed_state.py:99-115`'s tolerances (u0 atol 1e-5,
  eq_res rtol 1e-4 / atol 1e-6, `ok` identical, iterates atol 2e-5); the
  second tick also from the JAX state, carried over with
  `convert.rti_batch_state_from_numpy`. The JAX side is the recording
  `tools/record_jax_refs.py` makes of the JAX controller with its kernels
  in interpret mode (its `update` jitted; no duals without warm start),
  checked first against this file's inputs.
- Port only: the batch-first state against the packed one, both
  `whole_ipm`, with and without warm start, atol 1e-6 on u0, eq_res, mu,
  iterates and duals (the same plain arithmetic in another layout); and
  the one-kernel step (K1) against the two-kernel path (K3 + K2) at
  `test_packed_state.py:46-78`'s tolerances (u0 atol 1e-5, eq_res rtol
  1e-4 / atol 1e-6, iterates atol 2e-5, duals and mu rtol 1e-4 / atol 1e-5).
"""

import numpy as np
import pytest

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch import convert
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti
from test_torch_step_whole import make_case, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_two_kernel import B, QP_ITERS, forecast, inputs, port_controller

COLD_TICKS = 2
REF_KEYS = (keys(("cold",), (), ("x0", "xr", "ur", "f", "qp_iters"))
            + keys([f"cold/tick{t}" for t in range(COLD_TICKS)],
                   ("u0", "eq_res", "ok", "x_bar", "u_bar")))


def test_cold_batch_first_controller_matches_jax():
    rec = Recording("test_torch_two_kernel_layout")
    ins = inputs()
    rec.check_inputs("cold", **ins, qp_iters=QP_ITERS)
    x0, xr, ur, f = (ins[k] for k in ("x0", "xr", "ur", "f"))
    ctl_t = port_controller(False, False, packed_state=False, warm_start=False)
    st_t = ctl_t.reset(xr, ur)
    for tick in range(COLD_TICKS):
        ref = lambda name, t=tick: rec(f"cold/tick{t}", name)
        u_t, st_t, info_t = ctl_t.update(st_t, x0, xr, ur, f)
        outs = [(f"tick {tick}", u_t, st_t, info_t)]
        if tick:  # and the port's tick from the JAX state, compared alone
            prev = lambda name, t=tick - 1: rec(f"cold/tick{t}", name)
            carried = convert.rti_batch_state_from_numpy(prev("x_bar"), prev("u_bar"), None,
                                                         device="cpu")
            outs.append((f"tick {tick} from the JAX state",
                         *ctl_t.update(carried, x0, xr, ur, f)))
        for msg, u_t, st_t, info_t in outs:
            np.testing.assert_allclose(u_t.numpy(), ref("u0"), atol=1e-5, err_msg=msg)
            np.testing.assert_allclose(info_t.eq_res.numpy(), ref("eq_res"),
                                       rtol=1e-4, atol=1e-6, err_msg=msg)
            np.testing.assert_array_equal(info_t.ok.numpy(), ref("ok"), err_msg=msg)
            for got, name in ((st_t.x_bar, "x_bar"), (st_t.u_bar, "u_bar")):
                np.testing.assert_allclose(got.numpy(), ref(name), atol=2e-5, err_msg=msg)


def run_port(ctl, ticks=3):
    N = PortConfig().ocp.N_node
    x0, xr, ur, _ = make_case(B, N)
    f = forecast(B, N)
    st = ctl.reset(xr, ur)
    outs = []
    for _ in range(ticks):
        u, st, info = ctl.update(st, x0, xr, ur, f)
        xb, ub = (st.x_bar, st.u_bar) if ctl.layout == "batch" else t_rti.unpack_iterates(st, B)
        ipm = st.ipm
        if ipm is not None and ctl.layout == "kernel":
            ipm = tuple(d.permute(2, 0, 1) for d in ipm[:4]) + ipm[4:]
        outs.append((u.clone(), info.eq_res.clone(), info.ok.clone(), info.mu.clone(),
                     xb.clone(), ub.clone(), () if ipm is None else tuple(t.clone() for t in ipm)))
    return outs


@pytest.mark.parametrize("warm_start", [True, False])
@pytest.mark.parametrize("whole_ipm", [True, False])
def test_batch_first_matches_packed_state(whole_ipm, warm_start):
    kw = dict(whole_ipm=whole_ipm, jac_bf16=False, warm_start=warm_start)
    batch = run_port(port_controller(packed_state=False, **kw))
    packed = run_port(port_controller(packed_state=True, **kw))
    for tick, (a, b) in enumerate(zip(batch, packed)):
        msg = f"tick {tick}"
        for got, ref in zip(a[:2] + a[3:6] + a[6], b[:2] + b[3:6] + b[6]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(a[2].numpy(), b[2].numpy(), err_msg=msg)


def test_one_kernel_step_matches_two_kernel_path():
    one = run_port(port_controller(True, False, whole_step=True))
    two = run_port(port_controller(True, False))
    for tick, (a, b) in enumerate(zip(one, two)):
        msg = f"tick {tick}"
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-4, atol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(a[2].numpy(), b[2].numpy(), err_msg=msg)
        for got, ref in zip(a[4:6], b[4:6]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, err_msg=msg)
        for got, ref in zip(a[6] + a[3:4], b[6] + b[3:4]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5, err_msg=msg)
