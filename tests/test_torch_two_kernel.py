"""PyTorch port vs JAX: the two-kernel RTI controllers (`whole_step=False`).

`make_batched_rti_controller(backend="pallas", whole_step=False,
lqr_start=False)` with `whole_ipm=True` runs the linearization (K3) and the
whole IPM (K2) each tick; with `whole_ipm=False` K3 and then one
glue-fused iteration (K4+K5) per IPM iteration. The port runs the plain
versions on the CPU; the JAX side is the recording `tools/record_jax_refs.py`
makes of the JAX controller with its Pallas kernels in interpret mode (its
`update` jitted), checked first against this file's inputs. Case:
`test_torch_step_whole.py`'s, B=8, with a forecast force of scale 0.2 from
a numpy seed, qp_iters=3, warm start, packed state, f32 Jacobians, 3
chained ticks. Tolerances are
`test_packed_state.py:99-115`'s: u0 atol 1e-5, eq_res rtol 1e-4 / atol
1e-6, `ok` identical, iterates atol 2e-5; the carried duals and mu rtol
1e-4 / atol 1e-5, and also at their own scale (atol 1e-4 max|ref|).

The bf16 Jacobians are `test_torch_two_kernel_bf16.py`; the batch-first
layout, the cold start and the one-kernel step `test_torch_two_kernel_layout.py`.
"""

import numpy as np
import pytest

from jax_refs import Recording, keys
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
from ndp_nmpc_qd_tpu_torch.solver import rti as t_rti
from test_torch_step_whole import (  # noqa: F401 (autouse fixture)
    STATE, jax_state, make_case, one_torch_thread,
)

B = 8
QP_ITERS = 3
TICKS = 3
# per tick: u0, the info, the iterates (`unpack_iterates`) and the state
TICK_OUT = ("u0", "eq_res", "ok", "mu", "x_bar", "u_bar") + STATE
CASES = ("whole_ipm=True", "whole_ipm=False")
REF_KEYS = (keys(CASES, (), ("x0", "xr", "ur", "f", "qp_iters"))
            + keys([f"{c}/tick{t}" for c in CASES for t in range(TICKS)], TICK_OUT))


def forecast(B, N, seed=5):
    return (0.2 * np.random.default_rng(seed).standard_normal((B, N + 1, 3))).astype(np.float32)


def inputs():
    """The inputs of every tick: x0, xr, ur and the forecast f (numpy)."""
    N = PortConfig().ocp.N_node
    x0, xr, ur, _ = make_case(B, N)
    return dict(x0=x0, xr=xr, ur=ur, f=forecast(B, N))


def port_controller(whole_ipm, jac_bf16, packed_state=True, warm_start=True, whole_step=False):
    cfg = PortConfig()
    return t_rti.make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=QP_ITERS,
        warm_start=warm_start, lqr_start=False, whole_ipm=whole_ipm,
        packed_state=packed_state, whole_step=whole_step, jac_bf16=jac_bf16, device="cpu",
    )


def run_port(stem, whole_ipm, jac_bf16):
    """Checks the inputs against the recording `stem`, then yields (message,
    port (u0, state, info), reader of the recorded JAX tick) for each of
    the chained ticks."""
    rec = Recording(stem)
    case = f"whole_ipm={whole_ipm}"
    ins = inputs()
    rec.check_inputs(case, **ins, qp_iters=QP_ITERS)
    ctl_t = port_controller(whole_ipm, jac_bf16)
    st_t = ctl_t.reset(ins["xr"], ins["ur"])
    for tick in range(TICKS):
        out_t = ctl_t.update(st_t, ins["x0"], ins["xr"], ins["ur"], ins["f"])
        st_t = out_t[1]
        yield f"{case}, tick {tick}", out_t, lambda name, t=tick: rec(f"{case}/tick{t}", name)


@pytest.mark.parametrize("whole_ipm", [True, False])
def test_two_kernel_controller_matches_jax(whole_ipm):
    for msg, (u_t, st_t, info_t), ref in run_port("test_torch_two_kernel", whole_ipm, False):
        np.testing.assert_allclose(u_t.numpy(), ref("u0"), atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(info_t.eq_res.numpy(), ref("eq_res"),
                                   rtol=1e-4, atol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(info_t.ok.numpy(), ref("ok"), err_msg=msg)
        for got, name in zip(t_rti.unpack_iterates(st_t, B), ("x_bar", "u_bar")):
            np.testing.assert_allclose(got.numpy(), ref(name), atol=2e-5, err_msg=msg)
        for got, want in zip(st_t.ipm, jax_state(ref, B).ipm):
            got, want = got.numpy(), want.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=msg)
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=msg)
        np.testing.assert_allclose(info_t.mu.numpy(), ref("mu"),
                                   rtol=1e-4, atol=1e-5, err_msg=msg)
