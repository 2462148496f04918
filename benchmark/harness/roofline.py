"""The roofline's count: the work of the problem as the configuration
states it, not of whichever kernels implement it, so that a later change of
path does not move the yardstick.

- Bytes: each input of the control step read once and each output written
  once, at the configuration's sizes and precision.
- Operations: counted while the benchmark's frozen plain reference of the
  step runs on a 64-lane slice, scaled to B (one per element of an
  elementwise result, two per multiply-add of a matrix product).
- Peaks: one H100 SXM from NVIDIA's data sheet (dense): 989 TFLOP/s bf16,
  67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM, at 700 W.
"""

from __future__ import annotations

import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
LANES = 64


class OpCount(TorchDispatchMode):
    """Counts the arithmetic a plain version does."""

    ARITH = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "reciprocal", "abs",
        "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    }
    MATMUL = {"bmm", "mm"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.ARITH:
            self.ops += out.numel()
        elif name in self.MATMUL:
            self.ops += 2 * out.numel() * args[0].shape[-1]
        return out


_COUNTS: dict = {}


def step_counts(cfg: dict) -> dict:
    """Per scenario: the control step's f32 operations and bytes, and the
    forecast's GEMM operations (`cfg` is a configuration file). Counted once
    a process for each configuration."""
    key = json.dumps(cfg, sort_keys=True)
    if key not in _COUNTS:
        _COUNTS[key] = _count(cfg)
    return _COUNTS[key]


def _count(cfg: dict) -> dict:
    from benchmark.reference import controller, params

    p = params.from_config(cfg)
    N, ctl = p.ocp.N_node, cfg["controller"]
    consts = controller.step_consts(cfg)
    B = LANES
    xr = controller.hover_refs(torch.zeros(B, 3), p, torch.float32)
    st = controller.reset(*xr)
    x0 = controller.pack(st.x_bar.new_zeros(B, 1, 10) + xr[0][:, :1])
    fd = torch.zeros(N + 1, 3, B) if ctl["with_disturbance"] else None
    counter = OpCount()
    with counter, torch.no_grad():
        from benchmark.reference.kernels import control_step_whole_plain

        control_step_whole_plain(st.x_bar, st.u_bar, controller.pack(xr[0]),
                                 controller.pack(xr[1]), fd, x0, *st.ipm, **consts)
    f32 = 4
    n_in = ((N + 1) * 10 * 2 + N * 4 * 2 + 10 + 2 * N * 4 + 2 * (N + 1) * 3 + 1
            + ((N + 1) * 3 if ctl["with_disturbance"] else 0))
    n_out = (N + 1) * 10 + N * 4 + 2 * N * 4 + 2 * (N + 1) * 3 + 1 + 1
    sizes = [p.downwash.n_in, *p.downwash.hidden, p.downwash.n_out]
    mlp_flops = 2 * (N + 1) * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return dict(step_ops=counter.ops / B, step_bytes=(n_in + n_out) * f32,
                forecast_flops=mlp_flops)


def bound_ms(ops: float, nbytes: float, flops_peak: float = PEAK_F32_FLOPS) -> tuple:
    """(the least time in ms, what bounds it)."""
    ops_ms, bytes_ms = ops / flops_peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
