"""Carry weights, controller state, trajectories and episode state over
from the JAX package.

Every function takes numpy arrays (or objects whose fields are numpy
arrays, named as the JAX package names them), so the port itself never
imports JAX: the caller hands over `np.asarray` of the JAX objects.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.downwash_mlp import from_numpy
from .estimators.filters import DifferentiatorState
from .estimators.hover_throttle import HoverThrottleState
from .sim.closed_loop import EpisodeState
from .sim.plant import PlantState
from .solver.ocp import QpData
from .solver.ocp_packed import PackedQp
from .solver.rti import RtiState
from .traj.polyopt import PiecewisePoly


# The JAX `MlpParams` (weights (out, in), biases (out,), as numpy) as a
# `DownwashMlp`: the layouts agree, so nothing transposes.
mlp_from_numpy = from_numpy


def _tensor(a, dev):
    return torch.tensor(np.ascontiguousarray(np.asarray(a)), device=dev)


def _lanes(a, B: int, dev):
    """A kernel-layout array (s, d, nb, SUB, 128) as (s, d, B), lane padding
    dropped."""
    a = np.asarray(a)
    return _tensor(a.reshape(a.shape[0], a.shape[1], -1)[..., :B], dev)


def rti_state_from_numpy(x_bar, u_bar, ipm, B: int, *, device=None) -> RtiState:
    """A JAX kernel-layout `RtiState` ((s, d, nb, SUB, 128) arrays, mu
    (nb, SUB, 128)) as the port's (s, d, B) state, lane padding dropped."""
    dev = resolve_device(device)
    lanes = lambda a: _lanes(a, B, dev)
    ipm_t = None
    if ipm is not None:
        *duals, mu = ipm
        mu = np.ascontiguousarray(np.asarray(mu).reshape(-1)[:B])
        ipm_t = tuple(lanes(d) for d in duals) + (torch.tensor(mu, device=dev),)
    return RtiState(lanes(x_bar), lanes(u_bar), ipm_t)


def rti_batch_state_from_numpy(x_bar, u_bar, ipm, *, device=None) -> RtiState:
    """A JAX batch-first `RtiState` (`packed_state=False`: x_bar (B, N+1,
    10), u_bar (B, N, 4), ipm (B, N, 4) x 2, (B, N+1, 3) x 2, mu (B,)) as
    the port's batch-first state."""
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.ascontiguousarray(np.asarray(a)), device=dev)
    return RtiState(t(x_bar), t(u_bar), None if ipm is None else tuple(t(a) for a in ipm))


def qp_from_numpy(qp, *, device=None) -> QpData:
    """A JAX `QpData` (numpy fields, batch-first or one scenario) as the
    port's, in the same dtype."""
    dev = resolve_device(device)
    return QpData(*(_tensor(getattr(qp, f), dev) for f in QpData._fields))


def packed_qp_from_numpy(p, B: int, *, device=None) -> PackedQp:
    """A JAX `PackedQp` ((s, d, nb, SUB, 128) numpy fields) as the port's
    (s, d, B), lane padding dropped."""
    dev = resolve_device(device)
    return PackedQp(*(_lanes(getattr(p, f), B, dev) for f in PackedQp._fields))


def traj_from_numpy(traj, *, device=None) -> PiecewisePoly:
    """A JAX `PiecewisePoly` (numpy fields, any dtype; stacked or not) as
    the port's, in the same dtype."""
    dev = resolve_device(device)
    return PiecewisePoly(*(_tensor(getattr(traj, f), dev) for f in PiecewisePoly._fields))


def episode_state_from_numpy(st, *, kernel_layout: bool = False, device=None) -> EpisodeState:
    """A JAX `EpisodeState` as the port's: the plant, the controller state
    (kernel layout, lane padding dropped, with `kernel_layout=True`; else
    batch-first), the estimator, the filtered offsets, the previous and
    hold horizons, the tick and tracking count (host ints) and the
    accumulators."""
    dev = resolve_device(device)
    t = lambda a: _tensor(a, dev)
    D = np.asarray(st.plant.x).shape[0]
    rti = st.rti
    if kernel_layout:
        rti = rti_state_from_numpy(rti.x_bar, rti.u_bar, rti.ipm, D, device=dev)
    else:
        rti = rti_batch_state_from_numpy(rti.x_bar, rti.u_bar, rti.ipm, device=dev)
    return EpisodeState(
        plant=PlantState(t(st.plant.x), t(st.plant.w_act), t(st.plant.c_act)),
        rti=rti,
        est=HoverThrottleState(t(st.est.x), t(st.est.P),
                               DifferentiatorState(t(st.est.diff.x_prev),
                                                   t(st.est.diff.xdot_prev))),
        lpf_offset=t(st.lpf_offset),
        prev_ref_x=t(st.prev_ref_x), prev_ref_u=t(st.prev_ref_u),
        hold_xr=t(st.hold_xr), hold_ur=t(st.hold_ur),
        tick=int(np.asarray(st.tick)), n_track=int(np.asarray(st.n_track)),
        pos_err2=t(st.pos_err2), yaw_err2=t(st.yaw_err2), form_err2=t(st.form_err2),
        ok_all=t(st.ok_all), recovered=t(np.asarray(st.recovered, np.int64)),
    )
