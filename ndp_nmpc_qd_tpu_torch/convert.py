"""Carry weights and controller state over from the JAX package.

Both take numpy arrays, so the port itself never imports JAX: the caller
hands over `np.asarray` of the JAX objects.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.downwash_mlp import from_numpy
from .solver.rti import RtiState


# The JAX `MlpParams` (weights (out, in), biases (out,), as numpy) as a
# `DownwashMlp`: the layouts agree, so nothing transposes.
mlp_from_numpy = from_numpy


def rti_state_from_numpy(x_bar, u_bar, ipm, B: int, *, device=None) -> RtiState:
    """A JAX kernel-layout `RtiState` ((s, d, nb, SUB, 128) arrays, mu
    (nb, SUB, 128)) as the port's (s, d, B) state, lane padding dropped."""
    dev = resolve_device(device)

    def lanes(a):
        a = np.asarray(a)
        a = a.reshape(a.shape[0], a.shape[1], -1)[..., :B]
        return torch.tensor(np.ascontiguousarray(a), device=dev)

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
