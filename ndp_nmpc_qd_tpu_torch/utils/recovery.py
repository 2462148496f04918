"""Failure detection and in-batch recovery.

Port of `ndp_nmpc_qd_tpu/utils/recovery.py`. The reference recovers by
crash and restart: acados status != 0 raises (`nmpc_body_rate_ctl.py:109-110`)
and the launch file respawns the node, which re-seeds the controller from a
hold-point reference. In a batch one scenario's failure must not stop the
others, so recovery is data: `recover_rti` rebuilds the iterates of every
unhealthy scenario from its reference (the `reset()` semantics) and drops its
QP warm start, leaving healthy scenarios untouched; `screen_nan` adds
finiteness screens to the health flag.

Two layouts: batch-first state (B, ...) (`screen_nan`, `recover_rti`) and
the kernel layout (s, d, B) with the scenario axis last
(`screen_nan_packed`, `recover_rti_packed`). The port does not pad B, so the
kernel-layout forms take the (B,) flags as they are (the JAX package's
`pack_ok` lane padding has no counterpart).
"""

from __future__ import annotations

import torch

from ..solver.rti import RtiState


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def screen_nan(tree, ok: torch.Tensor) -> torch.Tensor:
    """AND each scenario's finiteness of every leaf into ok (B,); leaves
    have the scenario axis leading."""
    for x in _leaves(tree):
        ok = ok & torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    return ok


def screen_nan_packed(tree, ok: torch.Tensor) -> torch.Tensor:
    """`screen_nan` for kernel-layout leaves, the scenario axis last."""
    for x in _leaves(tree):
        ok = ok & torch.isfinite(x).reshape(-1, x.shape[-1]).all(dim=0)
    return ok


def _reseed(state: RtiState, keep, ok, xr, ur) -> RtiState:
    """Where keep (ok broadcast against the iterates) is False: the
    reference for the iterates, zero multipliers and the cold sentinel
    mu = -1 (the scenario drops its QP warm start)."""
    ipm = state.ipm
    if ipm is not None:
        *duals, mu = ipm
        zero = torch.zeros((), dtype=mu.dtype, device=mu.device)
        ipm = tuple(torch.where(keep, t, zero) for t in duals) + (
            torch.where(ok, mu, -torch.ones_like(mu)),)
    return RtiState(torch.where(keep, state.x_bar, xr), torch.where(keep, state.u_bar, ur), ipm)


def recover_rti(state: RtiState, ok: torch.Tensor, xr: torch.Tensor, ur: torch.Tensor) -> RtiState:
    """Re-seed the unhealthy scenarios' iterates from the reference:
    batch-first state, ok (B,), xr (B, N+1, 10), ur (B, N, 4)."""
    return _reseed(state, ok[:, None, None], ok, xr, ur)


def recover_rti_packed(state: RtiState, ok: torch.Tensor, xr_p: torch.Tensor,
                       ur_p: torch.Tensor) -> RtiState:
    """`recover_rti` for the kernel-layout state: ok (B,) broadcasts over
    the trailing scenario axis; xr_p (N+1, 10, B), ur_p (N, 4, B) are the
    reset targets already in kernel layout."""
    return _reseed(state, ok, ok, xr_p, ur_p)
