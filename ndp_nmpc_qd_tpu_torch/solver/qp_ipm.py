"""Interior-point helpers shared by the QP solvers.

Port of the elementwise building blocks of `ndp_nmpc_qd_tpu/solver/qp_ipm.py`
(`ipm_slack_init`, `ipm_corr_terms`, `ipm_corr_from_rc`, `ipm_max_step`;
the scan-path `solve_qp` is ROADMAP Queue 1 item 8). The slack start is the
formula the kernels use per element (`ops/kernels/ipm_whole.slack_init_pair`:
the distance to the bound where feasible, its magnitude where violated,
floored at a range-scaled minimum); on tensors it applies elementwise.

`ipm_corr_terms` keeps the reference's divides: the unfused IPM
(`ipm_sparse(fuse_glue=False)`) rounds as the JAX version does, where the
kernels' `glue_pair` multiplies by one shared reciprocal per slack.
"""

from __future__ import annotations

import torch

from ..ops.kernels.ipm_whole import slack_init_pair as ipm_slack_init

__all__ = ["ipm_corr_from_rc", "ipm_corr_terms", "ipm_max_step", "ipm_slack_init"]


def ipm_corr_terms(v, lo, hi, s_lo, s_up, l_lo, l_up, mu):
    """Newton elimination of a two-sided bound's slacks and duals: returns
    (sig, corr, r_lo, r_up, rc_lo, rc_up), the diagonal Hessian addition,
    the gradient correction and the residuals the direction recovery
    needs."""
    r_lo = v - lo - s_lo
    r_up = hi - v - s_up
    rc_lo = s_lo * l_lo - mu
    rc_up = s_up * l_up - mu
    sig = l_lo / s_lo + l_up / s_up
    corr = ipm_corr_from_rc(rc_lo, rc_up, r_lo, r_up, s_lo, s_up, l_lo, l_up)
    return sig, corr, r_lo, r_up, rc_lo, rc_up


def ipm_corr_from_rc(rc_lo, rc_up, r_lo, r_up, s_lo, s_up, l_lo, l_up):
    """Gradient correction of the slack elimination for given
    complementarity residuals rc."""
    return (
        -l_lo + l_up
        + (rc_lo + l_lo * r_lo) / s_lo
        - (rc_up + l_up * r_up) / s_up
    )


def ipm_max_step(v, dv, tau, dims=None):
    """Largest a in (0, 1] with v + a dv >= (1 - tau) v, reduced over
    `dims` (None: all). NaN propagates."""
    neg = dv < 0
    ratio = torch.where(neg, -tau * v / torch.where(neg, dv, torch.full_like(dv, -1.0)),
                        torch.full_like(dv, float("inf")))
    m = torch.amin(ratio) if dims is None else torch.amin(ratio, dim=dims)
    return torch.clamp(m, max=1.0)
