"""Interior-point helpers shared by the QP solvers.

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm.py`, `ipm_slack_init` only (the
scan-path `solve_qp` is ROADMAP Queue 1 item 8). The slack start is the
formula the kernels use per element (`ops/kernels/ipm_whole.slack_init_pair`:
the distance to the bound where feasible, its magnitude where violated,
floored at a range-scaled minimum); on tensors it applies elementwise.
"""

from ..ops.kernels.ipm_whole import slack_init_pair as ipm_slack_init

__all__ = ["ipm_slack_init"]
