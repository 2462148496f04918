"""The downwash forecast in plain PyTorch: the net of `dnwash_nn_est/nn_net.py`
(6-128-64-128-3, ReLU) read from its `w{i}`/`b{i}` archive with numpy, and
the leader's activation gate (`ndp_nmpc_leader_node.py:60-76`). A copy of the
port's `DownwashMlp.forward` and `predict_downwash`, as plain tensor code.
"""

from __future__ import annotations

import numpy as np
import torch


def load_layers(path: str, device) -> list:
    """[(w (out, in), b (out,))] in float32 on `device`."""
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("w")])
        return [(torch.tensor(data[f"w{i}"], dtype=torch.float32, device=device),
                 torch.tensor(data[f"b{i}"], dtype=torch.float32, device=device))
                for i in range(n)]


def mlp(layers, x, compute_dtype=None, operand_dtype=None):
    """x (..., 6) -> force (..., 3). With `compute_dtype` bf16 the hidden
    layers multiply and activate in bf16 and the head sums in x's dtype
    over bf16-rounded operands. `operand_dtype` (the control: fp8) rounds
    every matmul operand through that dtype first."""
    acc = x.dtype
    rnd = (lambda t: t) if operand_dtype is None else (lambda t: t.to(operand_dtype).to(t.dtype))
    h = x if compute_dtype is None else x.to(compute_dtype)
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        if compute_dtype is None:
            h = torch.matmul(rnd(h), rnd(w).t()) + b
        elif i < n - 1:
            h = torch.matmul(rnd(h), rnd(w.to(compute_dtype)).t()) + b.to(compute_dtype)
        else:
            w_c = rnd(w.to(compute_dtype)).to(acc)
            h = torch.matmul(rnd(h).to(acc), w_c.t()) + b.to(acc)
        if i < n - 1:
            h = torch.relu(h)
    return h.to(acc)


def predict_downwash(layers, other_pred_x, ego_pred_x, *, r_horiz, ego_gate_pos,
                     compute_dtype=None, operand_dtype=None):
    """Per-horizon forces (..., N+1, 3), zero where the other horizon's first
    node is r_horiz or more away horizontally from `ego_gate_pos`."""
    rel = (other_pred_x - ego_pred_x)[..., 0:6]
    forces = mlp(layers, rel, compute_dtype, operand_dtype)
    d0 = other_pred_x[..., 0, 0:2] - ego_gate_pos[..., 0:2]
    inside = (d0 * d0).sum(dim=-1) < r_horiz**2
    return torch.where(inside[..., None, None], forces, forces.new_zeros(()))
