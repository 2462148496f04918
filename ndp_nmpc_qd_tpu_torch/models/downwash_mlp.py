"""Downwash-force MLP: 6 -> 128 -> 64 -> 128 -> 3 ReLU network.

Port of `ndp_nmpc_qd_tpu/models/downwash_mlp.py` (forward pass, gated
per-horizon forecast and the `.npz` weight format). Its matrix products are
plain `torch.matmul` calls (cuBLAS on the card), as the JAX package left
them to XLA: there is no Pallas kernel here to port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device

LAYER_SIZES = (6, 128, 64, 128, 3)


class DownwashMlp(nn.Module):
    """The reference's downwash net (`dnwash_nn_est/nn_net.py:7-18`)."""

    def __init__(self, sizes: Sequence[int] = LAYER_SIZES):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)
        )

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """x (..., 6) -> force (..., 3). ReLU between layers, linear head.

        `compute_dtype=torch.bfloat16` runs the hidden layers' products and
        activations in bf16, as `mlp_forward` does on the TPU. The head
        takes the bf16 activations and bf16-rounded weights but sums and
        emits in the input dtype, matching the f32-accumulated MXU head.
        """
        acc = x.dtype
        h = x if compute_dtype is None else x.to(compute_dtype)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            w, b = layer.weight, layer.bias
            if compute_dtype is None:
                h = torch.matmul(h, w.t()) + b
            elif i < n - 1:
                h = torch.matmul(h, w.to(compute_dtype).t()) + b.to(compute_dtype)
            else:
                w_c = w.to(compute_dtype).to(acc)
                h = torch.matmul(h.to(acc), w_c.t()) + b.to(acc)
            if i < n - 1:
                h = torch.relu(h)
        return h.to(acc)


def from_numpy(weights, biases, *, dtype=torch.float32, device=None) -> DownwashMlp:
    """Build the net from (out, in) weight and (out,) bias arrays, the JAX
    package's `MlpParams` layout (which is torch's, so nothing transposes).
    Placed on `device`, by default the card."""
    sizes = [np.shape(weights[0])[1]] + [np.shape(w)[0] for w in weights]
    mlp = DownwashMlp(sizes)
    with torch.no_grad():
        for layer, w, b in zip(mlp.layers, weights, biases):
            layer.weight.copy_(torch.as_tensor(np.array(w)))
            layer.bias.copy_(torch.as_tensor(np.array(b)))
    return mlp.to(dtype=dtype, device=resolve_device(device))


def load_npz(path: str, *, dtype=torch.float32, device=None) -> DownwashMlp:
    """Read the `w{i}`/`b{i}` archive that the JAX package's `save_npz`
    writes (e.g. `assets/downwash_analytic_sn4.npz`)."""
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("w")])
        ws = [data[f"w{i}"] for i in range(n)]
        bs = [data[f"b{i}"] for i in range(n)]
    return from_numpy(ws, bs, dtype=dtype, device=device)


def predict_downwash(
    mlp: DownwashMlp,
    other_pred_x: torch.Tensor,
    ego_pred_x: torch.Tensor,
    *,
    r_horiz: float,
    ego_gate_pos: torch.Tensor | None = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Per-horizon downwash forces with the reference's activation gate.

    other_pred_x/ego_pred_x: (..., N+1, 10) predicted horizons. The net runs
    only where the other horizon's first node is within r_horiz horizontally
    of the ego position (`ego_gate_pos`, default the ego horizon's first
    node; `ndp_nmpc_leader_node.py:66-68`); elsewhere the force is zero.
    """
    rel = (other_pred_x - ego_pred_x)[..., 0:6]
    forces = mlp(rel, compute_dtype)
    if ego_gate_pos is None:
        ego_gate_pos = ego_pred_x[..., 0, 0:2]
    else:
        ego_gate_pos = ego_gate_pos[..., 0:2]
    d0 = other_pred_x[..., 0, 0:2] - ego_gate_pos
    inside = (d0 * d0).sum(dim=-1) < r_horiz**2
    return torch.where(inside[..., None, None], forces, forces.new_zeros(()))
