"""Batch-first <-> kernel layout.

The JAX package stores kernel tensors as (stage, element, nb, SUB, 128)
(`ndp_nmpc_qd_tpu/ops/pallas/riccati.py:57-79`). That is the same memory
order as (stage, element, B) with the batch innermost, which is the port's
kernel layout: neighbouring CUDA threads (scenarios) touch neighbouring
addresses. The TPU's SUB/LANE blocking and block padding are not carried
over; the CUDA kernel masks its ragged last block itself.
"""

from __future__ import annotations

import math

import torch


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, s, d...) -> (s, prod(d), B), a new contiguous tensor (never a view
    of x, so kernels may update it in place)."""
    B, s = x.shape[0], x.shape[1]
    d = math.prod(x.shape[2:])
    return x.reshape(B, s, d).permute(1, 2, 0).clone(memory_format=torch.contiguous_format)


def unpack(x: torch.Tensor, trailing: tuple) -> torch.Tensor:
    """Inverse of `pack`: (s, d, B) -> (B, s, *trailing)."""
    s, B = x.shape[0], x.shape[2]
    return x.permute(2, 0, 1).reshape((B, s) + tuple(trailing))
