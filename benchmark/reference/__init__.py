"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch code (the scan-free K1 step, the forecast, the mission's tick) and
the plant the scenario batch flies. It imports nothing of the port, of JAX
or of the JAX package; `correct` compares the port against it.
"""

import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype, device) -> torch.Tensor:
    """A constant tensor of host values, made once per dtype and device."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """`device`, by default the card (the CPU where there is none)."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)
